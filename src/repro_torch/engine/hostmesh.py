"""Multi-host chunk streaming over a ``torch.distributed.TCPStore``.

The reference's ``repro.engine.hostmesh``: every process owns a **disjoint
shard of the chunk-id stream** and advances its local streams with the
unchanged ``chunk_step`` / ``chunk_step_batched``; at sync windows the
ranks exchange incumbents through a keyed all-gather over a key-value
store (kilobytes per window, no device collectives, so the kernels run as
in a single-process run).  The reference rides ``jax.distributed``'s
coordination service; here rank 0 hosts a ``TCPStore`` at
``REPRO_COORD`` and every rank joins it (``set``, ``wait`` and ``get``
under a deadline, ``add`` for barriers).

Shard assignment keeps the *global* stream order: with global batch ``B``
over ``R`` hosts (``b = B/R`` local streams), window ``w`` gives rank ``r``
chunk ids ``w*B + r*b .. w*B + (r+1)*b - 1``.  Per-chunk keys are
``fold_in(key, chunk_id)`` and chunk sampling is a pure function of
``(seed, chunk_id)``, so every chunk's step result is independent of which
host computes it — which is what makes the 2-process run **bitwise** the
single-process run at equal chunk budget:

* fold mode (collective sync): each rank argmin-reduces its local streams,
  then the cross-host argmin of per-point ``f_best`` (ties broken by rank,
  i.e. by global stream index — the first-index rule of the
  single-process argmin) picks the same winner the single-process
  ``reduce_state`` over all B streams would.
* counters are exchanged as **deltas** against the last globally-agreed
  value, so ``n_accepted`` / ``n_dist_evals`` aggregate exactly once
  however many exchanges a run has.

Failure semantics: every gather runs under ``sync_timeout_s``.  A rank that
misses a window (killed, hung, partitioned) surfaces on its peers as a
typed :class:`repro_torch.engine.faults.HostDead` — never a hang — carrying
the surviving rank's exact chunk accounting.  Under ``competitive`` sync
there are no mid-run exchanges at all.  Rank 0 hosts the store, so at the
end of a run it waits (up to ``sync_timeout_s``) until every peer has read
the final gather before it returns.

Checkpointing is rank-0-only; restore broadcasts ``(state, key, step)`` to
every rank at start, and the saved step is the *global* chunk frontier so
every rank resumes the same window.
"""
from __future__ import annotations

import datetime
import io
import itertools
import json
import os
import socket
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.engine import faults
from repro_torch.engine import middleware as mw
from repro_torch.engine import scheduler as sched_lib
from repro_torch.engine import sync as sync_lib

ENV_COORD = "REPRO_COORD"
ENV_NUM_HOSTS = "REPRO_NUM_HOSTS"
ENV_RANK = "REPRO_HOST_RANK"

_BOOTSTRAPPED: tuple[int, int] | None = None
_STORE = None
_RUN_SEQ = itertools.count()


def bootstrap(spec) -> tuple[int, int]:
    """Join (or create) the process group a ``TopologySpec`` names.

    Explicit ``hosts``/``coordinator``/``rank`` fields win; otherwise the
    ``REPRO_NUM_HOSTS`` / ``REPRO_COORD`` / ``REPRO_HOST_RANK`` environment
    (the :func:`launch_local` contract).  ``hosts=1`` (or nothing set) is
    the degenerate single-process group: no store is started, so a
    ``topology='host_mesh'`` config runs anywhere.  Idempotent: a second
    call with the same shape reuses the store.  Rank 0 hosts the store at
    ``host:port``; every rank waits for all ``hosts`` to join, up to
    ``max(sync_timeout_s, 60)`` seconds (processes start unevenly under
    load; a peer that never joins raises ``HostDead``).
    """
    global _BOOTSTRAPPED, _STORE
    num = spec.hosts if spec.hosts is not None else int(
        os.environ.get(ENV_NUM_HOSTS, "1"))
    rank = spec.rank if spec.rank is not None else int(
        os.environ.get(ENV_RANK, "0"))
    if num <= 1:
        return 1, 0
    if rank >= num:
        raise ValueError(f"rank {rank} out of range for {num} hosts")
    if _BOOTSTRAPPED is not None:
        if _BOOTSTRAPPED != (num, rank):
            raise ValueError(
                f"the host store is already joined as rank "
                f"{_BOOTSTRAPPED[1]}/{_BOOTSTRAPPED[0]}; cannot re-join as "
                f"{rank}/{num}")
        return _BOOTSTRAPPED
    coord = spec.coordinator or os.environ.get(ENV_COORD)
    if not coord:
        raise ValueError(
            f"host_mesh with {num} hosts needs a coordinator address "
            f"(TopologySpec.coordinator or ${ENV_COORD})")
    host, _, port = coord.rpartition(":")
    from torch.distributed import TCPStore

    timeout = datetime.timedelta(seconds=max(spec.sync_timeout_s, 60.0))
    try:
        _STORE = TCPStore(host, int(port), world_size=num,
                          is_master=rank == 0, timeout=timeout,
                          wait_for_workers=True)
    except Exception as exc:    # a peer never joined, or no master
        raise faults.HostDead(
            f"rank {rank} could not join the {num}-host store at {coord} "
            f"({type(exc).__name__}: {exc})", rank=rank,
            window="bootstrap") from exc
    _BOOTSTRAPPED = (num, rank)
    return num, rank


def _store():
    if _STORE is None:
        raise RuntimeError("no host store; bootstrap() first")
    return _STORE


def _pack(payload: dict) -> bytes:
    """dict of ndarrays -> npz bytes (the store takes bytes).  Arrays
    round-trip bit-exactly — the parity guarantee rides on this."""
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in payload.items()})
    return buf.getvalue()


def _unpack(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob)) as z:
        return {k: z[k] for k in z.files}


def _json_arr(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode("utf-8"), dtype=np.uint8)


def _arr_json(arr):
    return json.loads(np.asarray(arr, dtype=np.uint8).tobytes().decode("utf-8"))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class HostRuntime:
    """Keyed all-gathers and barriers over the host store, with timeouts
    that surface as :class:`~repro_torch.engine.faults.HostDead`."""

    def __init__(self, processes: int, rank: int, *,
                 timeout_s: float = 60.0, prefix: str = "hm", store=None):
        self.processes = processes
        self.rank = rank
        self.timeout_s = timeout_s
        self.prefix = prefix
        self._kv = None
        if processes > 1:
            self._kv = store if store is not None else _store()

    def _wait(self, keys: list, deadline: float) -> None:
        left = max(deadline - time.monotonic(), 1e-3)
        self._kv.wait(keys, datetime.timedelta(seconds=left))

    def allgather(self, tag: str, payload: dict) -> list[dict]:
        """Publish ``payload`` under ``(prefix, tag, rank)`` and collect
        every rank's, in rank order.  One shared ``timeout_s`` deadline
        covers the whole gather; a missing peer (or a lost store) raises
        ``HostDead``."""
        if self.processes == 1:
            return [payload]
        deadline = time.monotonic() + self.timeout_s
        out: list[dict] = []
        r = self.rank
        try:
            self._kv.set(f"{self.prefix}/{tag}/{self.rank}", _pack(payload))
            for r in range(self.processes):
                if r == self.rank:
                    out.append({k: np.asarray(v) for k, v in payload.items()})
                    continue
                key = f"{self.prefix}/{tag}/{r}"
                self._wait([key], deadline)
                out.append(_unpack(self._kv.get(key)))
        except Exception as exc:
            raise faults.HostDead(
                f"rank {r} missed exchange {tag!r} within "
                f"{self.timeout_s:.3g}s ({type(exc).__name__})",
                rank=self.rank) from exc
        return out

    def barrier(self, tag: str) -> None:
        """Every rank arrives (``add``), the last one opens the gate, and
        all wait for it under ``timeout_s``."""
        if self.processes == 1:
            return
        base = f"{self.prefix}/{tag}"
        try:
            if self._kv.add(f"{base}/arrived", 1) == self.processes:
                self._kv.set(f"{base}/open", b"1")
            self._wait([f"{base}/open"], time.monotonic() + self.timeout_s)
        except Exception as exc:
            raise faults.HostDead(
                f"a rank missed barrier {tag!r} within "
                f"{self.timeout_s:.3g}s ({type(exc).__name__})",
                rank=self.rank) from exc

    def leave(self) -> None:
        """The end of a run: every peer reports that it has read all it
        needs; rank 0, which hosts the store, waits for them (up to
        ``timeout_s``; a peer that died by then is no reason to fail)."""
        if self.processes == 1:
            return
        base = f"{self.prefix}/left"
        if self.rank != 0:
            try:
                if self._kv.add(base, 1) == self.processes - 1:
                    self._kv.set(f"{base}/all", b"1")
            except Exception:       # the host left first: nothing to wait
                pass
            return
        try:
            self._wait([f"{base}/all"], time.monotonic() + self.timeout_s)
        except Exception:
            pass


def health_dict(metrics) -> dict:
    """One rank's reconciliation record:
    ``done + failed + dropped + quarantined == fetched``."""
    return {
        "chunks_done": metrics.chunks_done,
        "chunks_failed": metrics.chunks_failed,
        "chunks_dropped": metrics.chunks_dropped,
        "chunks_quarantined": metrics.chunks_quarantined,
        "chunks_fetched": (metrics.chunks_done + metrics.chunks_failed
                           + metrics.chunks_dropped
                           + metrics.chunks_quarantined),
    }


class HostExchanger:
    """The stream loop's cross-host hooks (``host=`` in ``run_stream``).

    Owns the window counter, the global chunk frontier (``global_step``),
    and the counter baselines for delta aggregation.  All methods are
    collective: every live rank calls them in the same order with the same
    window index (the shard assignment guarantees this as long as no rank
    loses a whole sync window's chunks to fetch failures — a desync
    surfaces as ``HostDead`` at the next gather, never a hang).
    """

    def __init__(self, runtime: HostRuntime, cfg, *,
                 straggler_s: float = 5.0, clock=time.monotonic):
        self.rt = runtime
        self.cfg = cfg                      # the GLOBAL config (batch = B)
        self.sync = sync_lib.from_config(cfg)
        self.R = runtime.processes
        self.rank = runtime.rank
        self.B = cfg.batch
        self.b_local = self.B // self.R
        self.straggler_s = straggler_s
        self.clock = clock
        self.window = 0
        self.global_step = 0
        self._counters = (0, 0.0)           # last globally-agreed (acc, nd)

    # -- plumbing -----------------------------------------------------------

    def _gather(self, ctx, tag, payload, window):
        t0 = self.clock()
        try:
            got = self.rt.allgather(tag, payload)
        except faults.HostDead as exc:
            exc.window = window
            exc.health = health_dict(ctx.metrics)
            ctx.metrics.trace.append(("host_dead", window, str(exc)))
            raise
        waited = self.clock() - t0
        if waited > self.straggler_s:
            ctx.metrics.trace.append(
                ("host_straggler", window, round(waited, 3)))
        return got

    def _merge_counters(self, gathered):
        """Delta aggregation: every rank ships its *totals*; the new global
        value is the old agreed value plus each rank's progress since then.
        Counter values are integer-valued, so float64 summation is exact."""
        acc0, nd0 = self._counters
        acc = acc0 + sum(int(g["acc"]) - acc0 for g in gathered)
        nd = nd0 + sum(float(g["nd"]) - nd0 for g in gathered)
        self._counters = (acc, nd)
        return acc, nd

    @staticmethod
    def _payload(state, size) -> dict:
        return {
            "f": _host(state.f_best),
            "size": np.int64(size),
            "C": _host(state.centroids),
            "d": _host(state.degenerate),
            "acc": np.int64(int(state.n_accepted)),
            "nd": np.float64(float(state.n_dist_evals)),
        }

    @staticmethod
    def _winner(gathered) -> int:
        """Cross-host argmin of per-point ``f_best``; ``np.argmin``'s
        first-index rule breaks ties toward the lowest rank, which (shard
        order) is the lowest global stream index — the same winner the
        single-process argmin over all B streams picks."""
        per_point = np.asarray(
            [float(g["f"]) / max(float(g["size"]), 1.0) for g in gathered],
            dtype=np.float64)
        return int(np.argmin(per_point))

    @staticmethod
    def _winner_f(gathered, w, size) -> np.ndarray:
        """The winner's ``f_best`` on a ``size``-point chunk: the raw bits
        when the sizes already match (the uniform-s case — exact), rescaled
        per-point otherwise."""
        if int(gathered[w]["size"]) == int(size):
            return np.asarray(gathered[w]["f"], dtype=np.float32)
        per_point = float(gathered[w]["f"]) / float(gathered[w]["size"])
        return np.float32(per_point * float(size))

    @staticmethod
    def _adopt(state, g, f, acc=None, nd=None):
        """``state`` with the gathered incumbent ``g`` (and the merged
        counters, when given), on ``state``'s device."""
        dev = state.centroids.device
        state = state._replace(
            centroids=torch.from_numpy(g["C"]).to(dev),
            degenerate=torch.from_numpy(g["d"]).to(dev),
            f_best=torch.tensor(f, dtype=torch.float32, device=dev))
        return state if acc is None else HostExchanger._counted(
            state, acc, nd)

    @staticmethod
    def _counted(state, acc, nd):
        dev = state.centroids.device
        return state._replace(
            n_accepted=torch.tensor(acc, dtype=torch.int32, device=dev),
            n_dist_evals=torch.tensor(nd, dtype=torch.float32, device=dev))

    # -- stream-loop hooks --------------------------------------------------

    def sync_start(self, ctx, state, key):
        """Collective start: adopt rank 0's restored ``(state, key, step)``
        so every rank resumes the same global window (rank 0 is the only
        checkpoint writer)."""
        if self.R > 1:
            mine = self._payload(state, max(ctx.last_s, 1))
            mine["step"] = np.int64(ctx.start_step)
            mine["key"] = np.asarray(ctx.rng.key_to_array(key))
            root = self._gather(ctx, "start", mine, "start")[0]
            state = self._adopt(state, root, root["f"], int(root["acc"]),
                                float(root["nd"]))
            key = ctx.rng.key_from_array(root["key"])
            ctx.step = ctx.start_step = int(root["step"])
            ctx.last_s = max(int(root["size"]), 1)
        start = ctx.start_step
        self.window = start // self.B
        self.global_step = start
        self._counters = (int(state.n_accepted), float(state.n_dist_evals))
        ctx.state, ctx.key = state, key
        return state, key, start

    def chunk_ids(self, start: int = 0):
        """This rank's shard of the id stream, in global window order."""
        B, b, n = self.B, self.b_local, self.cfg.n_chunks
        lo = self.rank * b
        for w in range(start // B, -(-n // B)):
            for j in range(b):
                cid = w * B + lo + j
                if start <= cid < n:
                    yield cid

    def fold_boundary(self, ctx, state):
        """Per-window hook in fold mode: advance the global frontier and,
        at sync boundaries, run the cross-host argmin exchange."""
        w = self.window
        self.window += 1
        self.global_step = min(self.window * self.B, self.cfg.n_chunks)
        if self.R > 1 and not self.sync.final_only and self.sync.boundary(w):
            state = self._exchange_fold(ctx, state, w)
        return state

    def _exchange_fold(self, ctx, state, w):
        size = max(int(ctx.last_s), 1)
        gathered = self._gather(ctx, f"x{w}", self._payload(state, size), w)
        winner = self._winner(gathered)
        acc, nd = self._merge_counters(gathered)
        if winner != self.rank:
            state = self._adopt(state, gathered[winner],
                                self._winner_f(gathered, winner, size))
        state = self._counted(state, acc, nd)
        f_pp = float(gathered[winner]["f"]) / float(gathered[winner]["size"])
        ctx.metrics.trace.append(("host_sync", w, winner, f_pp))
        return state

    def persistent_boundary(self, ctx, states, sizes):
        """Per-round hook in persistent mode (after the local exchange):
        broadcast the global winner into every local stream at sync
        boundaries.  Counters stay per-stream (the final reduce sums them;
        :meth:`finalize` merges across ranks)."""
        w = self.window
        self.window += 1
        self.global_step = min(self.window * self.B, self.cfg.n_chunks)
        if self.R == 1 or self.sync.final_only or not self.sync.boundary(w):
            return states
        f = _host(states.f_best).astype(np.float64)
        lw = int(np.argmin(f / np.asarray(sizes, dtype=np.float64)))
        payload = {
            "f": _host(states.f_best[lw]),
            "size": np.int64(sizes[lw]),
            "C": _host(states.centroids[lw]),
            "d": _host(states.degenerate[lw]),
            # per-stream counters are not exchanged mid-run
            "acc": np.int64(0), "nd": np.float64(0.0),
        }
        gathered = self._gather(ctx, f"x{w}", payload, w)
        winner = self._winner(gathered)
        g = gathered[winner]
        batch = int(states.f_best.shape[0])
        dev = states.centroids.device
        f_new = np.asarray([self._winner_f(gathered, winner, s_b)
                            for s_b in sizes], dtype=np.float32)
        states = states._replace(
            centroids=torch.from_numpy(g["C"]).to(dev).expand(
                (batch,) + g["C"].shape).clone(),
            degenerate=torch.from_numpy(g["d"]).to(dev).expand(
                (batch,) + g["d"].shape).clone(),
            f_best=torch.from_numpy(f_new).to(dev),
        )
        f_pp = float(g["f"]) / max(float(g["size"]), 1.0)
        ctx.metrics.trace.append(("host_sync", w, winner, f_pp))
        return states

    def finalize(self, ctx, state):
        """The final cross-host argmin-reduce + counter merge + per-rank
        health gather.  Always runs (competitive mode's only exchange)."""
        if self.R == 1:
            ctx.metrics.host = {
                "rank": 0, "processes": 1, "winner_rank": 0,
                "per_rank": [dict(health_dict(ctx.metrics), rank=0)],
            }
            return state
        size = int(ctx.extras.get("winner_s") or max(ctx.last_s, 1))
        payload = self._payload(state, size)
        payload["health"] = _json_arr(dict(
            health_dict(ctx.metrics), rank=self.rank,
            lloyd_iters=ctx.metrics.lloyd_iters))
        gathered = self._gather(ctx, "final", payload, "final")
        winner = self._winner(gathered)
        acc, nd = self._merge_counters(gathered)
        if winner != self.rank:
            state = self._adopt(state, gathered[winner],
                                self._winner_f(gathered, winner, size))
        state = self._counted(state, acc, nd)
        f_pp = float(gathered[winner]["f"]) / max(
            float(gathered[winner]["size"]), 1.0)
        ctx.metrics.trace.append(("host_sync", "final", winner, f_pp))
        per_rank = [_arr_json(g["health"]) for g in gathered]
        # run-level totals go global (single-process-equivalent reporting);
        # the per-rank breakdown stays in the health gather
        ctx.metrics.accepted = acc
        ctx.metrics.lloyd_iters = sum(
            h.get("lloyd_iters", 0) for h in per_rank)
        ctx.metrics.host = {
            "rank": self.rank,
            "processes": self.R,
            "winner_rank": winner,
            "per_rank": per_rank,
        }
        return state


def _host_stack(cfg, cfg_local, rank: int) -> mw.MiddlewareStack:
    """The default middleware stack, made rank-aware: rank 0 is the only
    checkpoint writer, and its steps index the *global* chunk frontier."""
    stack = mw.default_stack(cfg_local)
    mws = [m for m in stack.middlewares if not isinstance(m, mw.Checkpoint)]
    if rank == 0 and cfg.ckpt_dir:
        ckpt = mw.Checkpoint(cfg.ckpt_dir, cfg.ckpt_every, cfg.batch,
                             step_from="step")
        # keep default_stack's ordering: checkpoint before the stop/guard tail
        tail = [m for m in mws
                if isinstance(m, (mw.TimeBudget, mw.InvariantGuard))]
        head = [m for m in mws if m not in tail]
        mws = head + [ckpt] + tail
    return mw.MiddlewareStack(mws)


def run_host_stream(provider, cfg, *, topology, n_features: int,
                    resume: bool = True, key=None, fault_injector=None,
                    middlewares=None, rng=rnd.TORCH, device=None):
    """One rank's share of a multi-host streaming fit.

    Validates the host-shardable composition, builds the rank-local config
    (``batch = B / hosts``) and scheduler, and runs the ordinary
    :func:`repro_torch.engine.stream.run_stream` with the exchanger's hooks
    plugged in.  Returns ``(state, metrics)`` exactly like ``run_stream``;
    ``metrics.host`` carries the per-rank health gather.  A dead peer
    propagates as :class:`~repro_torch.engine.faults.HostDead`.
    """
    from repro_torch.engine import stream as engine_stream
    from repro_torch.engine import topology as topo_lib

    R, rank = topology.processes, topology.rank
    if cfg.batch % R:
        raise ValueError(
            f"host_mesh needs hosts ({R}) to divide the global batch "
            f"({cfg.batch})")
    if cfg.n_chunks % cfg.batch:
        raise ValueError(
            f"host_mesh needs batch ({cfg.batch}) to divide n_chunks "
            f"({cfg.n_chunks}): ranks must agree on the window count")
    if cfg.vns_ladder:
        raise ValueError(
            "vns_ladder is rank-local ladder state; not supported on "
            "host_mesh")
    if cfg.time_budget_s is not None:
        raise ValueError(
            "time_budget_s stops ranks at different windows and desyncs "
            "the exchange; use the n_chunks budget on host_mesh")
    b_local = cfg.batch // R
    scheduler = None
    if cfg.scheduler == "competitive_s":
        if b_local < 2:
            raise ValueError(
                f"competitive_s on host_mesh needs batch/hosts >= 2 local "
                f"streams, got {b_local}")
        ladder = tuple(cfg.competitive_ladder) or sched_lib.default_ladder(
            cfg.k, cfg.s)
        scheduler = sched_lib.CompetitiveS(
            ladder=ladder, batch=b_local, stream_offset=rank * b_local)
    cfg_local = cfg.replace(batch=b_local) if b_local != cfg.batch else cfg

    runtime = HostRuntime(
        R, rank, timeout_s=topology.sync_timeout_s,
        prefix=f"bm{next(_RUN_SEQ)}-{cfg.seed}")
    exchanger = HostExchanger(runtime, cfg,
                              straggler_s=topology.straggler_s)
    stack = middlewares
    if stack is None:
        stack = _host_stack(cfg, cfg_local, rank)
    out = engine_stream.run_stream(
        provider, cfg_local, n_features=n_features, resume=resume,
        fault_injector=fault_injector, key=key, middlewares=stack,
        topology=topo_lib.SingleDevice(), scheduler=scheduler,
        host=exchanger, rng=rng, device=device)
    runtime.leave()
    return out


# ---------------------------------------------------------------------------
# local multi-process launcher (tests, smoke runs)
# ---------------------------------------------------------------------------


class HostProc(NamedTuple):
    rank: int
    returncode: int
    output: str


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(cmd, num_hosts: int, *, timeout_s: float = 300.0,
                 env_extra: dict | None = None) -> list[HostProc]:
    """Spawn ``num_hosts`` processes of ``cmd`` on this machine with the
    ``REPRO_COORD`` / ``REPRO_NUM_HOSTS`` / ``REPRO_HOST_RANK`` bootstrap
    environment set (the store on a fresh localhost port).

    ``cmd`` is an argv list, or a callable ``rank -> argv list``.  Output
    (stdout+stderr, merged) is captured per rank; processes still running
    after ``timeout_s`` are killed and reported with returncode -9.
    """
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for r in range(num_hosts):
        env = dict(os.environ)
        env.update(env_extra or {})
        env[ENV_COORD] = coord
        env[ENV_NUM_HOSTS] = str(num_hosts)
        env[ENV_RANK] = str(r)
        argv = cmd(r) if callable(cmd) else list(cmd)
        procs.append(subprocess.Popen(
            argv, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout_s
    results = []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out = (out or "") + "\n[launch_local] killed after timeout"
        results.append(HostProc(r, p.returncode, out or ""))
    return results


def main(argv=None):
    """``python -m repro_torch.engine.hostmesh`` — no CLI: tests and the
    smoke script drive :func:`launch_local` with their own rank
    scripts."""
    raise SystemExit(
        "repro_torch.engine.hostmesh has no CLI; use launch_local()")


if __name__ == "__main__":
    main(sys.argv[1:])
