"""Fault taxonomy, retry policy and watchdog of the streaming runner.

A copy of the reference's ``repro.engine.faults`` vocabulary (it holds no
JAX, but the port keeps its own copy):

* **taxonomy** — :class:`TransientFault` / :class:`PermanentFault` and
  :func:`classify`: transient errors (timeouts, I/O, lost nodes) are worth
  retrying; permanent ones (malformed data, contract violations) never are.
* **RetryPolicy** — bounded retries with exponential backoff; the jitter is
  derived deterministically from ``(seed, chunk_id, attempt)`` so two runs
  of the same config back off identically (no wall-clock randomness).
* **watchdog** — :func:`call_with_timeout` turns a *hung* provider into a
  raisable :class:`FetchTimeout` (a transient fault): the blocked call is
  abandoned on a daemon thread and the fetch pipeline moves on.
* **FaultPlan** — a deterministic, seedable injection harness: transient /
  permanent fetch errors, corrupted chunks (NaN / Inf / wrong shape),
  provider stalls and serve-side launch faults (around
  ``repro_torch.serve.ModelEntry.launch``).  The same plan faults the
  same chunk ids and launch indices as the reference's (the same NumPy
  seeds), so a chaos run replays against the reference's.
* **kernel_failure** — makes the port's kernel entry points raise for the
  duration.  The port keeps no demotion registry: a fit on the card
  inside it raises (:mod:`repro_torch.kernels.ops`).

Quarantine vs. failure: a chunk whose *fetch* raised is ``chunks_failed``
(``("fetch_error", cid, err)``); a chunk that arrived but carries bad data
is ``chunks_quarantined`` (``("quarantine", cid, reason)``, raised by the
sanitizer middleware as :class:`ChunkQuarantined`).  Both reconcile into
``done + failed + dropped + quarantined == fetched``.

* **checkpoint faults** — :func:`corrupt_checkpoint` tears a stored
  checkpoint (a truncated write) and :func:`hung_restore` makes every
  restore block (a stalled filesystem), on
  :mod:`repro_torch.cluster.checkpoint`.
* **HostDead** — a peer of a multi-host run missed an exchange window
  (:mod:`repro_torch.engine.hostmesh`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import threading
import time

import numpy as np
import torch

from repro_torch.cluster import checkpoint as ckpt_lib

TRANSIENT = "transient"
PERMANENT = "permanent"


class TransientFault(Exception):
    """An error worth retrying: the next attempt may succeed (lost node,
    throttled provider, timeout)."""


class PermanentFault(Exception):
    """An error retries cannot fix (malformed request, contract violation):
    fail the chunk immediately, never burn retry budget on it."""


class FetchTimeout(TransientFault):
    """A provider call exceeded the watchdog timeout (hung fetch)."""


class HostDead(PermanentFault):
    """A peer process missed a cross-host exchange window (crashed, hung,
    or partitioned): the multi-host run fails *loudly* at the sync window
    instead of hanging.  Raised by :mod:`repro_torch.engine.hostmesh` with
    the local ``rank``, the exchange ``window`` that timed out, and this
    rank's ``health`` accounting (``done+failed+dropped+quarantined ==
    fetched``) attached — so a surviving rank can report exactly what it
    completed."""

    def __init__(self, message: str, *, rank: int | None = None,
                 window=None, health: dict | None = None):
        super().__init__(message)
        self.rank = rank
        self.window = window
        self.health = health


class ChunkQuarantined(Exception):
    """Raised by the chunk sanitizer: the chunk arrived but its *data* is
    unusable (non-finite values, wrong shape).  Carries the reason string
    recorded in the ``("quarantine", cid, reason)`` trace event."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class InvariantViolation(RuntimeError):
    """A post-accept invariant broke (non-finite or increasing ``f_best``):
    the run is corrupt and must fail loudly, not stream on."""


# Exception types that retrying can never fix: data/contract errors.  An
# unrecognized exception defaults to transient — the retry budget is
# bounded, so optimism costs at most ``retries`` extra attempts, while
# misclassifying a recoverable blip as permanent loses the chunk forever.
_PERMANENT_TYPES = (
    PermanentFault,
    ValueError,
    TypeError,
    KeyError,
    IndexError,
    AttributeError,
    AssertionError,
    NotImplementedError,
    ZeroDivisionError,
)


def classify(exc: BaseException) -> str:
    """``TRANSIENT`` or ``PERMANENT`` for a provider exception."""
    if isinstance(exc, TransientFault):
        return TRANSIENT
    if isinstance(exc, _PERMANENT_TYPES):
        return PERMANENT
    return TRANSIENT


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries + exponential backoff with deterministic jitter.

    ``retries`` is the number of *re*-attempts after the first failure
    (0 drops the chunk at its first failure).  The jitter factor for
    ``(chunk_id, attempt)`` comes from a NumPy generator seeded with
    ``(seed, 0x5E77, chunk_id, attempt)`` — no global randomness, so a
    replayed run backs off identically.
    """

    retries: int = 0
    backoff_s: float = 0.05
    backoff_max_s: float = 2.0
    seed: int = 0

    def delay(self, chunk_id: int, attempt: int) -> float:
        """Seconds to wait before re-attempt ``attempt`` (0-based)."""
        base = min(self.backoff_s * (2.0 ** attempt), self.backoff_max_s)
        rng = np.random.default_rng((self.seed, 0x5E77, chunk_id, attempt))
        return base * (0.5 + 0.5 * float(rng.random()))

    @classmethod
    def from_config(cls, cfg) -> "RetryPolicy":
        return cls(
            retries=getattr(cfg, "retries", 0),
            backoff_s=getattr(cfg, "retry_backoff_s", 0.05),
            seed=getattr(cfg, "seed", 0),
        )


def call_with_timeout(fn, timeout: float | None, *, name: str = "watchdog"):
    """Run ``fn()`` with a wall-clock bound.

    ``timeout=None`` calls inline.  Otherwise ``fn`` runs on a daemon
    thread; if it has not finished after ``timeout`` seconds a
    :class:`FetchTimeout` is raised and the hung call is *abandoned* (its
    daemon thread cannot block interpreter exit).  The caller's thread —
    the prefetch worker — is therefore always reclaimable, whatever the
    provider does.
    """
    if timeout is None:
        return fn()
    box: dict = {}
    done = threading.Event()

    def target():
        try:
            box["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 — relayed to caller
            box["error"] = exc
        finally:
            done.set()

    thread = threading.Thread(target=target, daemon=True, name=name)
    thread.start()
    if not done.wait(timeout):
        raise FetchTimeout(
            f"provider call exceeded the {timeout:.3g}s watchdog timeout")
    if "error" in box:
        raise box["error"]
    return box["value"]


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, replayable schedule of injected faults.

    * ``transient_rate`` — fraction of chunk ids whose fetch raises a
      :class:`TransientFault` for the first ``transient_attempts`` attempts
      (then succeeds — so a retrying run recovers the chunk, a
      ``retries=0`` run drops it).  Which ids fault is a pure function of
      ``(seed, chunk_id)``.
    * ``permanent_ids`` — fetches that always raise :class:`PermanentFault`.
    * ``nan_ids`` / ``inf_ids`` / ``shape_ids`` — chunks delivered with
      NaN-poisoned / Inf-poisoned / wrong-shape data (sanitizer fodder).
    * ``stall_ids`` — fetches that sleep ``stall_s`` before returning
      (hung-provider simulation; pair with a ``fetch_timeout_s`` watchdog).

    Serve-side faults (wired via :meth:`wrap_launch` around a
    ``ModelEntry.launch``):

    * ``launch_transient_rate`` — fraction of launch *indices* that raise
      a :class:`TransientFault` (the batcher recovers them on the ref
      path); a pure function of ``(seed, launch_index)``.
    * ``launch_outage_after`` / ``launch_outage_len`` — a window of
      consecutive launches that all raise :class:`PermanentFault` (a dead
      model: bisection finds no healthy requests, the circuit breaker
      trips).
    * :meth:`wrap_launch` also fails any launch whose payload carries
      non-finite values with a :class:`PermanentFault` — the "poisoned
      request" a real kernel would choke on, isolatable only by bisection.
    """

    seed: int = 0
    transient_rate: float = 0.0
    transient_attempts: int = 1
    permanent_ids: tuple = ()
    nan_ids: tuple = ()
    inf_ids: tuple = ()
    shape_ids: tuple = ()
    stall_ids: tuple = ()
    stall_s: float = 30.0
    launch_transient_rate: float = 0.0
    launch_outage_after: int | None = None
    launch_outage_len: int = 0

    def is_transient(self, chunk_id: int) -> bool:
        if self.transient_rate <= 0.0:
            return False
        rng = np.random.default_rng((self.seed, 0xFA17, chunk_id))
        return bool(rng.random() < self.transient_rate)

    def transient_ids(self, n_chunks: int) -> list[int]:
        """The chunk ids in ``range(n_chunks)`` this plan faults."""
        return [cid for cid in range(n_chunks) if self.is_transient(cid)]

    def wrap(self, provider):
        """A provider with this plan's faults injected around ``provider``.

        Attempt counts are tracked per chunk id (exposed as
        ``wrapped.attempts``, a Counter) so transient faults clear after
        ``transient_attempts`` failures and tests can reconcile fetch
        accounting against actual provider traffic.
        """
        attempts: collections.Counter = collections.Counter()
        lock = threading.Lock()

        def fetch(chunk_id: int):
            with lock:
                attempts[chunk_id] += 1
                attempt = attempts[chunk_id]
            if chunk_id in self.stall_ids:
                time.sleep(self.stall_s)
            if chunk_id in self.permanent_ids:
                raise PermanentFault(
                    f"injected permanent fault on chunk {chunk_id}")
            if self.is_transient(chunk_id) \
                    and attempt <= self.transient_attempts:
                raise TransientFault(
                    f"injected transient fault on chunk {chunk_id} "
                    f"(attempt {attempt})")
            chunk = np.array(provider(chunk_id))  # copy: never poison source
            if chunk_id in self.nan_ids:
                chunk[::7] = np.nan
            if chunk_id in self.inf_ids:
                chunk[::11] = np.inf
            if chunk_id in self.shape_ids:
                chunk = chunk[:, : max(1, chunk.shape[1] // 2)]
            return chunk

        fetch.attempts = attempts
        return fetch

    def injector(self):
        """This plan's fetch-error faults as a legacy ``fault_injector``
        hook (``injector(cid)`` raises; data corruption and stalls need
        :meth:`wrap`, which owns the returned chunk)."""
        wrapped = self.wrap(lambda cid: np.zeros((1, 1), dtype=np.float32))

        def inject(chunk_id: int) -> None:
            wrapped(chunk_id)

        inject.attempts = wrapped.attempts
        return inject

    # -- serve-side injection ------------------------------------------------
    def is_launch_transient(self, launch_index: int) -> bool:
        if self.launch_transient_rate <= 0.0:
            return False
        rng = np.random.default_rng((self.seed, 0x1A47, launch_index))
        return bool(rng.random() < self.launch_transient_rate)

    def in_outage(self, launch_index: int) -> bool:
        if self.launch_outage_after is None or self.launch_outage_len <= 0:
            return False
        return (self.launch_outage_after <= launch_index
                < self.launch_outage_after + self.launch_outage_len)

    def wrap_launch(self, launch):
        """A ``(q, snapshot) -> (ids, dists)`` launch with faults injected.

        Wrap a :meth:`repro_torch.serve.ModelEntry.launch` with it
        (``entry.launch = plan.wrap_launch(entry.launch)``) to chaos-test
        the serving path: non-finite payloads fail permanently (the
        poisoned-request case that only batch bisection can isolate),
        outage-window launches fail permanently (a dead model — breaker
        fodder), and ``launch_transient_rate`` launches fail transiently
        (retry fodder).  ``wrapped.calls`` counts invocations; which
        launches fault is a pure function of ``(seed, launch_index)``, the
        reference's schedule (the same NumPy seeds).

        The payload check reads the padded host buffer that the batcher
        hands the launch (``ModelEntry.host_buffer``: pinned host memory
        on the card), so it never synchronises the card; it goes through
        ``torch.isfinite``, which takes a numpy array too.
        """
        calls: collections.Counter = collections.Counter()
        lock = threading.Lock()

        def wrapped(q, snapshot):
            with lock:
                idx = calls["n"]
                calls["n"] += 1
            if not bool(torch.isfinite(torch.as_tensor(q)).all()):
                raise PermanentFault(
                    f"injected: non-finite payload in launch {idx}")
            if self.in_outage(idx):
                raise PermanentFault(
                    f"injected launch outage (launch {idx})")
            if self.is_launch_transient(idx):
                raise TransientFault(
                    f"injected transient launch fault (launch {idx})")
            return launch(q, snapshot)

        wrapped.calls = calls
        return wrapped


# kernel_failure's ops: the entry of ops._KERNELS each one replaces
_KERNEL_OPS = {"assign": "assign", "update": "update", "fused": "fused",
               "fused_batched": "batched"}


@contextlib.contextmanager
def kernel_failure(op: str = "fused", exc: Exception | None = None):
    """Make one kernel entry point raise, under every policy, for the
    duration.

    ``op`` is one of ``assign`` / ``update`` / ``fused`` /
    ``fused_batched``: the kernel wrappers that
    :mod:`repro_torch.kernels.ops` dispatches to on the card
    (``ops._KERNELS``: B·, C·, A· and its dma twin, D·) are replaced by a
    function that raises ``exc`` (default ``RuntimeError("injected <op>
    kernel failure")``), and restored on exit.  The port keeps no demotion
    registry: a fit on the card inside the context raises that error
    (the reference demotes the shape to its oracle instead).  The plain
    path on the CPU launches no kernel and is not affected.
    """
    from repro_torch.kernels import ops

    if op not in _KERNEL_OPS:
        raise KeyError(
            f"unknown kernel op {op!r}; known: {sorted(_KERNEL_OPS)}")
    entry = _KERNEL_OPS[op]
    originals = {prec: table[entry] for prec, table in ops._KERNELS.items()}
    failure = exc or RuntimeError(f"injected {op} kernel failure")

    def boom(*args, **kwargs):
        raise failure

    for table in ops._KERNELS.values():
        table[entry] = boom
    try:
        yield
    finally:
        for prec, fn in originals.items():
            ops._KERNELS[prec][entry] = fn


def corrupt_checkpoint(directory: str, *, step: int | None = None,
                       keep_bytes: int = 64) -> str:
    """Truncate a checkpoint's ``arrays.npz`` to ``keep_bytes`` (a crashed /
    torn write), defaulting to the newest step.  Returns the mangled path —
    restore must now fall back to the previous intact step."""
    if step is None:
        step = ckpt_lib.latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:012d}", "arrays.npz")
    with open(path, "rb") as f:
        head = f.read(keep_bytes)
    with open(path, "wb") as f:
        f.write(head)
    return path


@contextlib.contextmanager
def hung_restore(stall_s: float | None = None):
    """Make checkpoint restore *hang* for the duration.

    Simulates an NFS-stalled checkpoint load: inside the context every
    ``checkpoint.restore`` call blocks (``stall_s`` seconds, or until the
    context exits when ``None``) before proceeding, so a
    :class:`repro_torch.serve.CheckpointWatcher` poll that reaches the load
    hangs and its ``poll_timeout_s`` watchdog must abandon it (the watcher
    calls the module attribute, which this patches).  Yields the release
    :class:`threading.Event` — set it early to un-stall mid-test.  Exiting
    the context releases stalled calls (they then complete normally, like
    a filesystem coming back).
    """
    original = ckpt_lib.restore
    release = threading.Event()

    def stalled(*args, **kwargs):
        release.wait(stall_s)
        return original(*args, **kwargs)

    ckpt_lib.restore = stalled
    try:
        yield release
    finally:
        release.set()
        ckpt_lib.restore = original
