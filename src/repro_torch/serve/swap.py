"""Hot-swap: refresh serving centroids from training checkpoints.

The port of the reference's ``repro.serve.swap``.  Training writes
SHA-256-digested checkpoints (:mod:`repro_torch.cluster.checkpoint`, in
the reference's layout, so either package's checkpoints serve here); this
module is the serving-side consumer.  :func:`load_centroids` restores the
newest *intact* step through the verified restore path (a torn or
bit-rotted newest step falls back, never serves garbage), understands both
the engine's ``((state, key), vns_aux)`` payload and the legacy
``(state, key)`` one, and reduces a batched incumbent state to its best
stream.  A :class:`CheckpointWatcher` polls a directory and swaps the
registry pointer whenever a newer intact step appears — traffic keeps
flowing through the swap (see
:meth:`repro_torch.serve.registry.ModelEntry.swap`).

Every restore goes through the module attribute ``checkpoint.restore``, so
:func:`repro_torch.engine.faults.hung_restore` stalls it.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.cluster import checkpoint
from repro_torch.core import bigmeans
from repro_torch.serve.registry import CentroidSnapshot, ModelRegistry


def _example_tree(k: int, n: int, n_leaves: int):
    """The restore skeleton matching a stored payload's leaf count.

    The streaming engine persists ``((BigMeansState, key), aux[3])``
    (7 leaves); pre-engine checkpoints stored ``(BigMeansState, key)``
    (6 leaves).  Leaf *shapes* in the example are irrelevant — restore
    fills in the stored arrays — only structure and count matter.
    """
    legacy = (bigmeans.init_state(k, n, device="cpu"),
              np.zeros(2, np.uint32))
    n_legacy = len(checkpoint.flatten(legacy)[0])
    if n_leaves == n_legacy:
        return legacy, False
    if n_leaves == n_legacy + 1:
        return (legacy, np.zeros(3, np.int64)), True
    raise ValueError(
        f"unrecognized checkpoint payload: {n_leaves} leaves "
        f"(expected {n_legacy} or {n_legacy + 1})")


def load_centroids(ckpt_dir: str, *, step: int | None = None
                   ) -> tuple[np.ndarray, int]:
    """Load ``(centroids [k, n], step)`` from the newest intact checkpoint.

    Only steps passing the SHA-256 digest check are considered; a batched
    state's streams are reduced to the one with the best (finite, minimal)
    ``f_best``.
    """
    if step is None:
        step = checkpoint.latest_intact_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no intact checkpoint under {ckpt_dir}")
    elif not checkpoint.verify_step(ckpt_dir, step):
        raise ValueError(
            f"checkpoint step {step} under {ckpt_dir} fails verification")
    n_leaves = checkpoint.n_leaves(ckpt_dir, step)
    example, engine_payload = _example_tree(1, 1, n_leaves)
    tree, got_step = checkpoint.restore(ckpt_dir, example, step=step)
    state = tree[0][0] if engine_payload else tree[0]
    centroids = state.centroids.numpy().astype(np.float32, copy=False)
    if centroids.ndim == 3:                      # batched incumbent streams
        f_best = state.f_best.numpy().astype(np.float64).reshape(-1)
        f_best = np.where(np.isfinite(f_best), f_best, np.inf)
        centroids = centroids[int(np.argmin(f_best))]
    if centroids.ndim != 2:
        raise ValueError(
            f"checkpoint centroids have shape {centroids.shape}, "
            "expected [k, n] or [B, k, n]")
    return centroids, int(got_step)


def swap_from_checkpoint(registry: ModelRegistry, model_id: str,
                         ckpt_dir: str, *, step: int | None = None
                         ) -> CentroidSnapshot:
    """One-shot refresh: load the newest intact step and swap it in."""
    centroids, got_step = load_centroids(ckpt_dir, step=step)
    return registry.swap(model_id, centroids, step=got_step)


class CheckpointWatcher:
    """Supervised background thread: poll a checkpoint dir, swap new steps.

    The watcher only ever moves *forward* (a step newer than the last one
    it swapped in) and only through intact checkpoints, so a torn write
    mid-poll is skipped until the next complete save.  *Nothing* a poll
    does can kill the thread: every exception — including one from the
    directory scan itself — is recorded (``last_error`` / ``n_errors``)
    and retried next interval, and with ``poll_timeout_s`` each poll runs
    under a watchdog so a hung checkpoint load (NFS stall, torn mmap) is
    abandoned and counted in ``stalled_polls`` instead of freezing
    hot-swap forever.  Serving always continues on the current snapshot;
    ``describe()`` feeds ``Server.health()``.
    """

    def __init__(self, registry: ModelRegistry, model_id: str,
                 ckpt_dir: str, *, poll_interval_s: float = 0.2,
                 poll_timeout_s: float | None = 30.0):
        self.registry = registry
        self.model_id = model_id
        self.ckpt_dir = ckpt_dir
        self.poll_interval_s = poll_interval_s
        self.poll_timeout_s = poll_timeout_s
        self.n_swaps = 0
        self.n_errors = 0
        self.stalled_polls = 0
        self.last_step: int | None = None
        self.last_error: str | None = None
        self.last_poll_t: float | None = None    # monotonic, end of last poll
        self._stop = threading.Event()
        self._pending_done: threading.Event | None = None  # abandoned poll
        self._thread = threading.Thread(
            target=self._run, name=f"swap-{model_id}", daemon=True)

    def start(self) -> "CheckpointWatcher":
        # Seed the high-water mark with what is already serving, so a
        # watcher attached after a manual swap does not re-apply it.
        snap = self.registry.get(self.model_id).snapshot()
        if self.last_step is None:
            self.last_step = snap.step
        self._thread.start()
        return self

    def poll_once(self) -> bool:
        """One poll: swap if a newer intact step exists.  True on swap.
        Never raises — any failure lands in ``last_error``/``n_errors``."""
        try:
            step = checkpoint.latest_intact_step(self.ckpt_dir)
            if step is None or (self.last_step is not None
                                and step <= self.last_step):
                return False
            swap_from_checkpoint(self.registry, self.model_id,
                                 self.ckpt_dir, step=step)
        except Exception as exc:
            self.n_errors += 1
            self.last_error = f"{type(exc).__name__}: {exc}"
            return False
        self.last_step = step
        self.n_swaps += 1
        self.last_error = None
        return True

    def _poll_guarded(self) -> None:
        """One supervised poll cycle, with the hung-poll watchdog.

        An abandoned poll keeps running on its (daemon) thread; until it
        finishes we *skip* further polls rather than stacking a second
        load on top of a stalled filesystem.
        """
        if self._pending_done is not None:
            if not self._pending_done.is_set():
                return                            # previous poll still hung
            self._pending_done = None
        if self.poll_timeout_s is None:
            self.poll_once()
            self.last_poll_t = time.monotonic()
            return
        done = threading.Event()

        def _target():
            try:
                self.poll_once()
            finally:
                done.set()

        t = threading.Thread(target=_target,
                             name=f"swap-poll-{self.model_id}", daemon=True)
        t.start()
        if not done.wait(self.poll_timeout_s):
            self.stalled_polls += 1
            self.last_error = (
                f"poll stalled past {self.poll_timeout_s}s; abandoned")
            self._pending_done = done             # don't stack another poll
            self.registry.record(
                ("watcher_stall", self.model_id, self.poll_timeout_s))
        self.last_poll_t = time.monotonic()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._poll_guarded()
            except Exception as exc:  # pragma: no cover — belt and braces
                self.n_errors += 1
                self.last_error = f"{type(exc).__name__}: {exc}"
            self._stop.wait(self.poll_interval_s)

    def alive(self) -> bool:
        return self._thread.is_alive()

    def describe(self) -> dict:
        """A JSON-safe snapshot for ``Server.health()``."""
        return {
            "model_id": self.model_id,
            "ckpt_dir": self.ckpt_dir,
            "alive": self.alive(),
            "n_swaps": self.n_swaps,
            "n_errors": self.n_errors,
            "stalled_polls": self.stalled_polls,
            "last_step": self.last_step,
            "last_error": self.last_error,
            "poll_age_s": (round(time.monotonic() - self.last_poll_t, 3)
                           if self.last_poll_t is not None else None),
        }

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
