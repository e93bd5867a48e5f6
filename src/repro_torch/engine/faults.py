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

Quarantine vs. failure: a chunk whose *fetch* raised is ``chunks_failed``
(``("fetch_error", cid, err)``); a chunk that arrived but carries bad data
is ``chunks_quarantined`` (``("quarantine", cid, reason)``, raised by the
sanitizer middleware as :class:`ChunkQuarantined`).  Both reconcile into
``done + failed + dropped + quarantined == fetched``.

Not ported yet: ``HostDead`` (ROADMAP queue 1 item 8) and the injection
harness ``FaultPlan`` with ``corrupt_checkpoint``, ``kernel_failure`` and
``hung_restore`` (queue 1 item 6b).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

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
