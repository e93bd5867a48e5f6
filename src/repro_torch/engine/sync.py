"""SyncPolicy — the paper's parallel modes as *data*, not control flow.

Big-means parallelism is entirely characterized by how often the independent
chunk streams exchange incumbents (paper §4.2):

* **collective** — exchange after every round (``sync_every=1``): every
  stream always continues from the global best.
* **competitive** — never exchange until the end (``sync_every=∞``): streams
  race independently and the final argmin-reduce picks the winner.
* **periodic** — exchange every ``t`` rounds: the continuum in between.

A :class:`SyncPolicy` makes the choice a value the engine threads through
its drivers.  A copy of the reference's ``repro.engine.sync`` (it holds no
JAX, but the port keeps its own copy).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SyncPolicy:
    """``every=None`` means "never until the final reduce" (competitive)."""

    every: int | None = 1
    name: str = "collective"

    def resolve(self, rounds: int) -> int:
        """The concrete ``sync_every`` for a run of ``rounds`` rounds.

        The in-core drivers take a finite ``sync_every``; competitive (∞)
        resolves to a single sync after the last round, which is exactly
        the final argmin-reduce.
        """
        if self.every is None:
            return max(int(rounds), 1)
        return self.every

    def boundary(self, round_idx: int) -> bool:
        """Host loop: should streams exchange incumbents after this round?"""
        return self.every is not None and (round_idx + 1) % self.every == 0

    @property
    def final_only(self) -> bool:
        """True when streams never exchange before the final reduce
        (competitive mode) — multi-host runs skip every mid-run barrier,
        which is where the straggler tolerance comes from: a slow host
        simply loses the final argmin instead of stalling its peers."""
        return self.every is None


def collective() -> SyncPolicy:
    return SyncPolicy(1, "collective")


def periodic(every: int) -> SyncPolicy:
    if not isinstance(every, int) or every < 1:
        raise ValueError(f"periodic sync needs a positive int, got {every!r}")
    return SyncPolicy(every, "periodic" if every > 1 else "collective")


def competitive() -> SyncPolicy:
    return SyncPolicy(None, "competitive")


def from_config(cfg) -> SyncPolicy:
    """Map the ``BigMeansConfig`` knobs to a policy.

    ``cfg.sync`` names the mode; ``'auto'`` (and ``'periodic'``) read the
    period from the legacy ``cfg.sync_every`` knob, so existing configs keep
    their exact behaviour.
    """
    mode = getattr(cfg, "sync", "auto")
    if mode in ("auto", "periodic"):
        return periodic(cfg.sync_every)
    if mode == "collective":
        return collective()
    if mode == "competitive":
        return competitive()
    raise ValueError(
        f"unknown sync mode {mode!r}; known: auto, collective, periodic, "
        "competitive")
