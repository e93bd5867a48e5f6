"""ChunkScheduler — *which* chunk feeds *which* stream, at *what* size.

A copy of the reference's ``repro.engine.scheduler`` (it holds no JAX, but
the port keeps its own copy).  The feeding policy is a pluggable axis of
the stream loop:

* :class:`Uniform` — the classic schedule: round ``r`` feeds streams
  ``0..B-1`` with chunk ids ``r*B..r*B+B-1``, all at the configured ``s``
  (in the host loop that is the prefetcher's id order).
* :class:`WorkerPartitioned` — the multi-worker schedule's descriptor: the
  sharded strategy (:func:`repro_torch.engine.incore.worker_sharded`)
  realizes it by folding the worker index into the key; in the stream
  loop it behaves like :class:`Uniform`.
* :class:`CompetitiveS` — competitive stochastic sample-size optimization
  (arXiv:2403.18766): streams race *different* sample sizes ``s_b``; at
  every sync window all incumbents are scored on a common evaluation chunk
  and one stream is reallocated from the worst-performing size to the
  winning size.

Schedulers are host-side objects; the registry lets follow-up samplers
plug in by name.
"""
from __future__ import annotations

from typing import Callable

_SCHEDULERS: dict[str, Callable] = {}


def register_scheduler(name: str):
    def deco(factory):
        _SCHEDULERS[name] = factory
        return factory
    return deco


def get_scheduler(name: str, cfg=None):
    """Instantiate a scheduler by name from a config."""
    try:
        factory = _SCHEDULERS[name]
    except KeyError:
        raise KeyError(
            f"unknown scheduler {name!r}; known: {list_schedulers()}"
        ) from None
    return factory(cfg)


def list_schedulers() -> list[str]:
    return sorted(_SCHEDULERS)


class _StatelessScheduler:
    """Shared base: every stream gets the configured chunk size, nothing is
    ever reallocated.  All schedulers expose this interface so any of them
    can drive the stream loop."""

    name = "stateless"

    def __init__(self, cfg=None):
        self.s = None if cfg is None else cfg.s

    def sizes(self, batch: int) -> list[int]:
        return [self.s] * batch

    @property
    def fetch_s(self):
        return self.s

    def observe_window(self, scores, sizes):
        return []           # stateless: nothing to reallocate


@register_scheduler("uniform")
class Uniform(_StatelessScheduler):
    """The classic schedule: ids in round-major order, one size for all."""

    name = "uniform"


@register_scheduler("worker")
class WorkerPartitioned(_StatelessScheduler):
    """Descriptor for the multi-worker partitioned schedule (the sharded
    strategy realizes it by folding the worker index into the key); in the
    stream loop it behaves like :class:`Uniform`."""

    name = "worker"


def default_ladder(k: int, s: int) -> tuple:
    """A geometric 3-rung ladder around the configured chunk size."""
    return (max(k, s // 2), s, 2 * s)


@register_scheduler("competitive_s")
class CompetitiveS:
    """Race per-stream sample sizes; reallocate toward the winning ``s``.

    ``ladder`` sizes are dealt round-robin over the ``batch`` streams.
    After every sync window, :meth:`observe_window` compares the best
    common-eval-chunk score achieved by each size and moves one stream from
    the worst size with spares onto the best (adopting the winner stream's
    incumbent, acceptance threshold rescaled to the new chunk size).  Every
    size keeps at least one explorer stream — early windows favour small
    sizes (they accept fast) while large sizes mature slowly, so killing a
    size on early evidence loses the race; the final allocation plus the
    eval-based final reduce is the optimizer's answer.

    Chunks are fetched at ``fetch_s = max(ladder)`` and sliced per stream,
    so one provider serves every size and replay invariance is preserved
    (per-chunk keys remain ``fold_in(seed, chunk_id)``).

    ``stream_offset`` shifts the round-robin deal: a host-mesh rank owning
    global streams ``[offset, offset + batch)`` deals its local ladder from
    the global stream index, so the fleet-wide size assignment matches the
    single-process run of the same global batch.
    """

    name = "competitive_s"

    def __init__(self, cfg=None, *, ladder=None, batch=None,
                 stream_offset: int = 0):
        if cfg is not None:
            ladder = tuple(cfg.competitive_ladder) or default_ladder(
                cfg.k, cfg.s)
            batch = cfg.batch
        if not ladder or batch is None:
            raise ValueError("CompetitiveS needs a size ladder and a batch")
        if batch < 2:
            raise ValueError(
                f"competitive_s races streams against each other; it needs "
                f"batch >= 2, got {batch}")
        self.ladder = tuple(sorted(set(int(x) for x in ladder)))
        self.s_of = [self.ladder[(stream_offset + b) % len(self.ladder)]
                     for b in range(batch)]
        self.history: list[dict] = []

    @property
    def fetch_s(self) -> int:
        return max(self.ladder)

    def sizes(self, batch: int) -> list[int]:
        return list(self.s_of)

    def observe_window(self, scores, sizes) -> list[tuple[int, int, int]]:
        """One reallocation step.

        ``scores[b]`` is stream b's incumbent quality on a COMMON evaluation
        set (the engine scores every incumbent on the same full-size chunk,
        because raw chunk objectives are not comparable across sizes: small
        chunks overfit and always look better per point).  Returns
        ``(stream, new_s, clone_from)`` moves: ``stream`` switches to
        ``new_s`` and adopts ``clone_from``'s incumbent (the engine rescales
        the cloned acceptance threshold by ``new_s / sizes[clone_from]``).
        """
        best_of_size: dict[int, float] = {}
        best_stream_of_size: dict[int, int] = {}
        for b, (s, sc) in enumerate(zip(sizes, scores)):
            if s not in best_of_size or sc < best_of_size[s]:
                best_of_size[s] = sc
                best_stream_of_size[s] = b
        ranking = sorted(best_of_size, key=best_of_size.get)
        self.history.append({
            "sizes": list(sizes),
            "eval_best": {s: best_of_size[s] for s in ranking},
            "winner_s": ranking[0],
        })
        if len(ranking) < 2:
            return []               # one size left: converged
        win_s = ranking[0]
        # reallocate from the worst size that still has a spare stream —
        # every size keeps >= 1 explorer, so an early-round loser (large s
        # matures slowly) can still win later windows and the final
        # eval-based reduce always sees every size's best incumbent
        for lose_s in reversed(ranking):
            if lose_s == win_s:
                return []           # only the winner has spares: converged
            losers = [b for b, s in enumerate(sizes) if s == lose_s]
            if len(losers) > 1:
                break
        else:
            return []
        # move the worst stream of the losing size onto the winning size
        moved = max(losers, key=lambda b: scores[b])
        clone_from = best_stream_of_size[win_s]
        self.s_of = list(sizes)
        self.s_of[moved] = win_s
        self.history[-1]["moved"] = (moved, lose_s, win_s)
        return [(moved, win_s, clone_from)]
