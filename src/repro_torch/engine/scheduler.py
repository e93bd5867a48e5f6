"""ChunkScheduler — *which* chunk feeds *which* stream, at *what* size.

A copy of the reference's ``repro.engine.scheduler`` registry with its one
stateless schedule, :class:`Uniform`: round ``r`` feeds streams
``0..B-1`` with chunk ids ``r*B..r*B+B-1``, all at the configured ``s``
(in the host loop that is the prefetcher's id order).  ``worker`` (queue 1
item 8) and ``competitive_s`` (item 6b) are not ported yet: the config
rejects them.
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


@register_scheduler("uniform")
class Uniform:
    """The classic schedule: ids in round-major order, one size for all;
    nothing is ever reallocated."""

    name = "uniform"

    def __init__(self, cfg):
        self.s = cfg.s

    def sizes(self, batch: int) -> list[int]:
        return [self.s] * batch
