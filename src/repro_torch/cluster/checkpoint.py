"""Minimal, dependency-free checkpointing: the reference's
``repro.cluster.checkpoint`` for trees of torch tensors.

* atomic: write to ``<dir>/tmp.<step>`` then ``os.replace`` to ``step_<n>``;
  stale ``tmp.*`` leftovers from a crashed save are cleaned on the next
  :func:`save` and never considered by restore;
* bounded: keeps the last ``keep`` checkpoints;
* self-healing: ``meta.json`` records a SHA-256 digest per data file;
  :func:`restore` verifies the newest checkpoint and falls back to the
  newest *intact* ``step_*`` when it is corrupt (truncated write, bit rot)
  instead of crashing the run or silently loading garbage.  Legacy
  checkpoints without digests are verified by a read-back load instead;
* elastic: arrays are stored as full logical values; ``restore`` puts the
  tensors on whatever device the caller names.

The on-disk layout is the reference's, so each package reads the other's
files: ``step_%012d/arrays.npz`` holds the leaves ``a0 … aN`` in
``jax.tree.flatten``'s order (:func:`flatten` gives it without JAX), and
``meta.json`` holds ``step``, ``n_leaves``, ``treedef`` and ``digests``.
Neither package's restore reads ``treedef``; the port writes a string that
names its structure.  Tensor leaves are read off their device leaf by
leaf (:func:`to_host`); other leaves (numpy arrays, Python scalars) are
stored as ``np.asarray`` gives them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree) -> tuple[list, str]:
    """``(leaves, structure)`` in ``jax.tree.flatten``'s order: NamedTuple
    fields in field order, tuples and lists in order, dict values by sorted
    key, ``None`` as no leaf; anything else is a leaf."""
    leaves: list = []

    def walk(x) -> str:
        if x is None:
            return "None"
        if isinstance(x, (tuple, list)):
            inner = ", ".join(walk(c) for c in x)
            if _is_namedtuple(x):
                return f"{type(x).__name__}({inner})"
            return f"({inner})" if isinstance(x, tuple) else f"[{inner}]"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        leaves.append(x)
        return "*"

    return leaves, walk(tree)


def unflatten(example, leaves):
    """``leaves`` (in :func:`flatten`'s order) in the structure of
    ``example``."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if isinstance(x, (tuple, list)):
            children = [build(c) for c in x]
            return type(x)(*children) if _is_namedtuple(x) \
                else type(x)(children)
        if isinstance(x, dict):
            values = {k: build(x[k]) for k in sorted(x)}
            return {k: values[k] for k in x}
        return next(it)

    return build(example)


def to_host(tree):
    """``tree`` with every leaf a numpy array, tensors read off their
    device one by one."""
    leaves, _ = flatten(tree)
    return unflatten(tree, [
        x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x) for x in leaves])


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _clean_tmp(directory: str) -> None:
    """Remove ``tmp.*`` leftovers from crashed saves: they are partial by
    definition and must never shadow or outlive real ``step_*`` dirs."""
    for entry in os.listdir(directory):
        if entry.startswith("tmp."):
            shutil.rmtree(os.path.join(directory, entry),
                          ignore_errors=True)


def save(directory: str, step: int, tree, *, keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    _clean_tmp(directory)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:012d}")
    os.makedirs(tmp, exist_ok=True)

    leaves, structure = flatten(to_host(tree))
    arrays = {f"a{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays_path = os.path.join(tmp, "arrays.npz")
    np.savez(arrays_path, **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": int(step), "n_leaves": len(leaves),
                   "treedef": structure,
                   "digests": {"arrays.npz": _sha256(arrays_path)}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for stale in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, stale))
    return final


def steps(directory: str) -> list[int]:
    """All stored checkpoint steps, ascending (``tmp.*`` never included)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_"))


def verify_step(directory: str, step: int) -> bool:
    """True iff the checkpoint at ``step`` is intact.

    Digest-bearing checkpoints are verified against their recorded
    SHA-256s; legacy checkpoints (no ``digests`` in ``meta.json``) fall
    back to actually loading ``arrays.npz`` — slower, but a truncated file
    still fails closed.
    """
    path = os.path.join(directory, f"step_{step:012d}")
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        digests = meta.get("digests")
        if digests is not None:
            return all(
                _sha256(os.path.join(path, name)) == want
                for name, want in digests.items())
        with np.load(os.path.join(path, "arrays.npz")) as data:
            return len(data.files) == int(meta["n_leaves"])
    except Exception:
        return False


def n_leaves(directory: str, step: int | None = None) -> int | None:
    """Leaf count of a stored checkpoint (from its metadata, without loading
    the arrays) — lets callers distinguish payload formats (the engine's
    ``((state, key), vns_aux)`` vs the legacy ``(state, key)``) before
    choosing an example tree for :func:`restore`."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return None
    path = os.path.join(directory, f"step_{step:012d}", "meta.json")
    with open(path) as f:
        return int(json.load(f)["n_leaves"])


def latest_step(directory: str) -> int | None:
    all_steps = steps(directory)
    return all_steps[-1] if all_steps else None


def latest_intact_step(directory: str) -> int | None:
    """The newest step that passes :func:`verify_step` (None when every
    stored checkpoint is corrupt or none exist)."""
    for step in reversed(steps(directory)):
        if verify_step(directory, step):
            return step
    return None


def restore(directory: str, example_tree, *, step: int | None = None,
            device=None, verify: bool = True):
    """Load into the structure of ``example_tree``; returns ``(tree,
    step)``.

    Where the example's leaf is a tensor, the stored array comes back as a
    tensor on ``device`` (default: that leaf's own device); every other
    leaf comes back as the stored numpy array.  Dtypes are the stored ones.
    With ``step=None`` and ``verify=True`` (the default), the newest
    *intact* checkpoint is loaded — a corrupt newest step is skipped, not
    served.  An explicit ``step`` is loaded as-is (debugging raw access).
    """
    if step is None:
        step = latest_intact_step(directory) if verify \
            else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no intact checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:012d}")
    leaves, _ = flatten(example_tree)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert len(leaves) == len(data.files), (len(leaves), len(data.files))
        stored = [data[f"a{i}"] for i in range(len(leaves))]
    new_leaves = [
        torch.from_numpy(a).to(device if device is not None else like.device)
        if isinstance(like, torch.Tensor) else a
        for like, a in zip(leaves, stored)]
    return unflatten(example_tree, new_leaves), step
