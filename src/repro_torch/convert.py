"""Carry Big-means state and quantized chunks across the two packages as
numpy arrays.

A reference ``BigMeansState`` read out as numpy becomes the port's state
(:func:`state_from_numpy`), and back (:func:`state_to_numpy`), so a run can
start from an incumbent of the other package mid-trajectory.  Both take a
state with a leading batch axis (the batched driver's per-stream states)
as they take a single one: every field keeps its shape.  A quantized chunk
travels as its numpy ``(q, scale)`` pair (:func:`quantized_from_numpy`,
:func:`quantized_to_numpy`), so both packages can be fed the same codes.

The model zoo's weights cross as the reference's parameter pytree read
out as numpy (:func:`model_params_from_numpy`), and its decode cache both
ways (:func:`cache_from_numpy`, :func:`cache_to_numpy`), so a decode can
start from the other package's cache.  A parameter-shaped pytree (a
gradient, an AdamW moment) maps to the port's parameter names and back
(:func:`named_leaves`, :func:`stacked_tree`), and AdamW's state crosses
both ways (:func:`adamw_state_from_numpy`, :func:`adamw_state_to_numpy`),
so training can continue from the other package's optimizer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bigmeans import BigMeansState
from repro_torch.kernels.precision import QuantizedChunk
from repro_torch.models import transformer
from repro_torch.train.optimizer import AdamWState

_STACKED = ("layers", "encoder")


def state_from_numpy(centroids, degenerate, f_best, n_accepted,
                     n_dist_evals, *, device) -> BigMeansState:
    """The port's state from the five fields of a reference state (single
    or batched)."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return BigMeansState(
        centroids=t(centroids, torch.float32),
        degenerate=t(degenerate, torch.bool),
        f_best=t(f_best, torch.float32),
        n_accepted=t(n_accepted, torch.int32),
        n_dist_evals=t(n_dist_evals, torch.float32),
    )


def state_to_numpy(state: BigMeansState) -> tuple[np.ndarray, ...]:
    """(centroids, degenerate, f_best, n_accepted, n_dist_evals) as numpy,
    in the reference's dtypes (f32, bool, f32, int32, f32)."""
    return tuple(field.detach().cpu().numpy() for field in state)


def quantized_from_numpy(q, scale, *, device) -> QuantizedChunk:
    """The port's :class:`QuantizedChunk` from int8 codes ``[..., m, n]``
    and f32 scales ``[..., n]`` (a reference chunk's fields as numpy)."""
    return QuantizedChunk(
        torch.as_tensor(np.array(q, dtype=np.int8), device=device),
        torch.as_tensor(np.array(scale, dtype=np.float32), device=device))


def quantized_to_numpy(qx: QuantizedChunk) -> tuple[np.ndarray, np.ndarray]:
    """(q int8, scale f32) as numpy: the fields of the reference's
    ``QuantizedChunk``."""
    return qx.q.detach().cpu().numpy(), qx.scale.detach().cpu().numpy()


def _tensor(a, *, device) -> torch.Tensor:
    """A numpy array (``ml_dtypes.bfloat16`` included) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # numpy has no bf16 of its own
        return torch.from_numpy(np.array(a.view(np.int16))).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def _load(module, tree: dict, index, path: str) -> int:
    """Copy ``tree``'s leaves into ``module``'s parameters of the same
    names (``index`` picks a layer of stacked leaves); returns the count."""
    n = 0
    for key, val in tree.items():
        where = f"{path}/{key}"
        target = getattr(module, key)
        if isinstance(val, dict):
            n += _load(target, val, index, where)
            continue
        val = np.asarray(val)
        if index is not None:
            val = val[index]
        if tuple(val.shape) != tuple(target.shape):
            raise ValueError(f"{where}: shape {val.shape} != {target.shape}")
        with torch.no_grad():
            target.copy_(_tensor(val, device=target.device))
        n += 1
    return n


def model_params_from_numpy(cfg, tree: dict, *, device):
    """The port's model holding a reference parameter pytree's values.

    ``tree`` is ``jax.tree.map(np.asarray, params)``: the stacked ``[L,
    ...]`` leaves of ``layers`` and ``encoder`` are split per layer, in the
    reference's einsum layout (``wq`` [D, H, hd], no transpose).  Every
    parameter of the port's model must be given exactly once.
    """
    model = transformer.init_params(cfg, 0, device=device,
                                    dtype=torch.float32)
    n = 0
    for key, val in tree.items():
        if key in ("layers", "encoder"):
            for i, block in enumerate(getattr(model, key)):
                n += _load(block, val, i, f"{key}[{i}]")
        else:
            n += _load(model, {key: val}, None, "")
    want = sum(1 for _ in model.parameters())
    if n != want:
        raise ValueError(f"{n} leaves loaded, the model has {want}")
    return model


def cache_from_numpy(tree: dict, *, device) -> dict:
    """A decode cache (stacked by layer) from the reference's, as numpy;
    bf16 leaves keep their bits."""
    return {key: cache_from_numpy(val, device=device)
            if isinstance(val, dict) else _tensor(val, device=device)
            for key, val in tree.items()}


def cache_to_numpy(cache: dict) -> dict:
    """A decode cache as numpy in the reference's layout; bf16 leaves come
    out as float32, which holds them exactly."""
    return {key: cache_to_numpy(val) if isinstance(val, dict)
            else val.detach().cpu().float().numpy()
            if val.dtype == torch.bfloat16 else val.detach().cpu().numpy()
            for key, val in cache.items()}


def named_leaves(tree: dict, prefix: str = "") -> dict:
    """{port parameter name: numpy array} of a parameter-shaped reference
    pytree (parameters, gradients, moments, as numpy): the stacked leaves
    of ``layers`` and ``encoder`` split per layer
    (``layers.3.attn.wq``)."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            if not prefix and key in _STACKED:
                for path, leaf in named_leaves(val).items():
                    leaf = np.asarray(leaf)
                    for i in range(leaf.shape[0]):
                        out[f"{key}.{i}.{path}"] = leaf[i]
            else:
                out.update(named_leaves(val, f"{name}."))
        else:
            out[name] = np.asarray(val)
    return dict(sorted(out.items()))


def stacked_tree(named: dict) -> dict:
    """The reference's pytree layout of {port parameter name: tensor or
    array}: per-layer leaves stacked along a new leading dim, as numpy
    (f32 for bf16 tensors, which it holds exactly)."""
    tree: dict = {}
    stacks: dict = {}
    for name, val in named.items():
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu()
            val = (val.float() if val.dtype == torch.bfloat16 else val).numpy()
        parts = name.split(".")
        if parts[0] in _STACKED:
            stacks.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = val
            continue
        node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = val
    for (top, *rest), layers in stacks.items():
        node = tree.setdefault(top, {})
        for k in rest[:-1]:
            node = node.setdefault(k, {})
        node[rest[-1]] = np.stack([layers[i] for i in range(len(layers))])
    return tree


def adamw_state_from_numpy(state, *, device) -> AdamWState:
    """The port's AdamW state from the reference's ``AdamWState`` (or any
    object with ``step``, ``mu``, ``nu``) read out as numpy."""
    def moments(tree):
        return {name: torch.from_numpy(np.array(a, np.float32)).to(device)
                for name, a in named_leaves(tree).items()}

    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        mu=moments(state.mu), nu=moments(state.nu))


def adamw_state_to_numpy(state: AdamWState) -> AdamWState:
    """An ``AdamWState`` of numpy values in the reference's layout (step an
    int32 scalar, the moments stacked by layer)."""
    return AdamWState(step=np.asarray(int(state.step), np.int32),
                      mu=stacked_tree(state.mu), nu=stacked_tree(state.nu))
