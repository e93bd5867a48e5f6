"""Logical-axis sharding rules, the reference's ``repro.train.sharding``.

The rules are pure functions over any mesh-like object with
``axis_names`` and ``devices.shape`` (a ``torch.distributed``
``DeviceMesh`` wrapped, or a fabricated one): logical axes ("batch",
"fsdp", "seq", "seqtp", "model", "expert") map onto the mesh's physical
axes, and parameters get their logical axes from name rules.  A spec is a
tuple of physical axes (a name, a tuple of names, or None per dim) where
the reference returns a ``PartitionSpec``.

The port runs on one card with no mesh: :func:`shard` and
:func:`shard_kv_cache` are the identity there, as the reference's are off
a mesh.  Placing tensors by these specs (DTensors) waits for the dry-run
tools; under :func:`use_mesh` the two raise rather than place nothing.
"""
from __future__ import annotations

import contextlib
import threading

_ctx = threading.local()


def _current_mesh():
    return getattr(_ctx, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh of this thread for the ``with``."""
    prev = _current_mesh()
    _ctx.mesh = mesh
    try:
        yield
    finally:
        _ctx.mesh = prev


def physical_axes(mesh, logical: str | None):
    """logical axis name -> physical mesh axes (tuple) or None."""
    names = mesh.axis_names
    batchish = tuple(a for a in ("pod", "data") if a in names)
    model = ("model",) if "model" in names else ()
    table = {
        "batch": batchish,
        "fsdp": batchish,
        "seq": batchish,          # sequence sharding reuses the data axes
        "seqtp": model,           # sequence parallel
        "model": model,
        "expert": model,
        None: (),
    }
    axes = table.get(logical, ())
    return axes if axes else None


def _axis_prod(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= sizes[a]
    return n


def spec(mesh, *logical, shape: tuple | None = None) -> tuple:
    """The physical spec of logical axes; with ``shape`` given, a dim not
    divisible by its mesh-axis product is replicated (None).  Singleton
    tuples become the bare axis name, as the reference normalizes them."""
    phys = [physical_axes(mesh, a) for a in logical]
    if shape is not None:
        phys = [p if p is None or s % _axis_prod(mesh, p) == 0 else None
                for p, s in zip(phys, shape)]
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in phys)


def _unplaced(what: str):
    return NotImplementedError(
        f"{what} on a mesh: placing tensors by these specs waits for the "
        "dry-run tools (ROADMAP queue 1 item 11.2)")


def shard(x, *logical):
    """Annotate an activation with logical axes (identity off a mesh)."""
    if _current_mesh() is None:
        return x
    raise _unplaced("shard")


def seq_axis():
    """Logical axis of the residual stream's sequence dim: 'seqtp' under
    ``flags.SEQ_PARALLEL``, replicated otherwise."""
    from repro_torch.models import flags
    return "seqtp" if flags.SEQ_PARALLEL else None


def kv_cache_logical(mesh, shape: tuple) -> tuple:
    """Logical axes of a KV cache [..., B, S, KV, hd] (optionally with a
    leading layer dim): batch over the data axes when it divides them,
    else the sequence; the model axis over the KV heads when they divide
    it, else (under ``flags.KV_SHARD_SEQ``) over the sequence."""
    from repro_torch.models import flags
    B, S, KV = shape[-4], shape[-3], shape[-2]
    nb = _axis_prod(mesh, physical_axes(mesh, "batch"))
    nm = _axis_prod(mesh, physical_axes(mesh, "model"))
    lead = (None,) * (len(shape) - 4)
    batch_ax, seq_ax = ("batch", None) if B % nb == 0 else (None, "seq")
    if KV % nm == 0:
        return lead + (batch_ax, seq_ax, "model", None)
    if flags.KV_SHARD_SEQ and S % nm == 0 and seq_ax is None:
        return lead + (batch_ax, "seqtp", None, None)
    return lead + (batch_ax, seq_ax, None, None)


def shard_kv_cache(x):
    """The KV-cache rule on a [B, S, KV, hd] tensor (identity off a mesh)."""
    if _current_mesh() is None:
        return x
    raise _unplaced("shard_kv_cache")


# ---------------------------------------------------------------------------
# Parameter rules: by leaf name, trailing-aligned; leading dims (the
# reference's stacked layer dim) are replicated.
# ---------------------------------------------------------------------------
_PARAM_RULES: dict[str, tuple] = {
    # embeddings / heads
    "embedding": ("model", "fsdp"),          # [V, D]
    "lm_head": ("fsdp", "model"),            # [D, V]
    "frontend_proj": (None, "fsdp"),         # [raw, D]
    # attention
    "wq": ("fsdp", "model", None),           # [D, H, hd]
    "wk": ("fsdp", "model", None),           # [D, KV, hd]
    "wv": ("fsdp", "model", None),
    "wo": ("model", None, "fsdp"),           # [H, hd, D]
    "q_norm": (None,),
    "k_norm": (None,),
    # dense mlp
    "w_gate": ("fsdp", "model"),             # [D, F]
    "w_up": ("fsdp", "model"),
    "w_down": ("model", "fsdp"),             # [F, D]
    # moe
    "router": ("fsdp", None),                # [D, E]
    "e_gate": ("expert", "fsdp", None),      # [E, D, Fe]
    "e_up": ("expert", "fsdp", None),
    "e_down": ("expert", None, "fsdp"),      # [E, Fe, D]
    # ssm
    "in_proj": ("fsdp", "model"),            # [D, zxbcdt]
    "out_proj": ("model", "fsdp"),           # [d_inner, D]
    "conv_w": (None, "model"),               # [width, channels]
    "conv_b": ("model",),
    "A_log": ("model",),                     # [H]
    "ssm_D": ("model",),
    "dt_bias": ("model",),
    # norms
    "scale": (None,),
}


def _parts(path) -> list[str]:
    """A parameter's path as names: a dotted name (``layers.3.attn.wq``)
    or a sequence of parts (strings, or key objects with ``key`` /
    ``name``, as the reference's tree paths)."""
    if isinstance(path, str):
        return path.split(".")
    return [p if isinstance(p, str) else
            getattr(p, "key", None) or getattr(p, "name", str(p))
            for p in path]


def param_pspec(path, shape: tuple) -> tuple:
    """Logical spec of a parameter, from the last part of its path that a
    rule names; replicated where none does."""
    name = next((k for k in reversed(_parts(path)) if k in _PARAM_RULES),
                None)
    if name is None:
        return (None,) * len(shape)
    logical = _PARAM_RULES[name]
    return (None,) * (len(shape) - len(logical)) + tuple(logical)


def param_shardings(mesh, model) -> dict:
    """{parameter name: physical spec} over ``model.named_parameters()``
    (or a {name: tensor} mapping), each dim checked for divisibility."""
    named = model.items() if isinstance(model, dict) \
        else model.named_parameters()
    return {name: spec(mesh, *param_pspec(name, tuple(t.shape)),
                       shape=tuple(t.shape))
            for name, t in named}
