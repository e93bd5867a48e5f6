"""Logical-axis sharding rules, the reference's ``repro.train.sharding``.

The rules are pure functions over any mesh-like object with
``axis_names`` and ``devices.shape`` (:class:`MeshView` over a
``torch.distributed`` ``DeviceMesh``, or a fabricated one): logical axes
("batch", "fsdp", "seq", "seqtp", "model", "expert") map onto the mesh's
physical axes, and parameters get their logical axes from name rules.  A
spec is a tuple of physical axes (a name, a tuple of names, or None per
dim) where the reference returns a ``PartitionSpec``.

Off a mesh :func:`shard` and :func:`shard_kv_cache` are the identity, as
the reference's are; the port's runs on one card have no mesh.  Under
:func:`use_mesh` with a torch ``DeviceMesh`` they place a tensor by its
spec (:func:`place`): a plain tensor becomes a ``DTensor``
(``distribute_tensor``, each rank keeping its own shard), a ``DTensor``
is redistributed, which is where the collectives of a sharded step come
from.  A fabricated mesh has no devices to place onto, so there they
raise.
"""
from __future__ import annotations

import contextlib
import types

# The active mesh is the process's, not a thread's: autograd runs a
# backward (and the recomputation of a checkpointed layer) on threads of
# its own, which must place tensors as the forward did.
_active: list = [None]


class MeshView:
    """The rules' view of a torch ``DeviceMesh``: ``axis_names`` (its
    ``mesh_dim_names``) and ``devices.shape`` / ``devices.size`` (its
    shape), with the mesh itself as ``mesh``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.devices = types.SimpleNamespace(shape=tuple(mesh.shape),
                                             size=mesh.size())


def _current_mesh():
    return _active[0]


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the process's active mesh for the ``with``: a torch
    ``DeviceMesh`` (held as its :class:`MeshView`), a mesh-like object for
    the rules alone, or None.  Under a torch mesh a plain tensor that meets
    a ``DTensor`` (a position table, a mask) counts as replicated
    (``implicit_replication``): every rank holds the same one."""
    ctx = contextlib.nullcontext()
    if hasattr(mesh, "mesh_dim_names"):
        from torch.distributed.tensor.experimental import implicit_replication
        mesh, ctx = MeshView(mesh), implicit_replication()
    prev = _active[0]
    _active[0] = mesh
    try:
        with ctx:
            yield
    finally:
        _active[0] = prev


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


def placements(mesh, spec: tuple) -> list:
    """A spec's DTensor placements, one a mesh axis: ``Shard(d)`` on each
    axis that spec dim ``d`` names, ``Replicate()`` elsewhere.  Axes that
    share a dim split it major to minor in mesh order, as a
    ``PartitionSpec``'s tuple does, so an axis tuple out of mesh order is
    refused."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.axis_names)
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = axes if isinstance(axes, tuple) else (axes,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {dim} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def place(x, mesh, spec: tuple):
    """``x`` placed on ``mesh`` (a :class:`MeshView`) by ``spec``: a
    ``DTensor`` redistributed, a plain tensor distributed without a
    collective (each rank takes its shard of the value it holds)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(mesh, MeshView):
        raise TypeError(
            f"placing a tensor needs a torch DeviceMesh, got {mesh!r} "
            "(a fabricated mesh serves the rules alone)")
    want = placements(mesh, spec)
    if isinstance(x, DTensor):
        if list(x.placements) == want:
            return x
        return x.redistribute(mesh.mesh, want)
    return distribute_tensor(x, mesh.mesh, want, src_data_rank=None)


def like(x, ref):
    """``x`` placed as the ``DTensor`` ``ref`` is (``x`` as it is where
    either is a plain tensor)."""
    from torch.distributed.tensor import DTensor

    if not (isinstance(x, DTensor) and isinstance(ref, DTensor)) \
            or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def coordinate(axis: str) -> int:
    """This rank's index along mesh ``axis`` of the active mesh."""
    return _current_mesh().mesh.get_local_rank(axis)


def partial(axes, spec: tuple) -> tuple:
    """``spec`` summed over the mesh ``axes`` (a name, a tuple or None):
    the form :func:`on_shards` reads; ``spec`` itself when no axis."""
    if axes is None:
        return spec
    axes = axes if isinstance(axes, tuple) else (axes,)
    return ("partial", axes, spec) if axes else spec


def on_shards(fn, args: tuple, specs: tuple, out_specs, grad_specs=None):
    """``fn`` run on each rank's shards of ``args`` (``local_map``): under
    a torch mesh with a DTensor among ``args``, each tensor argument is
    placed by its spec first (None: taken as it is) and ``fn``'s results,
    local tensors, become DTensors placed by ``out_specs`` (a spec, or a
    list of specs, one a result).  ``grad_specs`` (one an argument) say
    how the gradients of the arguments are placed where they are not as
    the arguments: a rank's gradient of an argument it holds whole is a
    partial sum where the ranks worked on different parts of the rest
    (:func:`partial` gives that form).  Off a mesh, or on plain tensors,
    it is ``fn(*args)``.  The regions that run so are those DTensor has
    no sharding strategy for; each says how its shards relate."""
    import torch
    from torch.distributed.tensor import DTensor, Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = _current_mesh()
    if mesh is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)

    def pl(spec):
        if spec is None:
            return None
        if spec and spec[0] == "partial":
            out = placements(mesh, spec[2])
            for a in spec[1]:
                out[list(mesh.axis_names).index(a)] = Partial()
            return out
        return placements(mesh, spec)

    placed = []
    for a, sp in zip(args, specs):
        if sp is not None and isinstance(a, torch.Tensor):
            a = place(a, mesh, sp)
        placed.append(a)
    in_pl = tuple(pl(sp) if isinstance(a, DTensor) else None
                  for a, sp in zip(placed, specs))
    out_pl = pl(out_specs) if not isinstance(out_specs, list) \
        else tuple(pl(sp) for sp in out_specs)
    grad_pl = None if grad_specs is None else tuple(
        pl(g) if isinstance(a, DTensor) else None
        for a, g in zip(placed, grad_specs))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh.mesh,
                     redistribute_inputs=True)(*placed)


def project(equation: str, x, w, rule: str):
    """``torch.einsum(equation, x, w)``: an activation ``x`` (batch first)
    times a weight ``w`` that the parameter rule ``rule`` places.  Under a
    mesh it runs on each rank's shards: the weight with its FSDP axes
    gathered and its model-axis split kept, ``x``'s batch rows on the batch
    axes and its dims that the weight splits split alike; a contracted dim
    that is split makes the result a ``Partial`` sum over its axes.
    (DTensor's own einsum picks splits of the flattened product that the
    views after it cannot undo.)"""
    import torch

    mesh = _current_mesh()
    if mesh is None:
        return torch.einsum(equation, x, w)
    ins, out = equation.split("->")
    xl, wl = ins.split(",")
    logical = tuple(None if a == "fsdp" else a
                    for a in param_pspec(rule, tuple(w.shape)))
    ws = spec(mesh, *logical, shape=tuple(w.shape))
    axis = {c: a for c, a in zip(wl, ws) if a is not None}
    batch = spec(mesh, "batch", shape=(x.shape[0],))[0]
    xs = tuple(batch if i == 0 else axis.get(c) for i, c in enumerate(xl))
    os = tuple(batch if c == xl[0] else axis.get(c) for c in out)

    def axes_of(letters):
        found = []
        for c in letters:
            a = axis.get(c) if c != xl[0] else batch
            if a is not None:
                found.extend(a if isinstance(a, tuple) else (a,))
        return tuple(found)

    out_spec = partial(axes_of(c for c in xl if c in wl and c not in out),
                       os)
    # the gradients: x's sums over the weight's own output dims, the
    # weight's over x's batch (and other) dims
    gx = partial(axes_of(c for c in wl if c in out and c not in xl), xs)
    gw = partial(axes_of(c for c in xl if c in out and c not in wl), ws)
    return on_shards(lambda a, b: torch.einsum(equation, a, b), (x, w),
                     (xs, ws), out_spec, (gx, gw))


def shard(x, *logical):
    """Place an activation by its logical axes (identity off a mesh)."""
    mesh = _current_mesh()
    if mesh is None:
        return x
    return place(x, mesh, spec(mesh, *logical, shape=tuple(x.shape)))


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
    mesh = _current_mesh()
    if mesh is None:
        return x
    shape = tuple(x.shape)
    return place(x, mesh, spec(mesh, *kv_cache_logical(mesh, shape),
                               shape=shape))


def cache_spec(mesh, name: str, shape: tuple) -> tuple:
    """The spec of a decode-cache leaf by its name: K / V (and the
    cross-attention's) by :func:`kv_cache_logical`, the SSM's ``conv``
    [L,B,w-1,C] and ``state`` [L,B,H,P,N] by batch and channels / heads."""
    if name in ("k", "v", "cross_k", "cross_v"):
        logical = kv_cache_logical(mesh, shape)
    elif name == "conv":
        logical = (None, "batch", None, "model")
    elif name == "state":
        logical = (None, "batch", "model", None, None)
    else:
        logical = (None,) * len(shape)
    return spec(mesh, *logical, shape=shape)


def shard_cache(cache: dict) -> dict:
    """A decode cache placed leaf by leaf (:func:`cache_spec`); the
    identity off a mesh."""
    mesh = _current_mesh()
    if mesh is None:
        return cache
    return {k: shard_cache(v) if isinstance(v, dict)
            else place(v, mesh, cache_spec(mesh, k, tuple(v.shape)))
            for k, v in cache.items()}


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


def place_params(model, mesh, make=None):
    """``model`` with each parameter replaced by a frozen ``DTensor`` placed
    on ``mesh`` (a :class:`MeshView`) by :func:`param_shardings`, from
    ``make(parameter)`` (its value by default; the dry run makes fake
    tensors of its shape).  Every rank holds the whole value and keeps its
    shard, with no collective.  Returns ``model``, changed in place."""
    import torch

    p_sh = param_shardings(mesh, model)
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        x = p.detach() if make is None else make(p)
        mod._parameters[leaf] = torch.nn.Parameter(
            place(x, mesh, p_sh[name]), requires_grad=False)
    return model


def param_shardings(mesh, model) -> dict:
    """{parameter name: physical spec} over ``model.named_parameters()``
    (or a {name: tensor} mapping), each dim checked for divisibility."""
    named = model.items() if isinstance(model, dict) \
        else model.named_parameters()
    return {name: spec(mesh, *param_pspec(name, tuple(t.shape)),
                       shape=tuple(t.shape))
            for name, t in named}
