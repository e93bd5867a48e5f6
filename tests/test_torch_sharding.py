"""The port's sharding rules (``repro_torch.train.sharding``) against the
reference's ``repro.train.sharding`` on fabricated meshes (pure logic, as
``tests/test_sharding_rules.py``), and their mirror of that test's cases.

A spec is a tuple in the port and a ``PartitionSpec`` in the reference;
they are held equal as tuples.  The parameter rules run over every
parameter of each published config, the port's per-layer names against the
reference's stacked pytree paths (the port's model built on the ``meta``
device: shapes, no storage).
"""
import dataclasses
import itertools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.models import flags as jflags
from repro.models import transformer as JT
from repro.models import registry as jreg
from repro.train import sharding as jsh
from repro_torch.models import flags as pflags
from repro_torch.models import moe as pmoe
from repro_torch.models import registry as preg
from repro_torch.models import transformer as PT
from repro_torch.train import sharding as psh

MESH = types.SimpleNamespace(axis_names=("data", "model"),
                             devices=np.zeros((16, 16)))
POD_MESH = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 devices=np.zeros((2, 16, 16)))
MESHES = {
    "data16_model16": MESH,
    "pod2_data16_model16": POD_MESH,
    "data8": types.SimpleNamespace(axis_names=("data",),
                                   devices=np.zeros((8,))),
    "model4": types.SimpleNamespace(axis_names=("model",),
                                    devices=np.zeros((4,))),
    "data2_model4": types.SimpleNamespace(axis_names=("data", "model"),
                                          devices=np.zeros((2, 4))),
}
LOGICAL = ("batch", "fsdp", "seq", "seqtp", "model", "expert", None,
           "unknown")


@pytest.fixture
def flag(monkeypatch):
    def set_(name, value):
        monkeypatch.setattr(jflags, name, value)
        monkeypatch.setattr(pflags, name, value)
    return set_


def _tuple(spec) -> tuple:
    return tuple(spec)


# ------------------------------------------------ against the reference

@pytest.mark.parametrize("mesh", list(MESHES))
def test_physical_axes_and_spec_equal_the_references(mesh):
    m = MESHES[mesh]
    for logical in LOGICAL:
        assert psh.physical_axes(m, logical) == jsh.physical_axes(m, logical)
    for axes in itertools.product(LOGICAL[:7], repeat=2):
        for shape in (None, (32, 48), (50280, 2560), (5, 7), (16, 1)):
            got = psh.spec(m, *axes, shape=shape)
            assert got == _tuple(jsh.spec(m, *axes, shape=shape)), \
                (axes, shape)
            assert isinstance(got, tuple)


@pytest.mark.parametrize("kv_shard_seq", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_kv_cache_logical_equals_the_references(mesh, kv_shard_seq, flag):
    flag("KV_SHARD_SEQ", kv_shard_seq)
    m = MESHES[mesh]
    for shape in itertools.product((32, 1), (4, 128, 32768, 524288),
                                   (16, 8, 5, 4, 1), (64, 128)):
        for lead in ((), (26,)):
            s = lead + shape
            assert psh.kv_cache_logical(m, s) == jsh.kv_cache_logical(m, s)


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_seq_axis_follows_the_switch(seq_parallel, flag):
    flag("SEQ_PARALLEL", seq_parallel)
    assert psh.seq_axis() == jsh.seq_axis() == (
        "seqtp" if seq_parallel else None)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", preg.LM_ARCHS)
def test_param_shardings_equal_the_references(arch, mesh):
    """Every parameter of the published config: the port's
    ``param_shardings`` over its per-layer names equal, layer by layer,
    the reference's rule on the stacked leaf (its layer dim replicated)."""
    m = MESHES[mesh]
    jcfg, pcfg = jreg.get_config(arch), preg.get_config(arch)
    shapes = JT.abstract_params(jcfg)
    model = PT.Model(pcfg, None, device=torch.device("meta"),
                     dtype=torch.float32)
    got = psh.param_shardings(m, model)
    assert len(got) == sum(1 for _ in model.parameters())
    seen = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in path]
        want = _tuple(jsh.spec(m, *jsh.param_pspec(path, leaf.shape),
                               shape=leaf.shape))
        if keys[0] in ("layers", "encoder"):
            for i in range(leaf.shape[0]):
                name = ".".join([keys[0], str(i)] + keys[1:])
                assert want[0] is None
                assert got[name] == want[1:], name
                seen += 1
        else:
            assert got[".".join(keys)] == want, keys
            seen += 1
    assert seen == len(got)


def test_param_pspec_on_names_and_paths():
    for name, shape in (("layers.3.moe.e_gate", (128, 4096, 1536)),
                        ("layers.0.ssm.gate_norm.scale", (3200,)),
                        ("embedding", (151936, 4096)),
                        ("layers.1.moe.shared.w_down", (2816, 2048)),
                        ("mystery", (3, 4))):
        parts = [types.SimpleNamespace(key=k) for k in name.split(".")]
        want = jsh.param_pspec(parts, shape)
        assert psh.param_pspec(name, shape) == want
        assert psh.param_pspec(parts, shape) == want
        assert psh.param_pspec(name.split("."), shape) == want


def test_shard_is_the_identity_off_a_mesh_and_refuses_on_one():
    """Off a mesh ``shard`` and ``shard_kv_cache`` return their argument;
    on a fabricated mesh (the rules' alone) they refuse to place; on a
    torch ``DeviceMesh`` over a fake world they place by the rules' spec
    (a plain tensor distributed, a DTensor redistributed)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import mesh as pmesh

    x = torch.arange(6.0).reshape(2, 3)
    kv = torch.zeros((2, 16, 2, 4))                   # [B, S, KV, hd]
    assert psh.shard(x, "batch", None) is x
    assert psh.shard_kv_cache(x) is x
    assert psh._current_mesh() is None
    with psh.use_mesh(MESH):
        assert psh._current_mesh() is MESH
        with psh.use_mesh(None):
            assert psh._current_mesh() is None
            assert psh.shard(x, "batch", None) is x
        with pytest.raises(TypeError, match="torch DeviceMesh"):
            psh.shard(x, "batch", None)
        with pytest.raises(TypeError, match="torch DeviceMesh"):
            psh.shard_kv_cache(kv)
    assert psh._current_mesh() is None
    y = torch.arange(32.0).reshape(4, 8)
    with pmesh.fake_world(4):
        mesh = pmesh.make_mesh((2, 2), ("data", "model"))
        with psh.use_mesh(mesh):
            d = psh.shard(y, "batch", "model")
            assert isinstance(d, DTensor)
            assert list(d.placements) == [Shard(0), Shard(1)]
            assert torch.equal(d.to_local(), y[:2, :4])       # rank 0
            r = psh.shard(d, None, "model")
            assert list(r.placements) == [Replicate(), Shard(1)]
            assert psh.shard(r, None, "model") is r
            c = psh.shard_kv_cache(kv)
            assert list(c.placements) == [Shard(0), Shard(2)]
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mesh,groups", [("data16_model16", 16),
                                         ("pod2_data16_model16", 32),
                                         ("model4", 1)])
def test_moe_auto_groups_follow_the_mesh(mesh, groups, flag):
    """``MOE_GROUPED_DISPATCH = -1``: one group per batch shard of the
    active mesh (the reference's rule), one off a mesh; 0 and > 0 as
    given."""
    flag("MOE_GROUPED_DISPATCH", -1)
    assert pmoe._groups() == 1
    with psh.use_mesh(MESHES[mesh]):
        assert pmoe._groups() == groups
        flag("MOE_GROUPED_DISPATCH", 0)
        assert pmoe._groups() == 0
        flag("MOE_GROUPED_DISPATCH", 4)
        assert pmoe._groups() == 4


# ------------------------------------------------ the reference test's cases

def test_batch_axes_adapt_to_pod():
    assert psh.physical_axes(MESH, "batch") == ("data",)
    assert psh.physical_axes(POD_MESH, "batch") == ("pod", "data")
    assert psh.physical_axes(POD_MESH, "fsdp") == ("pod", "data")


def test_kv_cache_heads_sharded_when_divisible():
    logical = psh.kv_cache_logical(MESH, (32, 128, 32768, 16, 128))
    assert logical == (None, "batch", None, "model", None)


def test_kv_cache_seq_fallback_for_gqa(flag):
    flag("KV_SHARD_SEQ", True)
    logical = psh.kv_cache_logical(MESH, (16, 128, 32768, 8, 64))
    assert logical == (None, "batch", "seqtp", None, None)
    flag("KV_SHARD_SEQ", False)
    logical = psh.kv_cache_logical(MESH, (16, 128, 32768, 8, 64))
    assert logical == (None, "batch", None, None, None)


def test_kv_cache_batch1_long_context():
    logical = psh.kv_cache_logical(MESH, (26, 1, 524288, 4, 256))
    assert logical[1] is None
    assert logical[2] == "seq"


def test_param_rules_expert_weights():
    spec = psh.param_pspec(
        (types.SimpleNamespace(key="layers"), types.SimpleNamespace(key="moe"),
         types.SimpleNamespace(key="e_gate")),
        (94, 128, 4096, 1536))
    assert spec == (None, "expert", "fsdp", None)
    assert psh.param_pspec("layers.5.moe.e_gate", (128, 4096, 1536)) == (
        "expert", "fsdp", None)


def test_param_rules_unknown_replicated():
    spec = psh.param_pspec((types.SimpleNamespace(key="mystery"),), (3, 4))
    assert spec == (None, None)


def test_spec_divisibility_guard():
    s = psh.spec(MESH, "model", "fsdp", shape=(50280, 2560))
    assert s[0] is None and s[1] == "data"
    s = psh.spec(MESH, "model", "fsdp", shape=(151936, 4096))
    assert s == ("model", "data") == tuple(P("model", "data"))


def test_param_shardings_on_a_dict_and_a_reduced_model():
    cfg = dataclasses.replace(preg.get_config("qwen3-moe-235b-a22b").reduced())
    model = PT.init_params(cfg, 0, device="cpu")
    named = dict(model.named_parameters())
    assert psh.param_shardings(MESH, named) == psh.param_shardings(MESH,
                                                                   model)
