"""The port's launch layer (``repro_torch.launch``) against the reference's
``repro.launch``: abstract parameters and caches, input specs, the specs
of every input leaf, the placement of a tensor on a fake mesh, the
collective counter, the report's tables, the perf switches, the committed
H100 tuner profile and ``roofline.main``.

The reference's own ``cache_shardings`` / ``input_shardings`` need a real
JAX mesh: they run once per module in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_torch_sharded.py`` does) on a (2, 4) mesh, and there also give
the shard of each device of a 2 x 2 x 2 mesh.  On fabricated 16 x 16 and
2 x 16 x 16 meshes the reference's spec functions run in this process with
its ``NamedSharding`` replaced by the bare ``PartitionSpec``.
"""
import json
import os
import re
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.shapes import SHAPES
from repro.launch import report as jreport
from repro.launch import specs as jspecs
from repro.models import registry as jreg
from repro.models import transformer as JT
from repro_torch.evalsuite import schema
from repro_torch.kernels import autotune
from repro_torch.launch import hlo_analysis, mesh as pmesh, perf, report
from repro_torch.launch import roofline, specs
from repro_torch.models import flags as pflags
from repro_torch.models import registry as preg
from repro_torch.models import transformer as PT
from repro_torch.train import sharding as psh
from test_torch_sharding import MESH, POD_MESH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = preg.LM_ARCHS
CELLS = [(a, s) for a in ARCHS for s in SHAPES]
PROFILE = os.path.join(REPO, "results", "autotune", "cuda-sm_90.json")

_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.shapes import SHAPES
from repro.launch import specs
from repro.launch.mesh import make_mesh
from repro.models.registry import LM_ARCHS, get_config


def as_list(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def tree(t):
    if isinstance(t, dict):
        return {k: tree(v) for k, v in t.items()}
    return as_list(t.spec)


mesh = make_mesh((2, 4), ("data", "model"))
out = {"cells": {}}
for arch in LM_ARCHS:
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        sp = specs.input_specs(cfg, shape)
        out["cells"][f"{arch}|{name}"] = tree(
            specs.input_shardings(mesh, cfg, shape, sp))
mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"))
idx = NamedSharding(mesh3, P(("pod", "data"), "model")).devices_indices_map(
    (8, 4))
out["shards"] = [[[s.start or 0, s.stop if s.stop is not None else n]
                  for s, n in zip(idx[d], (8, 4))]
                 for d in mesh3.devices.flat]
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch") / "ref.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", _SCRIPT, str(out)], check=True,
                   env=env, cwd=REPO, timeout=300)
    return json.loads(out.read_text())


def _tuple(spec) -> tuple:
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


def _named_shapes(tree, prefix=""):
    """{port parameter name: (shape, dtype)} of the reference's abstract
    parameter pytree, its stacked layers split as ``convert.named_leaves``
    splits them."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            if not prefix and key in ("layers", "encoder"):
                for path, (shape, dt) in _named_shapes(val).items():
                    for i in range(shape[0]):
                        out[f"{key}.{i}.{path}"] = (shape[1:], dt)
            else:
                out.update(_named_shapes(val, f"{name}."))
        else:
            out[name] = (tuple(val.shape), np.dtype(val.dtype).name)
    return out


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


# ------------------------------------------------ abstract params / caches

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_the_reference(arch, dtype):
    """Every leaf's shape and dtype at full width, on ``meta`` (no
    storage, no draws: qwen3-moe-235b-a22b included)."""
    want = _named_shapes(JT.abstract_params(jreg.get_config(arch),
                                            getattr(jnp, dtype)))
    model = PT.abstract_params(preg.get_config(arch), getattr(torch, dtype))
    got = {n: (tuple(p.shape), _dtype(p))
           for n, p in model.named_parameters()}
    assert got == want
    assert all(p.device.type == "meta" for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_equals_the_reference(arch):
    jcfg, pcfg = jreg.get_config(arch), preg.get_config(arch)
    kw = dict(enc_len=jcfg.frontend_len if jcfg.cross_attention else None)
    want = JT.abstract_cache(jcfg, 128, 32768, **kw)
    got = PT.abstract_cache(pcfg, 128, 32768, **kw)

    def flat(t, f):
        return {k: flat(v, f) if isinstance(v, dict) else f(v)
                for k, v in t.items()}

    assert flat(got, lambda t: (tuple(t.shape), _dtype(t))) == flat(
        want, lambda a: (tuple(a.shape), np.dtype(a.dtype).name))
    assert all(t.device.type == "meta" for t in
               torch.utils._pytree.tree_leaves(got))


# ------------------------------------------------------------ input specs

@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_equal_the_reference(arch, shape_name):
    """``input_specs`` for every (arch, shape) cell, leaf by leaf, as
    ``tests/test_launch.py::test_input_specs_all_cells`` runs them."""
    want = jspecs.input_specs(jreg.get_config(arch), SHAPES[shape_name])
    got = specs.input_specs(preg.get_config(arch), SHAPES[shape_name])

    def flat(t, f):
        return {k: flat(v, f) if isinstance(v, dict) else f(v)
                for k, v in t.items()}

    assert flat(got, lambda t: (tuple(t.shape), _dtype(t))) == flat(
        want, lambda a: (tuple(a.shape), np.dtype(a.dtype).name))
    assert all(t.device.type == "meta"
               for t in torch.utils._pytree.tree_leaves(got))


# ---------------------------------------------------------------- specs

@pytest.mark.parametrize("mesh", [MESH, POD_MESH], ids=["16x16", "2x16x16"])
def test_input_shardings_equal_the_reference_on_fabricated_meshes(
        mesh, monkeypatch):
    """Every leaf's spec of every cell through both packages' rules (the
    reference's ``NamedSharding`` replaced by its bare spec)."""
    monkeypatch.setattr(jspecs, "NamedSharding", lambda m, spec: spec)

    def flat(t):
        if isinstance(t, dict):
            return {k: flat(v) for k, v in t.items()}
        return tuple(t)

    for arch, shape_name in CELLS:
        jcfg, pcfg = jreg.get_config(arch), preg.get_config(arch)
        shape = SHAPES[shape_name]
        want = jspecs.input_shardings(
            mesh, jcfg, shape, jspecs.input_specs(jcfg, shape))
        got = specs.input_shardings(mesh, pcfg, shape,
                                    specs.input_specs(pcfg, shape))
        assert flat(got) == flat(want), (arch, shape_name)


def test_input_shardings_equal_the_reference_on_a_2x4_mesh(reference):
    """The reference's own ``input_shardings`` on eight XLA devices."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros((2, 4)))

    def flat(t):
        if isinstance(t, dict):
            return {k: flat(v) for k, v in t.items()}
        return _tuple(t)

    for arch, shape_name in CELLS:
        cfg, shape = preg.get_config(arch), SHAPES[shape_name]
        got = specs.input_shardings(mesh, cfg, shape,
                                    specs.input_specs(cfg, shape))
        assert flat(got) == flat(reference["cells"][f"{arch}|{shape_name}"]
                                 ), (arch, shape_name)


def test_shard_places_each_rank_as_the_reference(reference):
    """``shard(x, "batch", "model")`` on a 2 x 2 x 2 fake mesh: each rank's
    shard is the one JAX's ``P(("pod", "data"), "model")`` gives the
    device at its position (the axes that share a dim split it major to
    minor)."""
    x = torch.arange(32.0).reshape(8, 4)
    for rank, want in enumerate(reference["shards"]):
        with pmesh.fake_world(8, rank=rank):
            mesh = pmesh.make_mesh((2, 2, 2), ("pod", "data", "model"))
            with psh.use_mesh(mesh):
                d = psh.shard(x, "batch", "model")
        (r0, r1), (c0, c1) = want
        assert torch.equal(d.to_local(), x[r0:r1, c0:c1]), rank
    assert not torch.distributed.is_initialized()


def test_placements_refuse_axes_out_of_mesh_order():
    with pytest.raises(ValueError, match="mesh's order"):
        psh.placements(POD_MESH, (("data", "pod"), None))


# ----------------------------------------------------- collective counter

def test_collective_counter_counts_operand_bytes():
    """A known DTensor program on a 4-rank fake mesh: its all-gather,
    all-reduce and reduce-scatter each counted once, at their operand's
    bytes (``tests/test_launch.py::test_collective_parser``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (
        DTensor, Partial, Replicate, Shard, distribute_tensor)

    f = 16 * 128 * 4
    with pmesh.fake_world(4):
        mesh = pmesh.make_mesh((4,), ("data",))
        fake = FakeTensorMode()
        with fake:
            x = distribute_tensor(torch.empty(64, 128), mesh, [Shard(0)],
                                  src_data_rank=None)
            p = DTensor.from_local(torch.empty(16, 128), mesh, [Partial()],
                                   run_check=False)
            rec = hlo_analysis.Recorder(fake)
            with rec:
                x.redistribute(mesh, [Replicate()])
                p.redistribute(mesh, [Replicate()])
                DTensor.from_local(torch.empty(64, 128), mesh, [Partial()],
                                   run_check=False).redistribute(
                    mesh, [Shard(0)])
    res = hlo_analysis.collective_bytes(rec.rows)
    assert res["by_op"] == {"all-gather": f, "all-reduce": f,
                            "reduce-scatter": 4 * f}
    assert res["by_op_count"] == {"all-gather": 1, "all-reduce": 1,
                                  "reduce-scatter": 1}
    assert res["count"] == 3 and res["total"] == 6 * f


def test_collective_counter_ignores_compute():
    """A product of replicated DTensors is no collective, and its FLOPs
    are the local product's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, distribute_tensor

    with pmesh.fake_world(4):
        mesh = pmesh.make_mesh((4,), ("data",))
        fake = FakeTensorMode()
        with fake:
            a = distribute_tensor(torch.empty(8, 8), mesh, [Replicate()],
                                  src_data_rank=None)
            rec = hlo_analysis.Recorder(fake)
            with rec:
                a @ a
    assert hlo_analysis.collective_bytes(rec.rows)["total"] == 0
    assert rec.flops == 2 * 8 * 8 * 8


# ---------------------------------------------------------------- report

def _records():
    rl = roofline.roofline_terms(3e12, 5e12, 2e9, precision="bf16")
    ok = {"arch": "hymba-1.5b", "shape": "train_4k", "mesh": "16x16",
          "devices": 256, "status": "ok", "compile_s": 66.8,
          "memory_analysis": {"argument_bytes": 25_000_000_000,
                              "temp_bytes": 3_500_000_000},
          "collective_raw": {"count": 175}, "roofline": rl,
          "useful_flops_ratio": 0.6831}
    return [ok,
            dict(ok, mesh="2x16x16", devices=512, compile_s=70.25),
            {"arch": "qwen3-moe-235b-a22b", "shape": "long_500k",
             "mesh": "16x16", "status": "skip",
             "reason": "pure full-attention arch: 500k decode needs a "
                       "quadratic-cost prefill to build its state"},
            {"arch": "deepseek-moe-16b", "shape": "decode_32k",
             "mesh": "16x16", "status": "error", "error": "boom"},
            dict(ok, arch="seamless-m4t-medium",
                 roofline=roofline.roofline_terms(9e13, 1e12, 0.0,
                                                  precision="bf16"))]


def test_report_tables_are_the_reference_tables(tmp_path):
    recs = _records()
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs + recs[:1]))
    assert report.load(path) == jreport.load(path)
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    for b in (0, 1023, 1024, 5e9, -3e15):
        assert report.fmt_bytes(b) == jreport.fmt_bytes(b)


# ------------------------------------------------------------------ perf

def _reference_settings() -> dict:
    """{setting: (flag, parser)} as the reference's ``apply_flags`` reads
    them (its source, not imported: importing it sets XLA_FLAGS)."""
    src = open(os.path.join(REPO, "src", "repro", "launch",
                            "perf.py")).read()
    found = re.findall(
        r'if "(\w+)" in settings:\s+flags\.(\w+) = ((?:\w+\()*)settings',
        src)
    return {k: (f, p.split("(")[0] or "str") for k, f, p in found}


@pytest.fixture
def restore_flags():
    saved = {k: v for k, v in vars(pflags).items() if k.isupper()}
    yield
    for k, v in saved.items():
        setattr(pflags, k, v)


def test_apply_flags_covers_every_reference_key(restore_flags):
    ref = _reference_settings()
    assert len(ref) == 13 and "cache_carry" in ref
    values = {"int": "512", "float": "1.5", "str": "dots"}
    for key, (flag, parse) in ref.items():
        if key == "cache_carry":
            continue
        raw = "1" if parse == "bool" else values[parse]
        perf.apply_flags({key: raw})
        want = {"int": int, "float": float, "str": str,
                "bool": lambda v: bool(int(v))}[parse](raw)
        assert getattr(pflags, flag) == want, key


def test_apply_flags_refuses_cache_carry_and_unknown_keys(restore_flags):
    with pytest.raises(ValueError, match="DECODE_CACHE_CARRY"):
        perf.apply_flags({"cache_carry": "1"})
    with pytest.raises(ValueError, match="unknown settings"):
        perf.apply_flags({"blockwise": "1024"})


# ------------------------------------------------------ the tuner profile

@pytest.fixture
def clean_autotune():
    autotune.clear()
    was_enabled, was_path = autotune.enabled(), autotune.cache_path()
    yield
    autotune.clear()
    autotune.enable(was_enabled)
    autotune.set_cache_path(was_path)


def test_committed_profile_loads_and_is_consulted(clean_autotune):
    """The H100 profile round-trips with no timing and no load anomaly
    (``tests/test_precision.py::test_committed_profile_loads_and_is_
    consulted``); every key names ``cuda-sm_90`` and every value is one of
    the port's candidates for its kind and shape."""
    data = json.load(open(PROFILE))
    assert data["version"] == 1 and data["entries"]
    autotune.set_cache_path(PROFILE)
    autotune.enable(True)
    n_events = len(autotune.events())
    timed = []

    def bench_factory(blocks):
        return lambda: timed.append(dict(blocks))

    for key, entry in data["entries"].items():
        kind, backend, b, m, k, n, prec = key.split("|")
        assert backend == "cuda-sm_90", key
        shape = dict(b=int(b[1:]), m=int(m[1:]), k=int(k[1:]),
                     n=int(n[1:]), precision=prec)
        assert entry in autotune.candidates(kind, **shape), key
        got = autotune.get_blocks(kind, bench_factory, backend=backend,
                                  **shape)
        assert got == entry, key
    assert timed == [], "profile hits must not re-time candidates"
    assert autotune.events()[n_events:] == []


# --------------------------------------------------------- roofline.main

def test_roofline_main_writes_the_envelope(tmp_path, capsys):
    rows = [{"s": 64_000, "n": 28, "k": 25, "precision": prec,
             "batch": batch, "lloyd_iters_per_chunk": 3.0,
             "chunks_per_s": 500.0}
            for prec in ("f32", "int8", "bf16", "bf16x3") for batch in (1, 8)]
    bench = tmp_path / "rates.json"
    bench.write_text(json.dumps({"rows": rows}))
    out = tmp_path / "roofline.json"
    roofline.main(["--bench", str(bench), "--out", str(out),
                   "--device", "cpu"])
    doc = json.loads(out.read_text())
    schema.check(doc, schema.ENVELOPE_SCHEMA)
    assert doc["schema_version"] == "repro.bench/1"
    assert doc["bench"] == "precision_roofline"
    assert doc["host"]["device"] == "cpu"
    assert doc["hbm_bw"] == roofline.HBM_BW
    assert doc["peak_flops"] == roofline.PEAK_FLOPS
    want = [roofline.precision_roofline(r) for r in rows]
    assert [{k: r[k] for k in w} for r, w in zip(doc["rows"], want)] == want
    int8 = next(r for r in doc["rows"]
                if r["precision"] == "int8" and r["batch"] == 1)
    assert int8["bytes_ratio_vs_f32"] < 0.3
    assert "wrote" in capsys.readouterr().out


def test_roofline_main_requires_the_rates():
    with pytest.raises(SystemExit):
        roofline.main([])
