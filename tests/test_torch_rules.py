"""Ground rules of the port: what it imports, where it runs, what it
refuses."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api, device as devices
from repro_torch.kernels import ops
from repro_torch.kernels import precision as px

ROOT = Path(__file__).resolve().parents[1]
X = np.random.default_rng(0).normal(size=(600, 5)).astype(np.float32)


def test_port_imports_neither_jax_nor_repro():
    pkg = ROOT / "src" / "repro_torch"
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py"))
    modules = [m.removesuffix(".__init__") for m in modules]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(modules) >= 20
    for new in ("repro_torch.evalsuite", "repro_torch.evalsuite.suite",
                "repro_torch.evalsuite.hostcell", "repro_torch.configs",
                "repro_torch.configs.bigmeans_paper",
                "repro_torch.launch.roofline"):
        assert new in modules, new


def test_scripts_import_neither_jax_nor_repro():
    """``chip_smoke.py`` and ``tools/*.py`` run on the card's machine,
    which has no JAX: no import of ``jax`` or ``repro`` anywhere in them."""
    import ast

    scripts = [ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("*.py"))]
    for path in scripts:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "repro"), \
                    (path.name, name)
    assert len(scripts) >= 2


def test_no_card_means_no_run(monkeypatch):
    """Without a CUDA device and without device='cpu' the entry points
    raise; they never move to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = api.BigMeansConfig(k=3, s=100, n_chunks=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.fit(X, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.fit(X, cfg, batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.evaluate(np.zeros((3, 5), np.float32), X)
    from repro_torch.core import big_means, big_means_batched

    with pytest.raises(RuntimeError, match="no CUDA device"):
        big_means(X, 0, k=3, s=100, n_chunks=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        big_means_batched(X, 0, k=3, s=100, batch=2, rounds=1)
    from repro_torch.evalsuite import datasets, hostcell, schema, suite

    with pytest.raises(RuntimeError, match="no CUDA device"):
        suite.run_suite("quick", seeds=(0,), dataset_names=["hepmass-16k"],
                        method_names=["bm/sequential"])
    host_cell = next(m for m in suite.METHODS if m.runner == "host2p")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hostcell.run_cell(datasets.get_dataset("hepmass-16k"), host_cell, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        schema.host_info()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.resolved_impl()
    assert devices.resolve("cpu") == torch.device("cpu")


def test_cuda_impl_refuses_cpu_tensors():
    x, c = torch.from_numpy(X), torch.from_numpy(X[:4])
    for call in (lambda: ops.assign(x, c, impl="cuda"),
                 lambda: ops.update(x, torch.zeros(600, dtype=torch.int32),
                                    4, impl="cuda"),
                 lambda: ops.fused_step(x, c, impl="cuda")):
        with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
            call()
    cfg = api.BigMeansConfig(k=3, s=100, n_chunks=2, impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        api.fit(X, cfg, device="cpu")
    assert ops.resolve_impl("auto", torch.device("cpu")) == "ref"
    with pytest.raises(ValueError, match="unknown impl"):
        ops.resolve_impl("pallas", torch.device("cpu"))


@pytest.mark.parametrize("knob", [
    dict(batch=2, topology="stream_mesh"), dict(topology="worker_mesh"),
    dict(mesh=("data", 2)), dict(method="sharded")],
    ids=["stream_mesh", "worker_mesh", "mesh", "sharded"])
def test_multi_device_knobs_are_ported(knob):
    """The multi-device knobs validate and run on the CPU: a stream mesh
    sends ``batch > 1`` to ``batched``, a worker mesh and the deprecated raw
    ``mesh`` (a ``DeviceMesh``, with its warning) send an in-core array to
    ``sharded``, as the reference's auto does, and ``method="sharded"``
    runs a worker per local device."""
    from repro_torch.engine import topology as topo

    knob = dict(knob)
    method = knob.pop("method", "auto")
    if "mesh" in knob:
        axis, size = knob["mesh"]
        knob["mesh"] = topo.make_mesh((size,), (axis,), "cpu")
        with pytest.warns(DeprecationWarning, match="topology"):
            cfg = api.BigMeansConfig(k=3, s=100, n_chunks=2, **knob)
    else:
        cfg = api.BigMeansConfig(k=3, s=100, n_chunks=2, **knob)
    res = api.fit(X, cfg, method=method, device="cpu")
    assert np.isfinite(res.objective) and res.n_chunks == 2
    want = "batched" if cfg.batch > 1 else "sharded"
    assert res.strategy == want
    if want == "sharded":
        assert res.extras["workers"] == (2 if cfg.mesh is not None else 1)
        assert res.extras["chunks_per_worker"] * res.extras["workers"] == 2


@pytest.mark.parametrize("knob", [
    dict(time_budget_s=60.0), dict(vns_ladder=(200,), vns_patience=1),
    dict(scheduler="worker"), dict(batch=2, scheduler="competitive_s",
                                   competitive_ladder=(150, 300))],
    ids=["time_budget_s", "vns_ladder", "worker", "competitive_s"])
def test_middleware_knobs_are_ported(knob):
    """time_budget_s, vns_ladder and the worker and competitive_s
    schedulers validate and run on the CPU; the runner-only ones send an
    in-core array to the streaming strategy, as the reference's auto does."""
    cfg = api.BigMeansConfig(k=3, s=300, n_chunks=4, **knob)
    res = api.fit(X, cfg, device="cpu")
    assert res.n_chunks == 4 and np.isfinite(res.objective)
    want = "sequential" if knob == dict(scheduler="worker") else "streaming"
    assert res.strategy == want and res.extras["auto"]
    assert api.fit(X, api.BigMeansConfig(k=3, s=300, n_chunks=4),
                   device="cpu", **knob).config == cfg


def test_checkpoint_knobs_are_ported(tmp_path):
    """ckpt_dir, ckpt_every and resume validate and run on the CPU: the
    checkpoints send an in-core array to the streaming strategy, as the
    reference's auto does, and a second fit resumes from the first."""
    d = str(tmp_path)
    cfg = api.BigMeansConfig(k=3, s=300, n_chunks=4, ckpt_dir=d,
                             ckpt_every=2)
    res = api.fit(X, cfg, device="cpu")
    assert res.strategy == "streaming" and res.extras["auto"]
    assert res.n_chunks == 4 and res.checkpoint_dir == d
    assert sorted(os.listdir(d)) == ["step_000000000002",
                                     "step_000000000004"]
    again = api.fit(X, cfg.replace(n_chunks=6), device="cpu")
    assert again.n_chunks == 2 and np.isfinite(again.objective)
    fresh = api.fit(X, cfg.replace(n_chunks=6, resume=False), device="cpu")
    assert fresh.n_chunks == 6


def test_autotune_is_ported():
    """autotune=True validates as a config field and as a fit override, and
    the fit runs and reports it (on the CPU there is nothing to tune)."""
    cfg = api.BigMeansConfig(k=3, s=100, n_chunks=2, autotune=True)
    assert cfg.autotune is True
    res = api.fit(X, cfg, device="cpu")
    assert res.extras["fit"]["autotune"] is True
    base = api.BigMeansConfig(k=3, s=100, n_chunks=2)
    assert api.fit(X, base, device="cpu", autotune=True
                   ).extras["fit"]["autotune"] is True


def test_int8_precision_is_ported():
    """precision="int8" validates as a config field and as a fit override,
    and the fit reports the resolved policy ('auto' on the f32 dataset is
    'f32')."""
    cfg = api.BigMeansConfig(k=3, s=100, n_chunks=2, precision="int8")
    assert cfg.precision == "int8"
    assert api.fit(X, cfg, device="cpu").extras["fit"]["precision"] == "int8"
    base = api.BigMeansConfig(k=3, s=100, n_chunks=2)
    res = api.fit(X, base, device="cpu", precision="int8")
    assert res.extras["fit"]["precision"] == "int8"
    assert api.fit(X, base, device="cpu").extras["fit"]["precision"] == "f32"


@pytest.mark.parametrize("precision", ["bf16", "bf16x3"])
def test_bf16_precisions_are_ported(precision):
    """precision="bf16" / "bf16x3" validate as a config field and as a fit
    override, and a bf16 tensor under 'auto' fits at bf16, its dataset kept
    in bf16."""
    from repro_torch.engine import incore

    cfg = api.BigMeansConfig(k=3, s=100, n_chunks=2, precision=precision)
    assert cfg.precision == precision
    res = api.fit(X, cfg, device="cpu")
    assert res.extras["fit"]["precision"] == precision
    base = api.BigMeansConfig(k=3, s=100, n_chunks=2)
    assert api.fit(X, base, device="cpu", precision=precision
                   ).extras["fit"]["precision"] == precision
    xb = torch.from_numpy(X).bfloat16()
    auto = api.fit(xb, base, device="cpu")
    assert auto.extras["fit"]["precision"] == "bf16"
    assert api.ArraySource(xb).data_dtype == torch.bfloat16
    want = torch.bfloat16 if precision == "bf16" else torch.float32
    for data in (X, xb):
        assert incore._cast_dataset(data, precision, torch.device("cpu")
                                    ).dtype == want
    assert incore._cast_dataset(xb, "auto", torch.device("cpu")
                                ).dtype == torch.bfloat16
    # a bf16 tensor at 'auto' is the f32 data fitted at 'bf16', bit for bit
    same = api.fit(X, base, device="cpu", precision="bf16")
    assert torch.equal(auto.centroids, same.centroids)
    assert auto.trace == same.trace


def test_unported_inputs_raise():
    cfg = api.BigMeansConfig(k=3, s=100, n_chunks=2)
    with pytest.raises(KeyError):
        api.fit(X, cfg, method="nope", device="cpu")


def test_config_validation_follows_reference():
    import repro.api as japi

    bad = [dict(k=0, s=10), dict(k=5, s=4), dict(k=3, s=10, tol=-1.0),
           dict(k=3, s=10, impl="nope"), dict(k=3, s=10, precision="fp8"),
           dict(k=3, s=10, sync="sometimes"),
           dict(k=3, s=10, scheduler="nope"),
           dict(k=3, s=10, topology="ring"),
           dict(k=3, s=10, scheduler="competitive_s")]
    for kw in bad:
        with pytest.raises(ValueError):
            japi.BigMeansConfig(**kw)
        with pytest.raises(ValueError):
            api.BigMeansConfig(**kw)
    a = api.BigMeansConfig(k=3, s=10)
    b = japi.BigMeansConfig(k=3, s=10)
    for f in ("n_chunks", "max_iters", "tol", "candidates", "seed",
              "with_replacement", "precision", "batch", "prefetch"):
        assert getattr(a, f) == getattr(b, f), f
    assert px.resolve("auto", torch.float32) == "f32"
    assert px.resolve("auto", torch.float64) == "f32"
