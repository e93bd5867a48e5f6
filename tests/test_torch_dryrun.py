"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: its
counts are rank 0's local work, they scale with depth as the reference's
correction assumes, on a one-rank mesh they are ``FlopCounterMode``'s count
of the real step, and its records, skip, exit code and per-op profile are
the reference's.

Counts run on fake tensors over a fake process group (``launch.mesh.
fake_world``), torn down after each; the configs are the reduced ones
except where a record of a published cell is read.
"""
import dataclasses
import json
import os
import re

import pytest
import torch
import torch.distributed as dist

from repro.launch import roofline as jroofline
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun, hlo_analysis, hlo_profile, mesh
from repro_torch.launch import roofline
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.train import optimizer, sharding as sh, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ShapeSpec("t", "train", 32, 4)
ONE = ((1, 1), ("data", "model"))
TWO = ((2, 2), ("data", "model"))
# the keys the reference's run_cell writes for a single-pod LM cell (its
# corrected terms and their compile time have no counterpart: no
# correction exists here)
KEYS = {"arch", "shape", "mesh", "devices", "status", "memory_analysis",
        "compile_s", "raw_flops_per_device", "raw_bytes_per_device",
        "collective_raw", "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "roofline", "model_flops_global",
        "useful_flops_ratio"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "code_bytes"}


def _mlp_flops(cfg, dims) -> int:
    """Rank 0's FLOPs of one gated MLP on a [4, 8, D] batch, its weights
    placed by the rules (D over the data axis, F over the model axis)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with mesh.fake_world(dims[0] * dims[1]):
        m = mesh.make_mesh(dims, ("data", "model"))
        fake = FakeTensorMode()
        with fake, sh.use_mesh(m):
            view = sh.MeshView(m)
            p = L.init_mlp(cfg, None, device="meta", dtype=torch.float32)
            sh.place_params(p, view, lambda t: torch.empty(tuple(t.shape)))
            x = sh.place(torch.empty(4, 8, cfg.d_model), view,
                         sh.spec(view, "batch", None, None))
            rec = hlo_analysis.Recorder(fake)
            with rec:
                L.mlp(cfg, p, x)
    assert not dist.is_initialized()
    return rec.flops


def test_flops_are_rank_local():
    """A layer split four ways (batch over data, the hidden over model)
    counts a quarter of its one-rank FLOPs on a (2, 2) mesh, not the
    global work as ``FlopCounterMode`` on DTensors does."""
    cfg = registry.get_config("hymba-1.5b").reduced()
    one = _mlp_flops(cfg, (1, 1))
    assert one == 3 * 2 * 4 * 8 * cfg.d_model * cfg.d_ff
    assert _mlp_flops(cfg, (2, 2)) * 4 == one


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen3-moe-235b-a22b"])
def test_one_rank_count_is_the_flop_counters_count_of_the_real_step(arch):
    """On a 1 x 1 mesh the dry run's FLOPs are ``FlopCounterMode``'s count
    of the same train step run on real tensors (``chip_smoke.py`` 16b holds
    this on the card at hymba's full width)."""
    cfg = registry.get_config(arch).reduced()
    cost = dryrun.count_step(cfg, TRAIN, mesh_shape=ONE)
    model = T.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN.global_batch,
                                               TRAIN.seq_len),
                           generator=gen, dtype=torch.int32)
    opt = optimizer.adamw(optimizer.warmup_cosine(3e-4, 2000, 100_000))
    step = train_step.make_train_step(cfg, opt)
    with hlo_analysis.flop_counter() as counter:
        step(model, opt.init(model), {"tokens": tokens, "labels": tokens})
    assert cost["flops"] == counter.get_total_flops() > 0


def test_counts_are_linear_in_depth(monkeypatch):
    """The full-depth count equals the linear extrapolation from 2 and 4
    layers (the reference's assumption, ``dryrun.py:139-150``): FLOPs,
    bytes and collective bytes on a (2, 2) mesh, at a reduced deepseek of
    5 layers (no remat: the recomputation is linear in depth too)."""
    from repro_torch.models import flags

    monkeypatch.setattr(flags, "REMAT_POLICY", None)
    base = registry.get_config("deepseek-moe-16b").reduced()
    shape = ShapeSpec("t", "train", 16, 4)
    c = {n: dryrun.count_step(dataclasses.replace(base, num_layers=n),
                              shape, mesh_shape=TWO) for n in (2, 4, 5)}
    for key in ("flops", "bytes", "coll"):
        assert 2 * c[5][key] == 2 * c[2][key] + 3 * (c[4][key] - c[2][key])
        assert c[4][key] > c[2][key], key


def test_run_cell_record_has_the_references_keys():
    rec = dryrun.run_cell("seamless-m4t-medium", "decode_32k", False)
    assert rec["status"] == "ok" and set(rec) == KEYS
    assert rec["mesh"] == "16x16" and rec["devices"] == 256
    assert set(rec["memory_analysis"]) == MEMORY
    assert set(rec["roofline"]) == set(jroofline.roofline_terms(1.0, 1.0,
                                                                1.0))
    assert set(rec["collective_raw"]) == {"total", "count", "by_op",
                                          "by_op_count"}
    assert rec["flops_per_device"] == rec["raw_flops_per_device"] > 0
    assert rec["collective_raw"]["count"] > 0
    assert rec["roofline"] == roofline.roofline_terms(
        rec["flops_per_device"], rec["bytes_per_device"],
        rec["collective_bytes_per_device"], precision="bf16")
    assert rec["memory_analysis"]["temp_bytes"] > 0
    assert not dist.is_initialized()


def test_cluster_cell_is_modeled():
    """``bigmeans_paper``: 10 passes a chunk of ``chunk_traffic``, 4
    chunks a worker, the exchange's all-gathers once a window."""
    rec = dryrun.run_cell("bigmeans_paper", "cluster", False)
    cfg = registry.get_config("bigmeans_paper")
    t = roofline.chunk_traffic(cfg.s, cfg.n_features, cfg.k, "f32", 10)
    assert rec["status"] == "ok" and set(rec) == KEYS - {
        "model_flops_global", "useful_flops_ratio"}
    assert rec["flops_per_device"] == 4 * t["flops"]
    assert rec["bytes_per_device"] == 4 * t["bytes"]
    windows = cfg.chunks_per_worker // cfg.sync_every
    assert rec["collective_raw"]["by_op_count"] == {"all-gather":
                                                    3 * windows}
    assert rec["collective_bytes_per_device"] == windows * (
        4 + 4 * cfg.k * cfg.n_features + cfg.k)


def test_long_500k_skip_holds():
    src = open(os.path.join(REPO, "src", "repro", "launch",
                            "dryrun.py")).read()
    start = src.index('record["reason"] =')
    reason = "".join(re.findall(r'"([^"]*)"', src[
        start + len('record["reason"] ='):src.index("return record",
                                                    start)]))
    for arch in registry.LM_ARCHS:
        cfg = registry.get_config(arch)
        if cfg.sub_quadratic:
            continue
        rec = dryrun.run_cell(arch, "long_500k", False)
        assert rec["status"] == "skip" and rec["reason"] == reason


def test_main_exits_1_on_an_error(monkeypatch, tmp_path, capsys):
    def boom(*a, **k):
        raise RuntimeError("no strategy")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    out = tmp_path / "dr.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "hymba-1.5b", "--shape", "decode_32k",
                     "--json", str(out)])
    assert e.value.code == 1
    rec = json.loads(out.read_text())
    assert rec["status"] == "error" and "no strategy" in rec["error"]
    assert "1 error" in capsys.readouterr().out


def test_fake_worlds_are_torn_down_and_not_nested():
    with mesh.fake_world(4):
        with pytest.raises(RuntimeError, match="already initialized"):
            with mesh.fake_world(4):
                pass
        with pytest.raises(RuntimeError, match="needs a world of 8"):
            mesh.make_mesh((2, 4), ("data", "model"))
        m = mesh.make_mesh((2, 2), ("data", "model"))
        assert tuple(m.shape) == (2, 2)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        mesh.make_host_mesh()


def test_profile_groups_the_recorded_ops():
    """``hlo_profile.profile``: operand + result bytes by op, the top ops
    by bytes, in the reference's (summary, top_rows) shape."""
    cfg = registry.get_config("deepseek-moe-16b").reduced()
    cost = dryrun.count_step(cfg, ShapeSpec("p", "prefill", 32, 4),
                             mesh_shape=TWO)
    summary, top = hlo_profile.profile(cost["rows"], top=5)
    rows = cost["rows"]
    assert sum(b for _, (b, _) in summary) == sum(
        r.in_bytes + r.out_bytes for r in rows)
    assert sum(c for _, (_, c) in summary) == len(rows)
    assert [b for _, _, b, _ in top] == sorted(
        (r.in_bytes + r.out_bytes for r in rows), reverse=True)[:5]
    assert {op for op, _ in summary} >= {"aten.bmm", "all_reduce"}
