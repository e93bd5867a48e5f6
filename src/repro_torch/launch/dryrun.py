"""The dry run: one step of every (arch x shape) cell on the production
mesh, counted and never executed, the reference's ``repro.launch.dryrun``.

The reference lowers and compiles each cell's step for 256 or 512
placeholder XLA devices and reads XLA's cost and memory analyses.  Here:

* the mesh is a ``DeviceMesh`` over a fake process group of 256 or 512
  ranks (``launch.mesh.fake_world``), this process rank 0;
* the parameters, the optimizer state, the batch and the cache are
  DTensors of fake tensors (``FakeTensorMode``: shapes, no storage), placed
  by the sharding rules (``train.sharding.param_shardings``,
  ``launch.specs``);
* the step (``make_train_step``, ``make_prefill_step``,
  ``make_serve_step``) is dispatched once, with the activations placed by
  ``sharding.shard`` as the model code asks, under
  ``hlo_analysis.Recorder``: rank 0's local FLOPs (the products, by
  ``torch.utils.flop_counter``'s registry), the bytes of every op it
  dispatches (operands plus results, views excluded, with no fusion: an
  upper bound on what a fused program moves), the collectives DTensor
  issues (operand bytes) and the most bytes it holds at once.

The record keys are the reference's.  ``compile_s`` is the dispatch's
seconds; ``memory_analysis`` holds rank 0's ``argument_bytes`` (its shards
of the step's inputs), ``output_bytes`` (results that are not inputs
updated in place), ``alias_bytes`` (inputs updated in place and returned:
the train step's parameters and moments, the decode cache), ``temp_bytes``
(the most it held at once beyond the arguments) and ``code_bytes`` (0: no
program is generated).  The reference's ``_unrolled_costs`` correction has
no counterpart: its cost analysis visits a scanned layer once, while every
layer here is dispatched (``models.flags`` says why ``UNROLL_SCAN`` is
absent), so ``raw_*`` and the corrected terms are the same counts.  The
roofline prices the LM cells at the H100's bf16 peak, the cluster cell
at f32's (``launch.roofline``), and the collective term at NVLink's
900 GB/s, though a 256-card mesh spans nodes.

Regions DTensor has no sharding strategy for (or, on some torch
versions, a failing one) run on each rank's shards
(``train.sharding.on_shards``, over ``local_map``), and so set the
collectives counted: the inputs are redistributed to the region's
placements first (an all-gather where it holds a split input whole) and
its partial results are summed after.  They are: the weight projections
(``sharding.project``: FSDP axes gathered, the model-axis split kept, a
split contraction a partial sum), attention (batch rows and query heads;
each query head reads its own KV head), the decode step's attention and
cache write (on the cache's shards; a split sequence combined
flash-decoding style by all-reduces of the row max and the rescaled
sums), the SSD mixer and its decode (batch rows, its small parameters
whole, so replicated over the model axis), the routed MoE experts (batch
rows, one group a batch shard, and the rank's experts: a partial sum
over the expert axis) and the embedding lookup (vocabulary parallel, a
partial sum over the model axis).  The decode step's argmax reads whole
vocabulary rows (an all-gather of the logits over the model axis).

The cluster cell (``bigmeans_paper``) is modeled, not dispatched: the
port's kernels do not run on fake tensors and its Lloyd loop reads the
host.  :func:`build_bigmeans` counts it with ``roofline.chunk_traffic`` at
``max_iters`` + 2 = 10 passes a chunk, ``chunks_per_worker`` chunks a
worker, the rows padded to the worker grid, X in bf16 under
``flags.CLUSTER_BF16``, and the all-gathers of the keep-the-best exchange
(``f_best``, the centroids, the degenerate mask) once a window
(``engine.incore.worker_sharded_rounds``).  The reference's cost analysis
counts that loop's body once.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba-1.5b \\
        --shape decode_32k
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback

import torch
from torch import nn

from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import hlo_analysis, roofline, specs
from repro_torch.launch.mesh import fake_world, make_mesh, production_shape
from repro_torch.models import flags
from repro_torch.models import transformer as T
from repro_torch.models.registry import LM_ARCHS, get_config
from repro_torch.train import sharding as sh
from repro_torch.train.optimizer import adamw, warmup_cosine
from repro_torch.train.train_step import (
    make_prefill_step, make_serve_step, make_train_step)

MAX_ITERS = 8      # the cluster cell's bounded per-chunk Lloyd budget


def _placed(t: torch.Tensor, mesh, spec: tuple, device_type: str):
    """A fake tensor of ``t``'s shape and dtype on ``device_type``, placed
    on ``mesh`` by ``spec`` (call under the cell's ``FakeTensorMode``)."""
    return sh.place(torch.empty(tuple(t.shape), dtype=t.dtype,
                                device=device_type), mesh, spec)


def _placed_tree(tree, mesh, spec_tree, device_type: str):
    if isinstance(tree, dict):
        return {k: _placed_tree(v, mesh, spec_tree[k], device_type)
                for k, v in tree.items()}
    return _placed(tree, mesh, spec_tree, device_type)


def _local_leaves(tree) -> list:
    from torch.distributed.tensor import DTensor

    out = []
    for leaf in torch.utils._pytree.tree_leaves(tree):
        if isinstance(leaf, nn.Module):
            out.extend(_local_leaves(list(leaf.parameters())))
        elif isinstance(leaf, DTensor):
            out.append(leaf.to_local())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def build_lowerable(cfg, shape, mesh, device_type: str):
    """(fn, args, out_specs) for one LM cell, the args DTensors on
    ``mesh`` (a ``MeshView``); call under the cell's ``FakeTensorMode``.
    ``out_specs`` places the step's results, as the reference's
    ``out_shardings``.  AdamW's moments are placed as the parameters
    (``opt.init`` makes them alike), the reference's
    ``opt_state_shardings``; the arguments the reference donates are the
    ones the port's steps update in place."""
    sp = specs.input_specs(cfg, shape)
    in_sh = specs.input_shardings(mesh, cfg, shape, sp)
    B, V = shape.global_batch, cfg.vocab_size

    def fake(p):
        return torch.empty(tuple(p.shape), dtype=p.dtype, device=device_type)

    if shape.kind == "train":
        params = sh.place_params(T.abstract_params(cfg, torch.float32), mesh,
                                 fake)
        opt = adamw(warmup_cosine(3e-4, 2000, 100_000))
        opt_state = opt.init(params)
        batch = _placed_tree(sp, mesh, in_sh, device_type)
        fn = make_train_step(cfg, opt)
        out_specs = (None, None, {"loss": ()})
        return fn, (params, opt_state, batch), out_specs

    params = sh.place_params(T.abstract_params(cfg, torch.bfloat16), mesh,
                             fake)                    # serving: bf16
    logits_spec = sh.spec(mesh, "batch", "model", shape=(B, V))

    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, max_seq=shape.seq_len)
        cache_spec = T.abstract_cache(
            cfg, B, shape.seq_len,
            enc_len=cfg.frontend_len if cfg.cross_attention else None)
        args = [params, _placed(sp["tokens"], mesh, in_sh["tokens"],
                                device_type)]
        if cfg.frontend:
            args.append(_placed(sp["frontend"], mesh, in_sh["frontend"],
                                device_type))
        out_specs = (logits_spec, specs.cache_shardings(mesh, cache_spec))
        return fn, tuple(args), out_specs

    fn = make_serve_step(cfg)
    cache = _placed_tree(sp["cache"], mesh, in_sh["cache"], device_type)
    token = _placed(sp["token"], mesh,
                    sh.spec(mesh, "batch", None, shape=(B, 1)), device_type)
    out_specs = (sh.spec(mesh, "batch", shape=(B,)), logits_spec, None)
    # the position is a host int in the port's decode; the step's cost
    # does not depend on it (every cache slot is read, masked)
    return fn, (params, cache, token, shape.seq_len - 1), out_specs


def _place_outputs(out, out_specs, mesh):
    """The step's results placed by ``out_specs``: a spec, or a dict or
    tuple of them, one a result (None: left as they are)."""
    if out_specs is None:
        return out
    if isinstance(out_specs, dict):
        return {k: _place_outputs(v, out_specs.get(k), mesh)
                for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(_place_outputs(o, s, mesh)
                     for o, s in zip(out, out_specs))
    return sh.place(out, mesh, out_specs)


def _dispatch_and_count(cfg, shape, mesh, device_type: str) -> dict:
    """Dispatch one LM cell's step on fake DTensors; its counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    view = sh.MeshView(mesh)
    fake = FakeTensorMode(allow_non_fake_inputs=False)
    with fake, sh.use_mesh(mesh):
        fn, args, out_specs = build_lowerable(cfg, shape, view, device_type)
        arg_leaves = _local_leaves(args)
        rec = hlo_analysis.Recorder(fake)
        rec.mark_arguments(arg_leaves)
        t0 = time.perf_counter()
        with rec:
            out = fn(*args)
            out = _place_outputs(out, out_specs, view)
        dispatch_s = time.perf_counter() - t0
        arg_keys = {hlo_analysis.storage_key(t) for t in arg_leaves}
        out_leaves = _local_leaves(out)
        alias = sum(hlo_analysis.nbytes(t) for t in out_leaves
                    if hlo_analysis.storage_key(t) in arg_keys)
        output = sum(hlo_analysis.nbytes(t) for t in out_leaves
                     if hlo_analysis.storage_key(t) not in arg_keys)
    return {
        "flops": float(rec.flops),
        "bytes": float(rec.bytes),
        "coll": float(hlo_analysis.collective_bytes(rec.rows)["total"]),
        "coll_detail": hlo_analysis.collective_bytes(rec.rows),
        "rows": rec.rows,
        "dispatch_s": dispatch_s,
        "memory": {
            "argument_bytes": int(sum(map(hlo_analysis.nbytes,
                                          arg_leaves))),
            "output_bytes": int(output),
            "temp_bytes": int(rec.peak_bytes),
            "alias_bytes": int(alias),
            "code_bytes": 0,
        },
    }


def build_bigmeans(cfg, mesh_shape: tuple) -> dict:
    """The cluster cell's counts a worker (one worker a rank; see the
    module docstring)."""
    W = math.prod(mesh_shape)
    m = -(-cfg.m // W) * W                              # rows to the grid
    n, k, s = cfg.n_features, cfg.k, cfg.s
    precision = "bf16" if flags.CLUSTER_BF16 else "f32"
    itemsize = 2 if flags.CLUSTER_BF16 else 4
    t = roofline.chunk_traffic(s, n, k, precision, passes=MAX_ITERS + 2)
    chunks = cfg.chunks_per_worker
    windows = chunks // cfg.sync_every
    gather = {"f_best": 4, "centroids": 4 * k * n, "degenerate": k}
    coll = windows * sum(gather.values())
    state = 4 * k * n + k + 4 + 4 + 4            # centroids, mask, f, counts
    return {
        "flops": float(t["flops"] * chunks),
        "bytes": float(t["bytes"] * chunks),
        "coll": float(coll),
        "coll_detail": {"total": int(coll), "count": 3 * windows,
                        "by_op": {"all-gather": int(coll)},
                        "by_op_count": {"all-gather": 3 * windows}},
        "dispatch_s": 0.0,
        "memory": {
            "argument_bytes": int(m // W * n * itemsize + 8),
            "output_bytes": int(state),
            "temp_bytes": int(s * n * itemsize + 4 * s + 4 * s
                              + 2 * (4 * k * n + 4 * k) + W * 4 * k * n),
            "alias_bytes": 0,
            "code_bytes": 0,
        },
    }


def count_step(cfg, shape, *, multi_pod: bool = False, mesh_shape=None,
               device_type: str = "cpu") -> dict:
    """One LM cell's counts: ``cfg``'s step at ``shape`` dispatched on a
    fake world of the mesh's size (the production mesh, or ``mesh_shape``
    = ``(dims, axes)``)."""
    dims, axes = mesh_shape or production_shape(multi_pod)
    with fake_world(math.prod(dims)):
        mesh = make_mesh(dims, axes, device_type)
        return _dispatch_and_count(cfg, shape, mesh, device_type)


def cell(cfg, shape, *, multi_pod: bool = False, mesh_shape=None,
         device_type: str = "cpu", name: str | None = None) -> dict:
    """The record of ``cfg`` at ``shape`` (a ``ShapeSpec``; None for the
    cluster cell) on the production mesh or on ``mesh_shape``."""
    dims, _ = mesh_shape or production_shape(multi_pod)
    n_dev = math.prod(dims)
    record = {"arch": cfg.name, "shape": name or getattr(shape, "name",
                                                         "cluster"),
              "mesh": "x".join(map(str, dims)), "devices": int(n_dev),
              "status": "ok"}
    if cfg.family != "cluster" and shape.name == "long_500k" \
            and not cfg.sub_quadratic:
        record["status"] = "skip"
        record["reason"] = ("pure full-attention arch: 500k decode needs "
                            "a quadratic-cost prefill to build its state")
        return record

    if cfg.family == "cluster":
        raw = build_bigmeans(cfg, dims)
    else:
        raw = count_step(cfg, shape, multi_pod=multi_pod,
                         mesh_shape=mesh_shape, device_type=device_type)
    mem = dict(raw["memory"])
    # the reference's report reads the argument bytes as the mesh's total
    # (it divides them by the devices); every rank holds equal shards
    mem["argument_bytes"] *= n_dev
    record["memory_analysis"] = mem
    record.update({
        "compile_s": round(raw["dispatch_s"], 2),
        "raw_flops_per_device": raw["flops"],
        "raw_bytes_per_device": raw["bytes"],
        "collective_raw": raw["coll_detail"],
    })
    precision = "f32" if cfg.family == "cluster" and not flags.CLUSTER_BF16 \
        else "bf16"
    rl = roofline.roofline_terms(raw["flops"], raw["bytes"], raw["coll"],
                                 precision=precision)
    record.update({
        "flops_per_device": raw["flops"],
        "bytes_per_device": raw["bytes"],
        "collective_bytes_per_device": raw["coll"],
        "roofline": rl,
    })
    if cfg.family != "cluster":
        mf = roofline.model_flops(cfg, shape)
        record["model_flops_global"] = mf
        total = raw["flops"] * n_dev
        record["useful_flops_ratio"] = mf / total if total else 0.0
    return record


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             skip_correction: bool = False, *,
             device_type: str = "cpu") -> dict:
    """One cell's record, the reference's ``run_cell``.
    ``skip_correction`` is the reference's argument; no correction exists
    here (module docstring)."""
    del skip_correction
    cfg = get_config(arch)
    shape = None if cfg.family == "cluster" else SHAPES[shape_name]
    rec = cell(cfg, shape, multi_pod=multi_pod, device_type=device_type,
               name=shape_name)
    rec["arch"] = arch
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None,
                    help="arch id (default: all LM archs + bigmeans_paper)")
    ap.add_argument("--shape", default=None,
                    help="shape id (default: all four)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--device-type", choices=["cpu", "cuda"], default="cpu",
                    help="the fake tensors' and the mesh's device type")
    ap.add_argument("--json", default=None, help="append records to this file")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else LM_ARCHS + ["bigmeans_paper"]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]

    records = []
    for arch in archs:
        cfg = get_config(arch)
        if cfg.family == "cluster":
            shapes = ["cluster"]
        else:
            shapes = [args.shape] if args.shape else list(SHAPES)
        for shape_name in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                tag = f"{arch} x {shape_name} x {mesh_name}"
                try:
                    rec = run_cell(arch, shape_name, mp,
                                   device_type=args.device_type)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "error",
                           "error": repr(e),
                           "traceback": traceback.format_exc()[-2000:]}
                records.append(rec)
                status = rec["status"]
                extra = ""
                if status == "ok" and "roofline" in rec:
                    r = rec["roofline"]
                    extra = (f" dominant={r['dominant']}"
                             f" frac={r['roofline_fraction']:.3f}"
                             f" compile={rec['compile_s']:.1f}s")
                elif status == "error":
                    extra = f" {rec['error'][:300]}"
                print(f"[dryrun] {tag}: {status}{extra}", flush=True)
                if args.json:
                    with open(args.json, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    ok = sum(r["status"] == "ok" for r in records)
    skip = sum(r["status"] == "skip" for r in records)
    err = sum(r["status"] == "error" for r in records)
    print(f"[dryrun] done: {ok} ok, {skip} skip, {err} error")
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
