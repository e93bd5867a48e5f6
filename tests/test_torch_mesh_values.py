"""The model code's sharded regions on real tensors.

A world of four gloo processes on the CPU holds a (2, 2) ``("data",
"model")`` mesh.  Each LM arch's reduced config, its weights from one seed,
is placed by the parameter rules (``sharding.place_params``) and run
under ``sharding.use_mesh``; the same weights and inputs go through the
one-device path in the same process, which ``test_torch_models``,
``test_torch_train`` and ``test_torch_train_step`` hold to the reference.
Held here, the sharded against the one-device:

* the forward's logits (projections on weight shards, attention on head
  shards, the vocabulary-parallel lookup, SSD on row shards, the routed
  experts on expert shards);
* a prefill and four decode steps, the cache placed by the KV-cache rule:
  over the KV heads for seamless-m4t-medium and deepseek-moe-16b, over the
  sequence for hymba-1.5b and qwen3-moe-235b-a22b, whose one KV head does
  not divide the model axis (``flags.KV_SHARD_SEQ``; the decode's cache
  write and its flash-decoding combine); and the split decode again under
  ``flags.ATTN_BF16_SOFTMAX``;
* one train step: the loss, every gradient (the ``Partial`` placements of
  ``sharding.project`` and ``on_shards``) and AdamW's new parameters, these
  within the gap AdamW puts between the two paths' gradients
  (``step_check.step_gap_bound``).

Compute is f32 in both paths (``COMPUTE_DTYPE = float32``) so that a bf16
rounding cannot flip an MoE router's choice; the decode cache stays bf16.
Both paths slot the MoE tokens in two groups (``MOE_GROUPED_DISPATCH =
2``, the mesh's batch shards), so they drop the same tokens.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["hymba-1.5b", "seamless-m4t-medium", "deepseek-moe-16b",
         "qwen3-moe-235b-a22b"]
WORLD = 4
RTOL = 1e-4          # f32 compute: the shards' partial sums associate
#                      differently (~1e-6 of the largest value measured)
DECODE_RTOL = 2.0 ** -10   # the bf16 cache: a key or value whose f32 value
#                      differs in its last bits (a projection on a head
#                      shard) may round to the other bf16 neighbour, which
#                      moves the logits by a small fraction of a bf16 step
#                      (~5e-5 of the largest logit measured)
HYBRID_GRAD_RTOL = 0.1 * 2.0 ** -7   # hymba keeps the SSD's bf16 casts at
#                      f32 compute: an f32 value rounding to the other bf16
#                      neighbour moves the gradients behind it (held to a
#                      tenth of a bf16 step, as test_torch_train holds them
#                      to the reference; ~8e-5 of a leaf's scale measured)
BF16_RTOL = 2.0 ** -6      # ATTN_BF16_SOFTMAX: one path normalizes the bf16
#                      weights before their product with V, the split one
#                      after the combine (two bf16 steps)

_WORKER = r"""
import json, sys, traceback
import numpy as np
import torch
import torch.distributed as dist

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from torch.distributed.tensor import DTensor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import flags, layers, registry
from repro_torch.models import transformer as T
from repro_torch.train import sharding as sh
from repro_torch.train import step_check
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import adamw

layers.COMPUTE_DTYPE = torch.float32
flags.MOE_GROUPED_DISPATCH = 2
mesh = make_host_mesh((2, 2), device_type="cpu")
view = sh.MeshView(mesh)
B, S, STEPS, LR = 4, 16, 4, 1e-3


def full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def err(got, want):
    want = want.float()
    return float((full(got).float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def decode(cfg, model, prompt, extra):
    prefill = ts.make_prefill_step(cfg, max_seq=S + STEPS)
    serve = ts.make_serve_step(cfg)
    logits, cache = prefill(model, prompt, *extra)
    out, tok = [full(logits)], torch.argmax(full(logits), -1)[:, None]
    for i in range(STEPS):
        tok, lg, cache = serve(model, cache, tok.int(), S + i)
        tok = full(tok)[:, None]
        out.append(full(lg))
    return out, cache


def train(cfg, model, batch):
    opt = adamw(LR)
    loss, grads = ts.value_and_grad(cfg, model, batch)
    grads = {k: full(g) for k, g in grads.items()}
    new, _, _ = ts.make_train_step(cfg, opt)(model, opt.init(model), batch)
    return full(loss), grads, {k: full(p) for k, p in
                               new.named_parameters()}


results = {}
for arch in sys.argv[5:]:
    res = results[arch] = {}
    try:
        cfg = registry.get_config(arch).reduced()
        mod = registry.model_fns(cfg)
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
        labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
        labels[0, :3] = -1
        batch = {"tokens": tokens, "labels": labels}
        extra = ()
        if cfg.family == "encdec":
            frames = torch.from_numpy(rng.normal(
                size=(B, 16, cfg.frontend_dim)).astype(np.float32))
            extra, batch["frontend"] = (frames,), frames

        def run(model):
            logits = mod.forward(cfg, model, tokens, *extra)
            logits = logits[0] if isinstance(logits, tuple) else logits
            steps, cache = decode(cfg, model, tokens, extra)
            flags.ATTN_BF16_SOFTMAX = True
            try:
                bf16 = decode(cfg, model, tokens, extra)[0]
            finally:
                flags.ATTN_BF16_SOFTMAX = False
            return logits, steps, bf16, cache, train(cfg, model, batch)

        want = run(T.init_params(cfg, 0, device="cpu"))
        with sh.use_mesh(mesh):
            model = sh.place_params(T.init_params(cfg, 0, device="cpu"),
                                    view)
            got = run(model)
        res["forward"] = err(got[0], want[0])
        res["prefill"] = err(got[1][0], want[1][0])
        res["decode"] = max(err(g, w) for g, w in zip(got[1][1:],
                                                      want[1][1:]))
        res["decode_bf16_softmax"] = max(err(g, w) for g, w in
                                         zip(got[2], want[2]))
        res["cache_k"] = [repr(p) for p in got[3]["k"].placements]
        res["loss"] = err(got[4][0], want[4][0])
        res["grads"] = max(err(got[4][1][k], w)
                           for k, w in want[4][1].items())
        # AdamW's first step divides each gradient by its own size: the new
        # parameters held within the gap it puts between the two gradients
        p0 = dict(T.init_params(cfg, 0, device="cpu").named_parameters())
        zeros = {k: torch.zeros_like(p) for k, p in p0.items()}
        bound = step_check.step_gap_bound(p0, want[4][1], got[4][1], zeros,
                                          zeros, 1, LR)
        res["update_over_bound"] = max(
            (float(((got[4][2][k] - w).abs().double().numpy()
                    / bound[k]).max()), k) for k, w in want[4][2].items())
        res["dtensor_grads"] = sorted(want[4][1]) == sorted(got[4][1])
    except Exception:
        res["error"] = traceback.format_exc()
dist.destroy_process_group()
if rank == 0:
    json.dump(results, open(out, "w"))
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Rank 0's comparisons, {arch: {check: largest relative error}},
    from one run of the four-process world over every arch."""
    tmp = tmp_path_factory.mktemp("mesh_values")
    out, store = tmp / "out.json", tmp / "store"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(WORLD), str(store),
         str(out), *ARCHS], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return json.loads(out.read_text())


def _checked(world, arch):
    res = world[arch]
    assert "error" not in res, res.get("error")
    return res


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_on_the_mesh_is_the_one_device_forward(world, arch):
    res = _checked(world, arch)
    assert res["forward"] <= RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_on_the_mesh_are_the_one_device_ones(world, arch):
    res = _checked(world, arch)
    assert res["prefill"] <= RTOL
    assert res["decode"] <= DECODE_RTOL
    assert res["decode_bf16_softmax"] <= BF16_RTOL
    # [L, B, S, KV, hd]: the batch over data; the KV heads over model where
    # they divide it, else the sequence
    seq = arch in ("hymba-1.5b", "qwen3-moe-235b-a22b")
    assert res["cache_k"] == ["Shard(dim=1)",
                              "Shard(dim=2)" if seq else "Shard(dim=3)"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_on_the_mesh_is_the_one_device_step(world, arch):
    res = _checked(world, arch)
    assert res["dtensor_grads"]
    assert res["loss"] <= RTOL
    assert res["grads"] <= (HYBRID_GRAD_RTOL if arch == "hymba-1.5b"
                            else RTOL)
    assert res["update_over_bound"][0] <= 1.0, res["update_over_bound"]
