"""The zoo's decode check (``repro_torch.models.decode_check``) on the CPU:
a sound decode passes it, and each planted fault of ``FAULTS`` fails it,
on reduced configs (hymba at 4 layers, so that one layer is windowed:
window 8 against 48 tokens).  ``tools/zoo_decode_faults.py`` runs the same
faults at full width on the card."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.models import decode_check as dc
from repro_torch.models import registry
from repro_torch.models import transformer as T

torch.set_num_threads(2)

ARCHS = ["hymba-1.5b", "seamless-m4t-medium", "deepseek-moe-16b",
         "qwen3-moe-235b-a22b"]


def _setup(arch: str):
    cfg = registry.get_config(arch).reduced()
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, num_layers=4)
    if cfg.moe:                         # no token dropped in the forward
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    gen = torch.Generator().manual_seed(0)
    model = T.init_params(cfg, gen, device="cpu")
    tokens, frames = dc.random_inputs(cfg, 2, 48, gen, torch.device("cpu"),
                                      frames=16)
    return cfg, model, tokens, frames


@pytest.mark.parametrize("arch", ARCHS)
def test_a_sound_decode_passes(arch):
    cfg, model, tokens, frames = _setup(arch)
    dec = dc.decode_gap(cfg, model, tokens, frames, 4)
    assert dc.decode_faults(dec, hybrid=cfg.family == "hybrid") == []
    assert dec["cache_rows"] == 2 and dec["steps_rerouted"] == 0
    assert len(dec["steps"]) == 4 and dec["prefill_tokens"] == 44


# A window one token wider is left out: it moves hymba's decode by less
# than the drift of its SSD forms that the bounds allow, here as at full
# width on the card (``tools/zoo_decode_faults.py``).
@pytest.mark.parametrize("arch, fault", [
    *(("hymba-1.5b", f) for f in dc.FAULTS if f != "window_plus_1"),
    *((a, "kv_write_pos_minus_1") for a in ARCHS[1:])])
def test_a_planted_fault_fails(arch, fault):
    """Each fault breaks the check; where no step rerouted a row, the cache
    comparison alone sees it too."""
    cfg, model, tokens, frames = _setup(arch)
    hybrid = cfg.family == "hybrid"
    with dc.planted(fault):
        dec = dc.decode_gap(cfg, model, tokens, frames, 4)
    assert dc.decode_faults(dec, hybrid=hybrid) != []
    if dec["cache_rows"] == 2:
        bound = dc.HYMBA_CACHE_REL if hybrid else dc.CACHE_REL
        assert max(dec["cache_rel"].values()) > bound


def test_planted_restores_the_decode_path():
    cfg, model, tokens, frames = _setup("hymba-1.5b")
    before = dc.decode_gap(cfg, model, tokens, frames, 4)
    for fault in dc.FAULTS:
        with dc.planted(fault):
            pass
    after = dc.decode_gap(cfg, model, tokens, frames, 4)
    assert after["cache_rel"] == before["cache_rel"]
    assert after["max_abs_err"] == before["max_abs_err"]
    with pytest.raises(ValueError, match="unknown fault"):
        with dc.planted("no_such_fault"):
            pass


def _step(**kw):
    step = {"t": 9, "max_abs_err": 0.0, "held_max_abs_err": 0.0,
            "rows_rerouted": 0, "scale": 4.0, "rel": 0.0, "tie_margin": None}
    step.update(kw)
    return step


def _dec(*steps, cache_rel=None):
    return {"rel": max(s["rel"] for s in steps),
            "max_abs_err": max(s["max_abs_err"] for s in steps),
            "steps": list(steps), "cache_rel": cache_rel or {}}


@pytest.mark.parametrize("step, n_faults", [
    (_step(), 0),
    # a rerouted row at a near tie: its own gap is not held, the others are
    (_step(max_abs_err=1.0, held_max_abs_err=0.1, rows_rerouted=1,
           tie_margin=1e-4), 0),
    (_step(max_abs_err=1.0, held_max_abs_err=0.2, rows_rerouted=1,
           tie_margin=1e-4), 1),
    (_step(max_abs_err=1.0, held_max_abs_err=None, rows_rerouted=2,
           tie_margin=2e-3), 1),
    (_step(rel=0.6), 1),
], ids=["sound", "rerouted_at_a_tie", "held_row_off", "rerouted_no_tie",
        "unrelated_logits"])
def test_decode_faults_holds_the_rows_not_rerouted(step, n_faults):
    """4 bf16 steps of a scale of 4 is 0.125: the rows that every layer
    routed as the forward did are held to it, a rerouted step's too."""
    assert len(dc.decode_faults(_dec(step), hybrid=False)) == n_faults


def test_decode_faults_holds_the_cache_and_hymbas_bound():
    assert dc.decode_faults(_dec(_step(), cache_rel={"k": dc.CACHE_REL}),
                            hybrid=False) == []
    assert len(dc.decode_faults(_dec(_step(), cache_rel={"k": 0.1}),
                                hybrid=False)) == 1
    assert dc.decode_faults(_dec(_step(), cache_rel={"k": 0.1}),
                            hybrid=True) == []
    assert len(dc.decode_faults(
        _dec(_step(), cache_rel={"k": 0.0,
                                 "ssm_state": 2 * dc.HYMBA_CACHE_REL}),
        hybrid=True)) == 1
    assert len(dc.decode_faults(
        _dec(_step(max_abs_err=dc.HYMBA_DECODE_TOL + 0.1)), hybrid=True)) == 1
