"""Each cell's check catches the faults it can have.  A run of the harness
on the CPU at smoke size (past its look for a card), with the timed path
broken underneath, comes out not correct: a step that returns its state
unchanged, half of each batch left out (the mean over the rest), a served
token altered where it is produced.  The same run unbroken comes out
correct.  (One chip: no exchange between chips to leave out.  The fp8
control is held at the cells' own sizes on the card:
``test_bench_control.py``.)"""
import pytest
import torch

import run as bench
import smoke

from repro_torch.models import decoder
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step
from repro_torch.train.tree import tree_map

SEED = 2 ** 31 + 21
TRAIN = "zamba2-1.2b.train"
PREFILL = [w["name"] for w in bench.spec()["workloads"]
           if w["traffic"].startswith("prefill")]


def _cell(workload: str) -> dict:
    return {w["name"]: w for w in bench.spec()["workloads"]}[workload]


def _run(workload: str) -> dict:
    w = _cell(workload)
    return bench.run(workload, SEED, 0.2, False, "cpu",
                     model=smoke.model(w["config"]),
                     mix=smoke.mix(w["traffic"]))


@pytest.mark.parametrize("workload", [TRAIN] + PREFILL)
def test_sound_runs_are_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    make = train_step.make_train_step

    def broken(cfg, ctx, tcfg):
        step = make(cfg, ctx, tcfg)

        def unchanged(params, state, batch):
            copy = opt.OptState(tree_map(torch.clone, state.m),
                                tree_map(torch.clone, state.v),
                                state.count.clone())
            _, _, metrics = step(tree_map(torch.clone, params), copy, batch)
            return params, state, metrics
        return unchanged

    monkeypatch.setattr(train_step, "make_train_step", broken)
    assert not _run(TRAIN)["correct"]


def test_half_the_batch_left_out(monkeypatch):
    loss_fn = decoder.loss_fn

    def half(cfg, ctx, params, batch):
        return loss_fn(cfg, ctx, params,
                       {k: v[:v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(decoder, "loss_fn", half)
    assert not _run(TRAIN)["correct"]


@pytest.mark.parametrize("workload", PREFILL)
def test_a_served_token_altered(monkeypatch, workload):
    prefill = decoder.prefill

    def altered(cfg, ctx, params, batch, max_len=None):
        logits, cache = prefill(cfg, ctx, params, batch)
        logits = logits.clone()
        other = (logits[0].argmax() + 1) % logits.shape[-1]
        logits[0, other] = logits[0].max() + 1.0
        return logits, cache

    monkeypatch.setattr(decoder, "prefill", altered)
    assert not _run(workload)["correct"]
