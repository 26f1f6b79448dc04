"""The model path's profiler ranges (``repro_torch.obs.regions.region``) on
the CPU: a tiny hybrid train step (Mamba, the shared attention site, its
MLP) and a prefill under ``torch.profiler`` record the ``repro.*`` ranges
nested as the sites open them, a count a layer and a step; a backward
node's ``sequence_nr`` leads to the mixer range its forward op ran in;
with no profiler nothing records and the step's results keep their bits;
a forced collection under the profiler is a ``repro.gc`` range and moves
the GC counters."""
import dataclasses
import gc
from collections import Counter, defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.models import common, decoder
from repro_torch.obs import regions
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import TrainConfig, make_train_step
from repro_torch.train.tree import leaves

EVALUATE = "autograd::engine::evaluate_function: "

# the smoke zamba2: 8 layers, 6 Mamba, 2 shared attention sites with MLPs
MAMBA, ATTN = 6, 2
STEP = {"repro.step": 1, "repro.step.cast": 1, "repro.step.forward": 1,
        "repro.step.backward": 1, "repro.step.update": 1,
        "repro.optimizer": 1, "repro.optimizer.clip": 1,
        "repro.optimizer.adamw": 1}
PREFILL = {"repro.prefill": 1, "repro.prefill.embed": 1,
           "repro.prefill.stack": 1, "repro.prefill.head": 1}
LAYERS = {"repro.mixer.mamba": MAMBA, "repro.mamba.in_proj": MAMBA,
          "repro.mamba.out_proj": MAMBA, "repro.ssd": MAMBA,
          "repro.mixer.attn": ATTN, "repro.attention": ATTN,
          "repro.mlp": ATTN}
# each range's enclosing range on its thread
PARENT = {"repro.step.cast": "repro.step", "repro.step.forward": "repro.step",
          "repro.step.backward": "repro.step",
          "repro.step.update": "repro.step",
          "repro.optimizer": "repro.step.update",
          "repro.optimizer.clip": "repro.optimizer",
          "repro.optimizer.adamw": "repro.optimizer",
          "repro.prefill.embed": "repro.prefill",
          "repro.prefill.stack": "repro.prefill",
          "repro.prefill.head": "repro.prefill",
          "repro.mamba.in_proj": "repro.mixer.mamba",
          "repro.mamba.out_proj": "repro.mixer.mamba",
          "repro.ssd": "repro.mixer.mamba",
          "repro.attention": "repro.mixer.attn"}
STACK = {"train": "repro.step.forward", "prefill": "repro.prefill.stack"}


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(configs.get_smoke_config("zamba2-1.2b"),
                              dtype="float32")
    assert Counter(k.mixer for k in common.layer_plan(cfg).kinds) == \
        {"mamba": MAMBA, "shared_attn": ATTN}
    ctx = decoder.RunCtx(device="cpu")
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=g)
    return cfg, ctx, {"tokens": tokens, "labels": tokens}


def _params(cfg):
    return common.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _run(model, what):
    """One train step or prefill; returns its outputs."""
    cfg, ctx, batch = model
    params = _params(cfg)
    if what == "train":
        step = make_train_step(cfg, ctx, TrainConfig())
        return step(params, opt.init(params), batch)
    return decoder.prefill(cfg, ctx, params, {"tokens": batch["tokens"]})


def _profiled(model, what):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _run(model, what)
    return out, prof.profiler.kineto_results.events()


def _ranges(events):
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
             e.start_thread_id()) for e in events
            if e.name().startswith("repro.")]


def _parent(r, ranges):
    """The innermost range holding ``r`` on its thread."""
    holders = [o for o in ranges if o is not r and o[3] == r[3]
               and o[0] <= r[0] and r[1] <= o[1]]
    return max(holders, key=lambda o: o[0])[2] if holders else None


@pytest.mark.parametrize("what", ["train", "prefill"])
def test_ranges_nest_as_the_sites_open_them(model, what):
    _, events = _profiled(model, what)
    ranges = [r for r in _ranges(events) if r[2] != "repro.gc"]
    want = dict(LAYERS, **(STEP if what == "train" else PREFILL))
    assert Counter(r[2] for r in ranges) == want
    for r in ranges:
        parent = _parent(r, ranges)
        if r[2] in ("repro.step", "repro.prefill"):
            assert parent is None
        elif r[2] in ("repro.mixer.mamba", "repro.mixer.attn", "repro.mlp"):
            assert parent == STACK[what], r
        else:
            assert parent == PARENT[r[2]], r


def test_backward_nodes_lead_to_their_forward_mixer(model):
    """Each backward node's ``(fwd_thread_id, sequence_nr)`` names the
    forward op that made it (the last op with that number on that
    thread); the ranges around that op are the node's: the GEMMs' nodes
    fall in the projections, the scan's in the SSD, the Mamba glue's
    (softplus, SiLU, the conv) in the mixer itself, site for site."""
    _, events = _profiled(model, "train")
    ranges = _ranges(events)
    forward_at = {}
    for e in sorted(events, key=lambda e: e.start_ns()):
        if e.sequence_nr() >= 0 and e.fwd_thread_id() == 0 and \
                not e.name().startswith(EVALUATE):
            forward_at[(e.start_thread_id(), e.sequence_nr())] = \
                e.start_ns()
    inner = defaultdict(Counter)     # innermost range name -> its nodes
    fed = Counter()                  # mixer ranges that fed some node
    for e in events:
        if not e.name().startswith(EVALUATE) or e.sequence_nr() < 0:
            continue
        tid = e.fwd_thread_id()
        t = forward_at[(tid, e.sequence_nr())]
        holders = [r for r in ranges if r[3] == tid and r[0] <= t <= r[1]]
        if not holders:
            continue
        inner[max(holders, key=lambda r: r[0])[2]][
            e.name()[len(EVALUATE):]] += 1
        fed.update({r for r in holders
                    if r[2] in ("repro.mixer.mamba", "repro.mixer.attn")})
    assert Counter(r[2] for r in fed) == {"repro.mixer.mamba": MAMBA,
                                          "repro.mixer.attn": ATTN}
    for proj in ("repro.mamba.in_proj", "repro.mamba.out_proj"):
        assert inner[proj]["MmBackward0"] == MAMBA
    glue = inner["repro.mixer.mamba"]
    assert glue["SoftplusBackward0"] == MAMBA and \
        glue["SiluBackward0"] == 2 * MAMBA and "MmBackward0" not in glue
    assert inner["repro.ssd"]["BmmBackward0"] > 0
    assert inner["repro.attention"]["SoftmaxBackward0"] == ATTN


def test_nothing_records_without_a_profiler(model, monkeypatch):
    """Off: every site returns the one shared no-op context, no range is
    opened, the GC callback records nothing, and the step's results are
    bit for bit those of a profiled step."""
    assert regions.region("repro.a") is regions.region("repro.b")
    opened = []
    record = regions._record
    monkeypatch.setattr(regions, "_record",
                        lambda name: opened.append(name) or record(name))
    before = regions.COUNTERS.as_dict()
    params_off, state_off, metrics_off = _run(model, "train")
    gc.collect()
    assert opened == [] and regions.COUNTERS.as_dict() == before
    (params_on, state_on, metrics_on), _ = _profiled(model, "train")
    assert "repro.step" in opened
    for a, b in zip(leaves((params_off, state_off.m, state_off.v,
                            metrics_off)),
                    leaves((params_on, state_on.m, state_on.v,
                            metrics_on))):
        assert torch.equal(a, b)


def test_a_collection_under_the_profiler_is_a_gc_range():
    before = regions.COUNTERS.as_dict()
    regions.region("repro.bind")          # the GC callback is in place
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    after = regions.COUNTERS.as_dict()
    assert after["gc.pauses"] - before.get("gc.pauses", 0) >= 1
    assert after["gc.seconds"] > before.get("gc.seconds", 0.0)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "repro.gc" in names
