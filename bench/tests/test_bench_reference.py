"""The float32 reference against the program on the CPU at smoke sizes:
the same function (the program in float32 with its plain twins), the
same loss and gradients, the same AdamW step."""
import numpy as np
import pytest
import torch

import run as bench
import traffic
import weights
from families import decoder as family
from reference import decoder as ref
from smoke import model

from repro_torch.models import decoder
from repro_torch.train import optimizer as opt


def _prompts(m, seed=5, b=2, s=80):
    return traffic.prompts({"batch": b, "seq_len": s}, m["vocab_size"], seed,
                           0, "cpu")


@pytest.mark.parametrize("config", ["zamba2-1.2b", "glm4-9b"])
def test_last_logits_match_the_program_in_float32(config):
    m = model(config, "float32")
    params = weights.make_params(family, m, 11, "cpu", torch.float32)
    tokens = _prompts(m)
    ctx = decoder.RunCtx(device="cpu")
    got, _ = decoder.prefill(bench.model_config(m), ctx, params,
                             {"tokens": tokens})
    want = ref.last_logits(m, params, tokens)
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4), \
        float((got - want).abs().max())


@pytest.mark.parametrize("config", ["zamba2-1.2b", "glm4-9b"])
def test_loss_and_gradients_match_the_program_in_float32(config):
    m = model(config, "float32")
    params = weights.make_params(family, m, 12, "cpu", torch.float32)
    data = traffic.SyntheticLM(m["vocab_size"], 2, 80, 3).batch_at(0)
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    leaves = [(p, t.requires_grad_(True)) for p, t in weights.paths(params)]
    loss, _ = decoder.loss_fn(bench.model_config(m),
                              decoder.RunCtx(device="cpu"), params, batch)
    got = torch.autograd.grad(loss, [t for _, t in leaves],
                              allow_unused=True)
    with ref.Float32():
        want_loss = ref.loss(m, params, batch["tokens"], batch["labels"])
        want = torch.autograd.grad(want_loss, [t for _, t in leaves],
                                   allow_unused=True)
    assert abs(float(loss.detach()) - float(want_loss.detach())) < 1e-5
    for (path, t), g, w in zip(leaves, got, want):
        g = torch.zeros_like(t) if g is None else g
        w = torch.zeros_like(t) if w is None else w
        scale = float(w.abs().max()) + 1e-12
        assert float((g - w).abs().max()) <= 2e-4 * scale + 1e-9, path


def test_adamw_step_matches_the_program():
    m = model("zamba2-1.2b", "float32")
    o = traffic.load("train")["optimizer"]
    a = weights.make_params(family, m, 13, "cpu", torch.float32)
    b = weights.make_params(family, m, 13, "cpu", torch.float32)
    rng = np.random.default_rng(0)
    grads = [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
             for _, t in weights.paths(a)]
    cfg = opt.OptConfig(lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"],
                        weight_decay=o["weight_decay"],
                        clip_norm=o["clip_norm"],
                        warmup_steps=o["warmup_steps"],
                        total_steps=o["total_steps"],
                        min_lr_frac=o["min_lr_frac"], schedule=o["schedule"])
    from repro_torch.train.train_step import body_layers
    from repro_torch.train.tree import unflatten

    state = opt.init(a)
    leaves_b = weights.paths(b)
    mom = [torch.zeros_like(t) for _, t in leaves_b]
    vel = [torch.zeros_like(t) for _, t in leaves_b]
    for step in range(3):
        a, state, _ = opt.update(cfg, a, unflatten(a, grads), state,
                                 body=body_layers(bench.model_config(m)))
        ref.adamw(m, o, leaves_b, grads, mom, vel, step)
    for (path, x), (_, y) in zip(weights.paths(a), leaves_b):
        assert torch.allclose(x, y, atol=1e-7, rtol=1e-6), path


def test_the_fp8_control_rounds_every_product():
    m = model("glm4-9b", "float32")
    params = weights.make_params(family, m, 14, "cpu", torch.float32)
    tokens = _prompts(m)
    full = ref.last_logits(m, params, tokens)
    low = ref.last_logits(m, params, tokens, fp8=True)
    err = float((full - low).abs().max() / full.std())
    assert 1e-3 < err < 1.0
