"""Training steps: the program's train step (``make_train_step``) over the
seeded synthetic stream, AdamW over fp32 masters, a closed loop of steps.

Set-up builds one step function with its masters and optimizer state,
runs the first ``check_steps`` steps through the window's own call and
feed (the warm-up), and keeps what the check compares: each step's loss,
the first step's gradient as the optimizer got it (its first moment over
1 - beta1) and each leaf's change after those steps.  The window then
continues from that state.  A step is complete when its loss is on the
host.

A mix of this kind: ``batch``, ``seq_len`` (rows and tokens of a step),
``remat``, ``optimizer`` (AdamW's settings), ``check_steps`` (the steps
the reference follows).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

import compare
import traffic
import weights


class Run:
    def __init__(self, env):
        self.env = env
        self.mix = env.mix
        self.tokens_per_unit = self.mix["batch"] * self.mix["seq_len"]
        # forward and backward (twice the forward), the head at every
        # position; no recompute counted
        rows = self.mix["batch"] * self.mix["seq_len"]
        self.unit_flops = 3.0 * env.family.forward_flops(
            env.model, self.mix["batch"], self.mix["seq_len"],
            head_rows=rows)
        self.readings: Dict[str, List[float]] = {}
        self.reading_s = 0.0

    def _opt_config(self):
        from repro_torch.train import optimizer as opt

        o = self.mix["optimizer"]
        return opt.OptConfig(
            lr=o["lr"], betas=tuple(o["betas"]), eps=o["eps"],
            weight_decay=o["weight_decay"], clip_norm=o["clip_norm"],
            warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
            min_lr_frac=o["min_lr_frac"], schedule=o["schedule"])

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        with torch.profiler.record_function("bench.feed"):
            return {k: torch.from_numpy(v).to(self.env.device)
                    for k, v in self.data.batch_at(step).items()}

    def setup(self) -> None:
        from repro_torch.models import decoder
        from repro_torch.train import optimizer as opt
        from repro_torch.train.train_step import TrainConfig, make_train_step

        env, mix = self.env, self.mix
        ctx = decoder.RunCtx(device=env.device, remat=mix["remat"],
                             use_kernel="auto")
        self.params = weights.make_params(env.family, env.model, env.seed,
                                          env.device, torch.float32)
        self.opt_state = opt.init(self.params)
        self.step_fn = make_train_step(env.cfg, ctx,
                                       TrainConfig(opt=self._opt_config()))
        self.data = traffic.SyntheticLM(env.model["vocab_size"],
                                        mix["batch"], mix["seq_len"],
                                        env.seed)
        self.next_step = 0
        b1 = mix["optimizer"]["betas"][0]
        losses = []
        for i in range(mix["check_steps"]):
            losses.append(self._step())
            t0 = time.perf_counter()
            if i == 0:
                self.readings["grad_norms"] = [
                    float(torch.linalg.vector_norm(t)) / (1 - b1)
                    for _, t in weights.paths(self.opt_state.m)]
            self.reading_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        self.readings["losses"] = losses
        self.readings["changes"] = self._changes(self.params)
        self.reading_s += time.perf_counter() - t0

    def _changes(self, params) -> List[float]:
        """Each leaf's distance from the seed's initial weights."""
        p0 = weights.make_params(self.env.family, self.env.model,
                                 self.env.seed, self.env.device,
                                 torch.float32)
        out = [float(torch.linalg.vector_norm(a - b)) for (_, a), (_, b) in
               zip(weights.paths(params), weights.paths(p0))]
        del p0
        return out

    def _step(self) -> float:
        """One step; returns its loss, read back to the host."""
        batch = self._batch(self.next_step)
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch)
        self.next_step += 1
        with torch.profiler.record_function("bench.readback"):
            return float(metrics["loss"])

    def unit(self) -> Dict:
        loss = self._step()
        return {"tokens": self.tokens_per_unit, "requests": 1,
                "failed": 0 if np.isfinite(loss) else 1, "latency": []}

    def release(self) -> int:
        del self.params, self.opt_state, self.step_fn
        return 0

    def side(self) -> Dict:
        return self.readings

    # -- the check ---------------------------------------------------------
    def reference(self, fp8: bool = False, rows: int = 0) -> Dict:
        """The reference's readings from fresh weights over the same first
        steps; ``rows`` > 0 keeps that many rows of each batch (a fault)."""
        import reference

        env, mix = self.env, self.mix
        ref = reference.load(env.config["reference"])
        params = weights.make_params(env.family, env.model, env.seed,
                                     env.device, torch.float32)
        batches = []
        for i in range(mix["check_steps"]):
            b = self._batch(i)
            batches.append({k: v[:rows] if rows else v for k, v in b.items()})
        leaf_paths = [p for p, _ in weights.paths(params)]
        out = ref.train(env.model, mix["optimizer"], params, batches,
                        leaf_paths, fp8=fp8)
        out["changes"] = self._changes(params)
        del params
        return out

    def numbers(self, side: Dict, ref: Dict) -> Dict[str, float]:
        return compare.training(side, ref)
