"""Prefill: a closed loop of one client, each call ``batch`` prompts of
``seq_len`` tokens through the program's ``decoder.prefill``; a request
is served when its first token (the argmax of its last-position logits)
is on the host, and the client sends its next call then.

A mix of this kind: ``batch``, ``seq_len``, ``warmup_calls`` (calls of
set-up, on prompts the window never sends), ``check_requests`` (requests
the reference recomputes).

The check recomputes a sample of the served requests, drawn from the
seed as they are served (a reservoir of ``check_requests``, so the
window holds no more than that many logits), with the reference, and
reads each served token against the reference's logits.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

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
        # the head at each row's last position only
        self.unit_flops = env.family.forward_flops(
            env.model, self.mix["batch"], self.mix["seq_len"],
            head_rows=self.mix["batch"])
        self.reading_s = 0.0
        self.calls = 0
        self.offered = 0
        # (call, row, logits, first token) of the sample so far
        self.kept: List[Tuple[int, int, torch.Tensor, int]] = []
        self.rng = np.random.default_rng(traffic._mix(env.seed, 0xC4EC))

    def setup(self) -> None:
        from repro_torch.models import decoder

        env = self.env
        self.ctx = decoder.RunCtx(device=env.device, use_kernel="auto")
        self.params = weights.make_params(env.family, env.model, env.seed,
                                          env.device,
                                          env.cfg.compute_dtype())
        self.gen = torch.Generator(device=env.device)
        self.bad = torch.zeros((), dtype=torch.int64, device=env.device)
        for i in range(self.mix.get("warmup_calls", 1)):
            self._call(-1 - i)
        self.bad.zero_()

    def _call(self, call: int) -> Tuple[torch.Tensor, np.ndarray]:
        from repro_torch.models import decoder

        with torch.profiler.record_function("bench.feed"):
            tokens = traffic.prompts(self.mix, self.env.model["vocab_size"],
                                     self.env.seed, call, self.env.device,
                                     self.gen)
        logits, _ = decoder.prefill(self.env.cfg, self.ctx, self.params,
                                    {"tokens": tokens})
        with torch.profiler.record_function("bench.readback"):
            self.bad += (~torch.isfinite(logits).all(dim=-1)).sum()
            first = logits.argmax(dim=-1).cpu().numpy()
        return logits, first

    def unit(self) -> Dict:
        """One call; done when its first tokens are on the host."""
        t0 = time.perf_counter()
        logits, first = self._call(self.calls)
        latency = time.perf_counter() - t0
        for row in range(self.mix["batch"]):
            self._offer((self.calls, row, logits[row], int(first[row])))
        self.calls += 1
        return {"tokens": self.tokens_per_unit, "requests": self.mix["batch"],
                "failed": 0, "latency": [latency] * self.mix["batch"]}

    def _offer(self, request) -> None:
        """Reservoir sampling: after n requests each is kept with
        probability k / n, by the seed's draws."""
        k, n = self.mix["check_requests"], self.offered
        self.offered += 1
        if n < k:
            self.kept.append(request)
            return
        j = int(self.rng.integers(0, n + 1))
        if j < k:
            self.kept[j] = request

    def release(self) -> int:
        """Frees the program's state, keeps the sample's served logits on
        the host; returns the requests whose logits were not finite."""
        bad = int(self.bad)
        self.kept = sorted((c, r, lg.float().cpu(), tok)
                           for c, r, lg, tok in self.kept)
        del self.params, self.ctx, self.gen
        return bad

    # -- the check ---------------------------------------------------------
    def sample(self) -> List[Tuple[int, int]]:
        """(call, row) of the requests the check recomputes."""
        return [(c, r) for c, r, _, _ in self.kept]

    def reference(self, fp8: bool = False) -> Dict:
        """The reference's last-position logits of the sample, from fresh
        weights and the same prompts."""
        import reference

        env = self.env
        ref = reference.load(env.config["reference"])
        params = weights.make_params(env.family, env.model, env.seed,
                                     env.device, env.cfg.compute_dtype())
        by_call: Dict[int, List[int]] = {}
        for call, row in self.sample():
            by_call.setdefault(call, []).append(row)
        logits = []
        for call, rows in by_call.items():
            tokens = traffic.prompts(self.mix, env.model["vocab_size"],
                                     env.seed, call, env.device)[rows]
            logits += list(ref.last_logits(env.model, params, tokens,
                                           fp8=fp8).cpu())
        del params
        return {"logits": logits}

    def side(self) -> Dict:
        """The program's served logits and tokens of the sample."""
        return {"logits": [lg for _, _, lg, _ in self.kept],
                "tokens": [tok for _, _, _, tok in self.kept]}

    def numbers(self, side: Dict, ref: Dict) -> Dict[str, float]:
        return compare.served(side, ref)
