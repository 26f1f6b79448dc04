"""The numbers ``correct`` is decided by: the program's readings against
the reference's, each a worst case over what was sampled."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves under AdamW by round-off alone: its change is not compared
QUIET_GRAD = 1e-3


def _worst_gap(side: List[float], ref: List[float],
               keep: List[bool]) -> float:
    """The largest |side - ref| over the kept leaves, each against the
    larger of its own reference norm and the median leaf's."""
    ref_a = np.asarray(ref, dtype=np.float64)
    med = float(np.median(ref_a[np.asarray(keep)]))
    return max(abs(s - r) / max(r, med)
               for s, r, k in zip(side, ref, keep) if k)


def training(side: Dict, ref: Dict) -> Dict[str, float]:
    """Each step's loss; the first gradient's norm, leaf by leaf; each
    leaf's change over the steps, where its reference gradient is not
    quiet."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(side["losses"],
                                                  ref["losses"]))
    g_ref = ref["grad_norms"]
    every = [True] * len(g_ref)
    loud = [g >= QUIET_GRAD * float(np.median(g_ref)) for g in g_ref]
    return {"loss_gap": float(loss),
            "grad_gap": _worst_gap(side["grad_norms"], g_ref, every),
            "update_gap": _worst_gap(side["changes"], ref["changes"], loud)}


def own_norm_gaps(side: Dict, ref: Dict) -> Dict[str, tuple]:
    """For the record, not compared: the worst leaf's gap against its own
    reference norm alone, with no median floor, as (gap, leaf index); the
    gradient over every leaf, the change over the loud leaves."""
    g_ref = ref["grad_norms"]
    loud = [g >= QUIET_GRAD * float(np.median(g_ref)) for g in g_ref]
    out = {}
    for name, s_v, r_v, keep in (
            ("grad", side["grad_norms"], g_ref, [True] * len(g_ref)),
            ("update", side["changes"], ref["changes"], loud)):
        gaps = [(abs(a - b) / b if b > 0 else float(a > 0), i)
                for i, (a, b, k) in enumerate(zip(s_v, r_v, keep)) if k]
        out[name] = max(gaps)
    return out


def served(side: Dict, ref: Dict) -> Dict[str, float]:
    """The widest gap by which a served token's logit lies below the
    reference's best, and the largest logit error over the sample in
    units of the reference logits' standard deviation."""
    gap, err = 0.0, 0.0
    for lg, tok, want in zip(side["logits"], side["tokens"], ref["logits"]):
        want = want.double()
        gap = max(gap, float(want.max() - want[tok]))
        err = max(err, float((lg.double() - want).abs().max() / want.std()))
    return {"token_gap": gap, "logit_err": err}


def control_side(ref: Dict) -> Dict:
    """A reference run put in the program's place: its logits, and the
    tokens it would serve."""
    return {"logits": ref["logits"],
            "tokens": [int(torch.argmax(lg)) for lg in ref["logits"]]}
