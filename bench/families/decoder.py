"""The decoder family: dense GQA stacks (glm4-9b) and Mamba2 hybrids with
one shared attention block (zamba2-1.2b), as the program lays them out.

A configuration names its family under ``"family"``; the harness loads
``bench/families/<name>.py`` and reads three things from it:

* ``param_shapes(m)`` — the tree of leaf shapes of model section ``m``;
* ``initial(name, t)`` — a leaf that is not drawn (a vector): its fixed
  initial value, in place;
* ``forward_flops(m, batch, seq, head_rows=)`` — the model's FLOPs of a
  forward over ``batch`` x ``seq`` tokens with the head on ``head_rows``
  positions.

The tree is ``{"embed", "layers": [...], "shared_attn", "final_norm",
"lm_head"}``, each layer's dict keyed as the program reads it.  Imports
torch and the benchmark's frozen arithmetic alone.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from arith import ssd_forward_flops, visible_pairs

_NORMS = ("gate_norm", "q_norm", "k_norm", "final_norm", "ln_attn",
          "ln_mlp", "ln_mix")
_GATED = ("swiglu", "geglu")


def layer_kinds(model: Dict) -> list:
    """("mamba" | "shared_attn" | "attn") per layer, as the decoder lays
    them out: a hybrid stack puts its shared attention site at every
    ``hybrid_attn_every``-th layer."""
    n, ssm, every = model["n_layers"], model.get("ssm"), \
        model.get("hybrid_attn_every")
    if ssm and every:
        return ["shared_attn" if (i + 1) % every == 0 else "mamba"
                for i in range(n)]
    if ssm:
        return ["mamba"] * n
    return ["attn"] * n


def _attn(m: Dict) -> Dict[str, Tuple[int, ...]]:
    d, hq, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], \
        m["head_dim"]
    return {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
            "wo": (hq * hd, d)}


def _mlp(m: Dict) -> Dict[str, Tuple[int, ...]]:
    d, f = m["d_model"], m["d_ff"]
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def _mamba(m: Dict) -> Dict[str, Tuple[int, ...]]:
    s, d = m["ssm"], m["d_model"]
    di = s["expand"] * d
    nh = di // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    conv = di + 2 * gn
    return {"w_in": (d, 2 * di + 2 * gn + nh), "conv_w": (s["d_conv"], conv),
            "conv_b": (conv,), "A_log": (nh,), "D": (nh,),
            "dt_bias": (nh,), "gate_norm": (di,), "w_out": (di, d)}


def param_shapes(m: Dict) -> Dict[str, Any]:
    """The tree of leaf shapes of model section ``m`` (a config file's
    ``"model"``)."""
    if m.get("mlp_act", "swiglu") not in _GATED or m.get("moe") or \
            m.get("mla") or m.get("use_qk_norm") or m.get("tie_embeddings"):
        raise ValueError("the decoder family covers dense gated-MLP GQA and "
                         "Mamba2 stacks")
    d = m["d_model"]
    layers: List[Dict[str, Any]] = []
    for kind in layer_kinds(m):
        if kind == "mamba":
            layers.append({"mamba": _mamba(m), "ln_mix": (d,)})
        elif kind == "shared_attn":
            layers.append({"mlp": _mlp(m), "ln_mlp": (d,)})
        else:
            layers.append({"attn": _attn(m), "ln_attn": (d,),
                           "mlp": _mlp(m), "ln_mlp": (d,)})
    tree: Dict[str, Any] = {"embed": (m["vocab_size"], d), "layers": layers,
                            "final_norm": (d,),
                            "lm_head": (d, m["vocab_size"])}
    if "shared_attn" in layer_kinds(m):
        tree["shared_attn"] = {"attn": _attn(m), "ln_attn": (d,)}
    return tree


def initial(name: str, t: torch.Tensor) -> None:
    """Vectors: norms and Mamba2's ``D`` one, ``A_log`` = log(linspace(1,
    16)), ``dt_bias`` = softplus^-1(0.01), the rest zero."""
    if name == "A_log":
        t.copy_(torch.log(torch.linspace(1.0, 16.0, t.shape[-1],
                                         device=t.device)))
    elif name == "D" or name in _NORMS:
        t.fill_(1.0)
    elif name == "dt_bias":
        t.fill_(math.log(math.expm1(0.01)))
    else:
        t.zero_()


# ---------------------------------------------------------------------------
# Work
# ---------------------------------------------------------------------------

def _mamba_dims(model: Dict) -> Tuple[int, int, int, int, int, int]:
    """(d_inner, heads, head dim, state size, B / C width, chunk)."""
    s, d = model["ssm"], model["d_model"]
    if s["n_groups"] != 1:
        raise ValueError("the SSD's work is counted for one group")
    di = s["expand"] * d
    return di, di // s["head_dim"], s["head_dim"], s["d_state"], \
        s["d_state"] * s["n_groups"], s["chunk"]


def matmul_params(model: Dict) -> float:
    """Weights a token passes through in the layers (every site of a
    shared block counts), without the embedding and the head."""
    d, hq, hkv, hd = model["d_model"], model["n_heads"], \
        model["n_kv_heads"], model["head_dim"]
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    gated = model.get("mlp_act", "swiglu") in _GATED
    mlp = (3 if gated else 2) * d * model["d_ff"]
    total = 0.0
    for kind in layer_kinds(model):
        if kind == "mamba":
            di, nh, _, _, gn, _ = _mamba_dims(model)
            total += d * (2 * di + 2 * gn + nh) + di * d
        else:
            total += attn + mlp
    return total


def forward_flops(model: Dict, batch: int, seq: int, *,
                  head_rows: int) -> float:
    """A forward over ``batch`` x ``seq`` tokens: every weight matrix,
    the head on ``head_rows`` positions, causal attention on the visible
    pairs and the SSD's chunk products."""
    tokens = batch * seq
    flops = 2.0 * matmul_params(model) * tokens
    flops += 2.0 * model["d_model"] * model["vocab_size"] * head_rows
    hd = model["head_dim"]
    for kind in layer_kinds(model):
        if kind == "mamba":
            _, nh, p, n, _, chunk = _mamba_dims(model)
            flops += ssd_forward_flops(batch, seq, nh, p, n, chunk)
        else:
            flops += 2.0 * batch * model["n_heads"] \
                * visible_pairs(seq, seq, True) * (hd + hd)
    return flops
