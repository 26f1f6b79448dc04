"""Shared model-definition substrate: configs, layer plan, primitive layers.

The port of :mod:`repro.models.common`.  The configuration dataclasses are
field-for-field copies of the reference's.  Parameters are plain nested
dicts of tensors, but where the reference stacks the scanned body of the
layer plan over a leading group axis, the port keeps one dict per layer:
``{"embed", "layers": [layer 0, ..., layer n-1], "shared_attn",
"final_norm", "lm_head"}`` (``shared_attn``: zamba2's one attention block,
read by every ``shared_attn`` layer; ``lm_head`` absent when tied).
:func:`params_from_numpy` maps the reference's tree onto that layout, which
is how the tests make both packages compute the same thing.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dimensions."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 0              # expert FFN hidden dim
    n_shared: int = 0              # always-on shared experts (deepseek-v2)
    d_shared: int = 0              # hidden dim of the fused shared expert
    first_dense_layers: int = 0    # leading layers that use a dense FFN
    d_first_dense: int = 0
    router_scale: float = 1.0      # routed-expert weight scale


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block dimensions."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # activations / norms
    mlp_act: str = "swiglu"        # swiglu | geglu | relu2 | gelu
    norm_eps: float = 1e-5
    use_qk_norm: bool = False
    gemma_norm: bool = False       # (1+w) RMSNorm + sqrt(d) embedding scale
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    # rotary
    rope_theta: float = 1e4
    rope_theta_global: Optional[float] = None    # gemma3 global layers
    partial_rotary: float = 1.0
    mrope_sections: Optional[Tuple[int, ...]] = None    # qwen2-vl
    # attention pattern
    causal: bool = True            # False => bidirectional encoder
    sliding_window: Optional[int] = None
    global_every: Optional[int] = None   # 1 global layer per this many layers
    # specials
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: Optional[int] = None   # zamba2 shared-attn period
    max_seq_len: int = 131072
    dtype: str = "bfloat16"

    # -- derived -------------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Analytic parameter count."""
        return int(sum(int(np.prod(s)) for s in _leaves(param_shapes(self))))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top-k experts only)."""
        total = self.param_count()
        if self.moe is None:
            return total
        m = self.moe
        n_moe_layers = self.n_layers - m.first_dense_layers
        per_expert = 3 * self.d_model * m.d_expert
        inactive = n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return total - inactive


def _leaves(tree) -> List[Tuple[int, ...]]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Layer pattern
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerKind:
    mixer: str                     # "attn" | "attn_local" | "mamba" | "shared_attn"
    ffn: str                       # "dense" | "moe" | "none"


@dataclass(frozen=True)
class LayerPlan:
    """How the n_layers stack maps onto prefix + stacked body + suffix.

    The port runs every layer in one Python loop; the plan is kept because
    the reference's parameter and cache trees are laid out by it.
    """

    kinds: Tuple[LayerKind, ...]
    prefix: int
    period: int
    n_groups: int

    @property
    def suffix(self) -> int:
        return len(self.kinds) - self.prefix - self.period * self.n_groups

    @property
    def suffix_start(self) -> int:
        return self.prefix + self.period * self.n_groups


def layer_plan(cfg: ModelConfig) -> LayerPlan:
    kinds: List[LayerKind] = []
    for i in range(cfg.n_layers):
        if cfg.ssm is not None and cfg.hybrid_attn_every:
            if (i + 1) % cfg.hybrid_attn_every == 0:
                kinds.append(LayerKind("shared_attn", "dense"))
            else:
                kinds.append(LayerKind("mamba", "none"))
        elif cfg.ssm is not None:
            kinds.append(LayerKind("mamba", "none"))
        elif cfg.global_every:
            if (i + 1) % cfg.global_every == 0:
                kinds.append(LayerKind("attn", "dense"))
            else:
                kinds.append(LayerKind("attn_local", "dense"))
        else:
            ffn = "dense"
            if cfg.moe is not None and i >= cfg.moe.first_dense_layers:
                ffn = "moe"
            local = cfg.sliding_window is not None and cfg.global_every is None
            kinds.append(LayerKind("attn_local" if local else "attn", ffn))
    prefix = 0
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        prefix = cfg.moe.first_dense_layers
    body = kinds[prefix:]
    period, n_groups = len(body), 1 if body else 0
    for p in range(1, len(body) + 1):
        k = len(body) // p
        if k >= 1 and all(body[j] == body[j % p] for j in range(k * p)):
            period, n_groups = p, k
            break
    return LayerPlan(tuple(kinds), prefix, period, n_groups)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             gemma: bool = False) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if gemma else w.float()
    return (x * scale).to(dt)


# In bf16 the activations are written out as jax.nn writes them, op by op,
# so that they round where the reference rounds: its silu and gelu are
# chains of bf16 ops, each rounded (XLA's CPU backend fuses them and rounds
# every step all the same), where F.silu and F.gelu compute in fp32 and
# round once.  The one-rounding forms differ from the reference's by one
# bf16 step at about 40% of the elements (silu) and 1 in 3 (gelu), and
# through a stack of bf16 layers that grows past the tolerance.  In fp32
# every form is within an ulp of the reference's, and F.silu / F.gelu (one
# kernel, one saved tensor for the backward) are kept.

def _low_precision(x: torch.Tensor) -> bool:
    return x.dtype in (torch.bfloat16, torch.float16)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: in bf16 ``x * (1 / (1 + exp(-x)))``, rounded op by
    op."""
    if not _low_precision(x):
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation): in bf16 rounded op by op, its
    constants in x's type, as jax casts them."""
    if not _low_precision(x):
        return F.gelu(x, approximate="tanh")
    c0 = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    c1 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c0 * (x + c1 * (x * x * x)))))


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              act: str) -> torch.Tensor:
    """Feed-forward: gated (swiglu/geglu) or plain (relu2/gelu)."""
    if act in ("swiglu", "geglu"):
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        # jax.nn.gelu defaults to the tanh approximation
        h = (silu(g) if act == "swiglu" else gelu_tanh(g)) * u
    elif act == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
    elif act == "gelu":
        h = gelu_tanh(x @ p["w_up"])
    else:
        raise ValueError(act)
    return h @ p["w_down"]


def mlp_shapes(d_model: int, d_ff: int, act: str) -> Dict[str, Tuple[int, ...]]:
    if act in ("swiglu", "geglu"):
        return {
            "w_gate": (d_model, d_ff),
            "w_up": (d_model, d_ff),
            "w_down": (d_ff, d_model),
        }
    return {"w_up": (d_model, d_ff), "w_down": (d_ff, d_model)}


# ---------------------------------------------------------------------------
# Rotary embeddings (standard / partial / M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(
    x: torch.Tensor,                 # [B, S, H, D]
    positions: torch.Tensor,         # [B, S] or [3, B, S] for M-RoPE
    theta: float,
    partial: float = 1.0,
    mrope_sections: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    d = x.shape[-1]
    rot = int(d * partial)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    inv = rope_freqs(rot, theta, device=x.device)          # [rot/2]
    if mrope_sections is not None:
        assert positions.dim() == 3, \
            "M-RoPE expects positions [n_sections, B, S]"
        assert sum(mrope_sections) == rot // 2
        parts, start = [], 0
        for sec_i, sec in enumerate(mrope_sections):
            parts.append(positions[sec_i][..., None].float()
                         * inv[start:start + sec][None, None, :])
            start += sec
        ang = torch.cat(parts, dim=-1)                     # [B, S, rot/2]
    else:
        if positions.dim() == 3:
            positions = positions[0]
        ang = positions[..., None].float() * inv[None, None, :]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)        # [B, S, 1, rot/2]
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < d else out


# ---------------------------------------------------------------------------
# Parameter shapes & init
# ---------------------------------------------------------------------------

def attn_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "wq_a": (d, m.q_lora_rank),
            "q_norm": (m.q_lora_rank,),
            "wq_b": (m.q_lora_rank, hq * qk_dim),
            "wkv_a": (d, m.kv_lora_rank + m.qk_rope_head_dim),
            "kv_norm": (m.kv_lora_rank,),
            "wkv_b": (m.kv_lora_rank, hq * (m.qk_nope_head_dim + m.v_head_dim)),
            "wo": (hq * m.v_head_dim, d),
        }
    sh: Dict[str, Any] = {
        "wq": (d, hq * hd),
        "wk": (d, hkv * hd),
        "wv": (d, hkv * hd),
        "wo": (hq * hd, d),
    }
    if cfg.use_qk_norm:
        sh["q_norm"] = (hd,)
        sh["k_norm"] = (hd,)
    return sh


def mamba_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return {
        # in_proj -> [z (gate), x, B, C, dt]
        "w_in": (d, 2 * di + 2 * s.n_groups * s.d_state + nh),
        "conv_w": (s.d_conv, conv_dim),
        "conv_b": (conv_dim,),
        "A_log": (nh,),
        "D": (nh,),
        "dt_bias": (nh,),
        "gate_norm": (di,),
        "w_out": (di, d),
    }


def chunk_plan(n_experts: int, model_size: int) -> Tuple[int, int, int, int]:
    """Expert layout plan: (ep, tp, experts_per_chunk, n_chunks)."""
    if model_size <= 1:
        return 1, 1, n_experts, 1
    if n_experts >= model_size:
        assert n_experts % model_size == 0, (n_experts, model_size)
        return model_size, 1, n_experts // model_size, model_size
    assert model_size % n_experts == 0, (n_experts, model_size)
    tp = model_size // n_experts
    return n_experts, tp, 1, model_size


def moe_shapes(cfg: ModelConfig, model_size: int = 1) -> Dict[str, Any]:
    """Expert weights in chunked [n_chunks, n_e, d, f_c] layout (EP x TP)."""
    m = cfg.moe
    d = cfg.d_model
    ep, tp, n_e, nc = chunk_plan(m.n_experts, model_size)
    f_c = m.d_expert // tp
    sh: Dict[str, Any] = {
        "router": (d, m.n_experts),
        "experts": {
            "w_gate": (nc, n_e, d, f_c),
            "w_up": (nc, n_e, d, f_c),
            "w_down": (nc, n_e, f_c, d),
        },
    }
    if m.n_shared:
        sh["shared"] = mlp_shapes(d, m.d_shared * m.n_shared, "swiglu")
    return sh


def _layer_shapes(cfg: ModelConfig, kind: LayerKind,
                  model_size: int = 1) -> Dict[str, Any]:
    sh: Dict[str, Any] = {}
    if kind.mixer in ("attn", "attn_local"):
        sh["attn"] = attn_shapes(cfg)
        sh["ln_attn"] = (cfg.d_model,)
        if cfg.gemma_norm:
            sh["ln_post_attn"] = (cfg.d_model,)
    elif kind.mixer == "mamba":
        sh["mamba"] = mamba_shapes(cfg)
        sh["ln_mix"] = (cfg.d_model,)
    if kind.ffn == "dense":
        sh["mlp"] = mlp_shapes(cfg.d_model, cfg.d_ff, cfg.mlp_act)
        sh["ln_mlp"] = (cfg.d_model,)
        if cfg.gemma_norm:
            sh["ln_post_mlp"] = (cfg.d_model,)
    elif kind.ffn == "moe":
        sh["moe"] = moe_shapes(cfg, model_size)
        sh["ln_mlp"] = (cfg.d_model,)
    return sh


def _prefix_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, moe=None,
                               d_ff=cfg.moe.d_first_dense or cfg.d_ff)


def param_shapes(cfg: ModelConfig, model_size: int = 1) -> Dict[str, Any]:
    """The reference's parameter tree of shapes (group-stacked body).

    Same layout as :func:`repro.models.common.param_shapes`: ``embed``,
    ``prefix/layer{i}``, ``blocks/pos{j}`` with a leading ``n_groups`` axis,
    ``suffix/layer{k}``, ``shared_attn``, ``final_norm``, ``lm_head``.
    """
    plan = layer_plan(cfg)
    kinds, prefix = plan.kinds, plan.prefix
    tree: Dict[str, Any] = {"embed": (cfg.vocab_size, cfg.d_model)}
    if prefix:
        tree["prefix"] = {
            f"layer{i}": _layer_shapes(_prefix_cfg(cfg),
                                       LayerKind("attn", "dense"), model_size)
            for i in range(prefix)
        }
    tree["blocks"] = {
        f"pos{j}": _map_shapes(
            lambda s: (plan.n_groups,) + tuple(s),
            _layer_shapes(cfg, kinds[prefix + j], model_size))
        for j in range(plan.period)
    }
    if plan.suffix:
        tree["suffix"] = {
            f"layer{plan.suffix_start + i}": _layer_shapes(
                cfg, kinds[plan.suffix_start + i], model_size)
            for i in range(plan.suffix)
        }
    if any(k.mixer == "shared_attn" for k in kinds):
        tree["shared_attn"] = {"attn": attn_shapes(cfg),
                               "ln_attn": (cfg.d_model,)}
    tree["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return tree


def _map_shapes(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_param_shapes(cfg: ModelConfig, model_size: int = 1
                       ) -> List[Dict[str, Any]]:
    """Per-layer shape trees, in layer order (the port's layout); MoE
    experts in the chunked layout of ``model_size``."""
    plan = layer_plan(cfg)
    return [_layer_shapes(_prefix_cfg(cfg) if i < plan.prefix else cfg,
                          LayerKind("attn", "dense") if i < plan.prefix
                          else kind, model_size)
            for i, kind in enumerate(plan.kinds)]


_NORM_NAMES = ("gate_norm", "q_norm", "k_norm", "kv_norm", "final_norm",
               "ln_attn", "ln_mlp", "ln_mix", "ln_post_attn", "ln_post_mlp")


def _init_leaf(name: str, shape: Tuple[int, ...], cfg: ModelConfig,
               generator: torch.Generator, device, dtype) -> torch.Tensor:
    """One leaf as :func:`repro.models.common.init_params` draws it."""
    if name == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[-1], device=device)
                         ).expand(shape).to(dtype)
    if name == "D":
        return torch.ones(shape, device=device, dtype=dtype)
    if name == "dt_bias":
        return torch.full(shape, math.log(math.expm1(0.01)),
                          device=device).to(dtype)
    if name in _NORM_NAMES:
        if cfg.gemma_norm and (name.startswith("ln_") or name == "final_norm"):
            return torch.zeros(shape, device=device, dtype=dtype)
        return torch.ones(shape, device=device, dtype=dtype)
    if len(shape) == 1 or (len(shape) == 2 and shape[-1] == 1):
        return torch.zeros(shape, device=device, dtype=dtype)
    std = 1.0 / math.sqrt(shape[-2])
    w = torch.empty(shape, device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=std, a=-3 * std, b=3 * std,
                                generator=generator)
    return w.to(dtype)


def _init_tree(shapes, cfg, generator, device, dtype, name=""):
    if isinstance(shapes, dict):
        return {k: _init_tree(v, cfg, generator, device, dtype, k)
                for k, v in shapes.items()}
    return _init_leaf(name, tuple(shapes), cfg, generator, device, dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                dtype: torch.dtype = torch.float32,
                model_size: int = 1) -> Dict[str, Any]:
    """Random parameters in the port's layout, drawn as the reference does.

    Matrices: truncated normal in [-3, 3] standard deviations, std
    1/sqrt(fan_in) with fan_in = shape[-2]; vectors zero; norms one (zero
    under ``gemma_norm``); ``A_log`` = log(linspace(1, 16)), ``D`` = 1,
    ``dt_bias`` = softplus^-1(0.01).  ``generator`` must live on
    ``device``.  The draws differ from ``jax.random``'s: to compare with
    the reference, load its parameters with :func:`params_from_numpy`.
    """
    shapes = param_shapes(cfg)
    params: Dict[str, Any] = {
        "embed": _init_tree(shapes["embed"], cfg, generator, device, dtype,
                            "embed"),
        "layers": [_init_tree(s, cfg, generator, device, dtype)
                   for s in layer_param_shapes(cfg, model_size)],
        "final_norm": _init_tree(shapes["final_norm"], cfg, generator,
                                 device, dtype, "final_norm"),
    }
    for name in ("shared_attn", "lm_head"):
        if name in shapes:
            params[name] = _init_tree(shapes[name], cfg, generator, device,
                                      dtype, name)
    return params


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))        # a writable copy
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], device,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The reference's parameter tree (numpy leaves) -> the port's layout.

    ``blocks/pos{j}`` is unstacked along its group axis: group ``g`` of
    position ``j`` becomes layer ``prefix + g * period + j``.  Floating
    leaves are cast to ``dtype``.
    """
    plan = layer_plan(cfg)
    layers: List[Optional[Dict[str, Any]]] = [None] * cfg.n_layers
    for name, sub in tree.get("prefix", {}).items():
        layers[int(name.removeprefix("layer"))] = sub
    for j in range(plan.period):
        for g in range(plan.n_groups):
            layers[plan.prefix + g * plan.period + j] = _map_shapes(
                lambda a, g=g: np.asarray(a)[g], tree["blocks"][f"pos{j}"])
    for name, sub in tree.get("suffix", {}).items():
        layers[int(name.removeprefix("layer"))] = sub
    params: Dict[str, Any] = {
        "embed": _to_torch(tree["embed"], device, dtype),
        "layers": [_to_torch(layer, device, dtype) for layer in layers],
        "final_norm": _to_torch(tree["final_norm"], device, dtype),
    }
    for name in ("shared_attn", "lm_head"):
        if name in tree:
            params[name] = _to_torch(tree[name], device, dtype)
    return params
