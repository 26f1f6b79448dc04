"""Plain float32 reference of the decoder stacks the benchmark runs: dense
GQA with SwiGLU (glm4-9b) and the Mamba2 hybrid with one shared attention
block and gated-GELU MLPs (zamba2-1.2b); their loss, gradients and
AdamW.

Written from the equations, in plain torch, with TF32 off.  It imports
neither the program nor JAX, and takes only what the benchmark made: the
configuration, the seed's weights and the seed's tokens.  It runs layer by
layer (no score matrix of more than ``SCORE_ELEMS`` elements, each layer
recomputed in the backward) so that it fits beside what stays on the card.

The equations are the program's model as it defines it (``PERF.md``
lists where that model departs from the published checkpoints):

* block: ``x + mixer(rms_norm(x))``, then ``x + mlp(rms_norm(x))`` where
  the layer has an MLP; final ``rms_norm`` and an untied head;
* attention: q, k, v projections, rotary on the first ``partial_rotary``
  of each head (halves rotated), causal softmax at ``head_dim ** -0.5``,
  kv heads shared by ``n_heads / n_kv_heads`` q heads, ``wo``;
* MLP: ``w_down(act(w_gate x) * w_up x)``, act SiLU or GELU (tanh form);
* Mamba2: ``w_in`` -> [z, x | B | C, dt]; a causal depthwise conv of
  ``d_conv`` taps and SiLU over x | B | C; dt = softplus(dt + dt_bias),
  A = -exp(A_log); the SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t
  x_t B_t^T, y_t = h_t C_t + D x_t; rms_norm(y * silu(z)); ``w_out``;
* the loss: mean cross entropy over the labels that are not negative.

``fp8=True`` is the control: every matrix product's operands are rounded
to float8 e4m3 with one scale a tensor (amax to 448), as an fp8 GEMM
path would take them; the rest stays in float32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

SCORE_ELEMS = 1 << 29          # fp32 score elements one attention block holds
NO_DECAY = ("norm", "ln_", "bias", "A_log", "dt_bias", "D")


class Float32:
    """TF32 off for the duration (restored on exit)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


# ---------------------------------------------------------------------------
# Products, in float32 or the fp8 control
# ---------------------------------------------------------------------------

def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at one scale (amax -> 448), straight through
    for the gradient."""
    with torch.no_grad():
        scale = 448.0 / t.detach().abs().amax().clamp_min(1e-30)
        r = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (r - t).detach()


def mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    a, b = a.float(), b.float()
    if fp8:
        a, b = _fp8(a), _fp8(b)
    return a @ b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * w.float()


def rope(x: torch.Tensor, theta: float, partial: float) -> torch.Tensor:
    """x ``[b, s, h, d]`` at positions 0..s-1."""
    s, d = x.shape[1], x.shape[-1]
    rot = int(d * partial)
    rot -= rot % 2
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                       device=x.device) / rot)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :,
                                                               None, :]
    x1, x2 = x[..., :rot // 2], x[..., rot // 2:rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                      x[..., rot:]], dim=-1)


def attention(p: Dict, x: torch.Tensor, m: Dict, fp8: bool) -> torch.Tensor:
    b, s, _ = x.shape
    hq, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = mm(x, p["wq"], fp8).view(b, s, hq, hd)
    k = mm(x, p["wk"], fp8).view(b, s, hkv, hd)
    v = mm(x, p["wv"], fp8).view(b, s, hkv, hd)
    partial = m.get("partial_rotary", 1.0)
    q, k = rope(q, m["rope_theta"], partial), rope(k, m["rope_theta"],
                                                    partial)
    g = hq // hkv
    qh = q.permute(0, 2, 1, 3).reshape(b, hkv, g, s, hd)
    kh, vh = k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3)  # [b,hkv,d,s], [b,hkv,s,d]
    if fp8:
        qh, kh, vh = _fp8(qh), _fp8(kh), _fp8(vh)
    rows = max(1, min(s, SCORE_ELEMS // (b * hq * s)))
    outs = []
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        sc = torch.einsum("bhgqd,bhdk->bhgqk", qh[:, :, :, r0:r1],
                          kh[..., :r1]) * hd ** -0.5
        mask = torch.arange(r1, device=x.device)[None, :] \
            <= torch.arange(r0, r1, device=x.device)[:, None]
        pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        if fp8:
            pr = _fp8(pr)
        outs.append(torch.einsum("bhgqk,bhkd->bhgqd", pr, vh[:, :, :r1]))
    o = torch.cat(outs, dim=3).reshape(b, hq, s, hd).permute(0, 2, 1, 3)
    return mm(o.reshape(b, s, hq * hd), p["wo"], fp8)


def mlp(p: Dict, x: torch.Tensor, m: Dict, fp8: bool) -> torch.Tensor:
    """Gated: SiLU (``swiglu``) or GELU's tanh form (``geglu``) of the
    gate, times the up projection."""
    g = mm(x, p["w_gate"], fp8)
    act = m.get("mlp_act", "swiglu")
    if act == "swiglu":
        g = F.silu(g)
    elif act == "geglu":
        g = F.gelu(g, approximate="tanh")
    else:
        raise ValueError(f"no reference for mlp_act {act!r}")
    return mm(g * mm(x, p["w_up"], fp8), p["w_down"], fp8)


def ssd(x, dt, a, bm, cm, chunk: int) -> torch.Tensor:
    """y of the SSD recurrence, x ``[b, s, h, p]``, dt ``[b, s, h]``, a
    ``[h]``, B and C ``[b, s, n]`` (one group), from a zero state: within
    each chunk the quadratic form, across chunks the carried state."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    pad = (-s) % chunk
    if pad:
        x, dt, bm, cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (x, dt, bm, cm))
    nc, L = (s + pad) // chunk, chunk
    x = x.reshape(b, nc, L, h, p)
    dt = dt.reshape(b, nc, L, h)
    bm, cm = bm.reshape(b, nc, L, n), cm.reshape(b, nc, L, n)
    cum = torch.cumsum(dt * a, dim=2)                          # [b,c,L,h]
    causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [b,c,t,u,h]
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    w = torch.einsum("bctn,bcun->bctu", cm, bm)[..., None] * decay \
        * dt[:, :, None, :, :]
    y = torch.einsum("bctuh,bcuhp->bcthp", w, x)
    ws = torch.exp(cum[:, :, -1:, :] - cum) * dt               # [b,c,L,h]
    states = torch.einsum("bcuh,bcuhp,bcun->bchpn", ws, x, bm)
    carry = x.new_zeros(b, h, p, n)
    entering = []
    for c in range(nc):
        entering.append(carry)
        carry = carry * torch.exp(cum[:, c, -1])[:, :, None, None] \
            + states[:, c]
    prev = torch.stack(entering, dim=1)                        # [b,c,h,p,n]
    y = y + torch.einsum("bctn,bchpn->bcthp", cm, prev) \
        * torch.exp(cum)[..., None]
    return y.reshape(b, nc * L, h, p)[:, :s]


def mamba(p: Dict, x: torch.Tensor, m: Dict, fp8: bool) -> torch.Tensor:
    sc, d = m["ssm"], m["d_model"]
    di = sc["expand"] * d
    hp, n = sc["head_dim"], sc["d_state"]
    nh = di // hp
    b, s, _ = x.shape
    z, xbc, dtr = torch.split(mm(x, p["w_in"], fp8), [di, di + 2 * n, nh],
                              dim=-1)
    k = sc["d_conv"]
    w = p["conv_w"].float()
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(xp[:, i:i + s] * w[i] for i in range(k)) + p["conv_b"].float()
    xs, bm, cm = torch.split(F.silu(conv), [di, n, n], dim=-1)
    dt = F.softplus(dtr + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    y = ssd(xs.reshape(b, s, nh, hp), dt, a, bm, cm, sc["chunk"])
    y = y.reshape(b, s, di) + xs * p["D"].float().repeat_interleave(hp)
    y = rms_norm(y * F.silu(z), p["gate_norm"], m.get("norm_eps", 1e-5))
    return mm(y, p["w_out"], fp8)


def layer_kinds(m: Dict) -> List[str]:
    n, every = m["n_layers"], m.get("hybrid_attn_every")
    if m.get("ssm") and every:
        return ["shared_attn" if (i + 1) % every == 0 else "mamba"
                for i in range(n)]
    return ["mamba" if m.get("ssm") else "attn"] * n


def block(m: Dict, kind: str, p: Dict, shared: Optional[Dict],
          x: torch.Tensor, fp8: bool) -> torch.Tensor:
    eps = m.get("norm_eps", 1e-5)
    if kind == "mamba":
        return x + mamba(p["mamba"], rms_norm(x, p["ln_mix"], eps), m, fp8)
    att = shared if kind == "shared_attn" else p
    x = x + attention(att["attn"], rms_norm(x, att["ln_attn"], eps), m, fp8)
    return x + mlp(p["mlp"], rms_norm(x, p["ln_mlp"], eps), m, fp8)


def _layer(params: Dict, i: int) -> Dict:
    """Layer ``i``'s leaves in float32 (a copy where they are held in
    another type)."""
    return {k: ({kk: vv.float() for kk, vv in v.items()}
                if isinstance(v, dict) else v.float())
            for k, v in params["layers"][i].items()}


def hidden(m: Dict, params: Dict, tokens: torch.Tensor, fp8: bool,
           grad: bool) -> torch.Tensor:
    """The last layer's output ``[b, s, d]`` in float32; with ``grad``
    each layer is recomputed in the backward."""
    x = params["embed"][tokens].float()
    shared = params.get("shared_attn")
    if shared is not None:
        shared = {"attn": {k: v.float() for k, v in shared["attn"].items()},
                  "ln_attn": shared["ln_attn"].float()}
    for i, kind in enumerate(layer_kinds(m)):
        if grad:
            x = checkpoint(lambda x, i=i, kind=kind: block(
                m, kind, _layer(params, i), shared, x, fp8), x,
                use_reentrant=False)
        else:
            x = block(m, kind, _layer(params, i), shared, x, fp8)
    return rms_norm(x, params["final_norm"], m.get("norm_eps", 1e-5))


@torch.no_grad()
def last_logits(m: Dict, params: Dict, tokens: torch.Tensor,
                fp8: bool = False) -> torch.Tensor:
    """Float32 logits ``[b, vocab]`` at the last position of each row."""
    with Float32():
        x = hidden(m, params, tokens, fp8, grad=False)[:, -1]
        return mm(x, params["lm_head"], fp8)


def loss(m: Dict, params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         fp8: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy over labels >= 0."""
    x = hidden(m, params, tokens, fp8, grad=True)
    logits = mm(x, params["lm_head"], fp8)
    keep = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    return ((lse - picked) * keep).sum() / keep.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# AdamW with a global clip, warmup and cosine decay
# ---------------------------------------------------------------------------

def body_layers(m: Dict) -> range:
    """The layers a group-stacked layout would stack: the longest run of
    whole repetitions of the layer pattern's period from layer 0."""
    kinds = layer_kinds(m)
    for p in range(1, len(kinds) + 1):
        k = len(kinds) // p
        if all(kinds[j] == kinds[j % p] for j in range(k * p)):
            return range(0, p * k)
    return range(0)


def decayed(m: Dict, path: tuple, ndim: int) -> bool:
    """Whether AdamW decays the leaf at ``path``: not where its name holds
    a no-decay part, nor where it has one dimension, a layer of the body
    counting the dimension its stacked layout adds."""
    stacked = len(path) > 1 and path[0] == "layers" and path[1] in \
        body_layers(m)
    if any(t in str(path[-1]) for t in NO_DECAY):
        return False
    return ndim + (1 if stacked else 0) > 1


def learning_rate(o: Dict, step: int) -> float:
    warm = min(1.0, (step + 1) / max(1, o["warmup_steps"]))
    t = min(1.0, max(0.0, (step - o["warmup_steps"])
                     / max(1, o["total_steps"] - o["warmup_steps"])))
    decay = o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5 \
        * (1 + math.cos(math.pi * t))
    return o["lr"] * warm * decay


def adamw(m: Dict, o: Dict, leaves: List[Tuple[tuple, torch.Tensor]],
          grads: List[torch.Tensor], mom: List[torch.Tensor],
          vel: List[torch.Tensor], step: int) -> List[torch.Tensor]:
    """One step in place; returns the clipped gradients."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(o["clip_norm"] / torch.clamp(norm, min=1e-9),
                        max=1.0)
    b1, b2 = o["betas"]
    lr = learning_rate(o, step)
    c1, c2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
    clipped = []
    with torch.no_grad():
        for (path, p), g, mt, vt in zip(leaves, grads, mom, vel):
            g = g * scale
            clipped.append(g)
            mt.mul_(b1).add_((1 - b1) * g)
            vt.mul_(b2).add_((1 - b2) * g * g)
            upd = (mt / c1) / (torch.sqrt(vt / c2) + o["eps"])
            if decayed(m, path, p.dim()):
                upd = upd + o["weight_decay"] * p
            p.sub_(lr * upd)
    return clipped


def train(m: Dict, o: Dict, params: Dict, batches: List[Dict[str, Any]],
          leaf_paths: List[tuple], fp8: bool = False) -> Dict[str, Any]:
    """Steps over ``batches`` from ``params`` (float32 leaves, updated in
    place).  Returns each step's loss and the first step's clipped
    gradient norm of each leaf."""
    leaves = [(path, _get(params, path)) for path in leaf_paths]
    for _, p in leaves:
        p.requires_grad_(True)
    mom = [torch.zeros_like(p) for _, p in leaves]
    vel = [torch.zeros_like(p) for _, p in leaves]
    losses, first = [], None
    with Float32():
        for step, batch in enumerate(batches):
            value = loss(m, params, batch["tokens"], batch["labels"], fp8)
            grads = torch.autograd.grad(value, [p for _, p in leaves],
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for (_, p), g in zip(leaves, grads)]
            losses.append(float(value.detach()))
            clipped = adamw(m, o, leaves, grads, mom, vel, step)
            if first is None:
                first = [float(torch.linalg.vector_norm(g)) for g in clipped]
            del grads, clipped, value
    for _, p in leaves:
        p.requires_grad_(False)
    return {"losses": losses, "grad_norms": first}


def _get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree
