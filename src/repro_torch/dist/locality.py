"""Roofline-based dispatch pricing — the DTD's SC decision in bytes.

The paper's Distributed Transaction Dispatching module prices two plans for
a transaction whose leases live on a remote replica:

* **forward** the transaction to the lease owner — one P2P message carrying
  the transaction (its inputs and, later, its result);
* **acquire** the leases at the origin — an atomic-broadcast round plus the
  ownership handoff, after which the state (here: KV cache / expert
  weights) crosses the wire.

The SC (short-career) policy compares fixed step constants; on hardware the
"steps" have sizes, so this module replaces them with *bytes over a known
interconnect* and divides by bandwidth.  ``prefer_migration`` below is
exactly the paper's "migrate the transaction" verdict: it becomes true as
soon as the state is heavier than the work description.

Interconnect constants are v5e-class defaults, intentionally shared with
:mod:`repro.launch.hlo_analysis` where they overlap (``ICI_BW``); they are
keyword-overridable everywhere so benchmarks can sweep them.

In the port these constants keep pricing a **simulated TPU pod** (v5e
HBM 819e9 B/s, DCN 25e9 B/s per pod pair): the serving slice is held key
for key to :mod:`repro.dist.locality`, so the numbers are the
reference's.  They are not measurements of the H100, and nothing that
``SimBackend`` prices from them is the card's speed.
"""
from __future__ import annotations

from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Interconnect hierarchy (bytes/s, per device unless noted)
# ---------------------------------------------------------------------------

HBM_BW = 819e9        # HBM read bandwidth per chip
ICI_BW = 50e9         # ICI, per link per direction (matches launch.hlo_analysis)
ICI_LINKS = 4         # v5e: 4 links per chip (2D torus)
PCIE_BW = 32e9        # host <-> device staging path
DCN_BW = 25e9         # cross-pod data-center network, per pod pair
DCN_RTT_S = 1e-3      # cross-pod round-trip (the paper's P2P step constant)


# ---------------------------------------------------------------------------
# Router defaults — the winning thresholds of benchmarks/serve_locality.py
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RouterDefaults:
    """Default knobs for :class:`repro.serve.router.LocalityRouter`.

    The values are the winners of the policy×arbitration sweep in
    ``benchmarks/serve_locality.py`` (8 pods, mixtral-8x7b KV sizes, 3
    seeds): ``short`` step costs for new-session placement with the priced
    byte model settling forward-vs-acquire (``priced``) ships the least
    wire of the grid — 14% less than step-constant arbitration at locality
    0.9 (wire_GB 0.012 vs 0.014), where it is also ~11% faster — with no
    tokens/s regression at locality 0.0.
    """

    policy: str = "short"          # DTD cost policy: "local"|"short"|"long"
    arbitration: str = "priced"    # "steps" | "priced" | "hybrid"
    # constraint (3) threshold, re-swept against the fixed CpuMeter
    # (benchmarks/overload.py --sweep-max-cpu; see DTDConfig.max_cpu)
    max_cpu: float = 0.9
    freq_tau_ms: float = 500.0     # LC access-frequency decay constant


ROUTER_DEFAULTS = RouterDefaults()


# ---------------------------------------------------------------------------
# Session dispatch: forward the request vs. migrate the KV state
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SessionDispatchCost:
    """Priced plans for serving one session step on a non-owner pod.

    ``migrate_work_s``  — forward the request to the KV owner (paper: migrate
    the transaction to the lease owner).  ``migrate_state_s`` — ship the KV
    cache to the origin and take ownership (paper: lease acquisition).
    ``prefer_migration`` is True when forwarding the work wins.

    ``state_hop_bytes`` is the heaviest single src-shard → dst-shard hop of
    the state move: when the KV cache is seq-sharded over ``seq_shards``
    devices per pod, the shards cross the DCN in parallel over distinct NIC
    pairs, so the move serializes on ``state_bytes / seq_shards`` per hop
    (``state_bytes`` stays the total put on the wire).
    """

    migrate_work_s: float
    migrate_state_s: float
    work_bytes: float
    state_bytes: float
    prefer_migration: bool
    state_hop_bytes: float = -1.0     # default: filled to state_bytes

    def __post_init__(self):
        if self.state_hop_bytes < 0:
            object.__setattr__(self, "state_hop_bytes", self.state_bytes)

    @property
    def wire_bytes(self) -> float:
        """Bytes the *chosen* plan puts on the DCN."""
        return self.work_bytes if self.prefer_migration else self.state_bytes


def price_session_dispatch(
    prompt_tokens: float,
    decode_tokens: float,
    kv_state_bytes: float,
    *,
    wire_bytes_per_token: float = 2.0,
    handoff_bytes: float = 512.0,
    dcn_bw: float = DCN_BW,
    rtt_s: float = DCN_RTT_S,
    seq_shards: float = 1,
) -> SessionDispatchCost:
    """Price forwarding a session's work vs. migrating its KV state.

    ``prompt_tokens``/``decode_tokens`` describe the work that would cross
    the wire if the request is forwarded (the callers may equivalently pass
    pre-scaled byte counts with ``wire_bytes_per_token=1``);
    ``kv_state_bytes`` is the session's KV-cache footprint, plus a fixed
    ``handoff_bytes`` for the ownership record — the paper's AB+URB round.
    Both plans pay one ``rtt_s``, so the verdict reduces to bytes.

    ``seq_shards`` > 1 models a seq-sharded cache column (the long-context
    layout of :mod:`repro.dist.sharding`): the column leaves as ``seq_shards``
    parallel shard-to-shard transfers, so the state plan serializes on
    ``1/seq_shards`` of the KV bytes per hop.  Fractional values are the
    byte-weighted effective divisor of a partially-sharded cache (hybrid
    attn+mamba trees — see ``KVStore.seq_shards``).  Total wire bytes are
    unchanged — only the time (and therefore the verdict) moves.
    """
    seq_shards = max(1.0, float(seq_shards))
    work_bytes = (prompt_tokens + decode_tokens) * wire_bytes_per_token
    state_bytes = kv_state_bytes + handoff_bytes
    state_hop_bytes = kv_state_bytes / seq_shards + handoff_bytes
    migrate_work_s = rtt_s + work_bytes / dcn_bw
    migrate_state_s = rtt_s + state_hop_bytes / dcn_bw
    return SessionDispatchCost(
        migrate_work_s=migrate_work_s,
        migrate_state_s=migrate_state_s,
        work_bytes=work_bytes,
        state_bytes=state_bytes,
        prefer_migration=migrate_work_s < migrate_state_s,
        state_hop_bytes=state_hop_bytes,
    )


# ---------------------------------------------------------------------------
# MoE dispatch: all-to-all the tokens vs. all-gather the experts
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEDispatchCost:
    """Priced plans for one MoE layer under ``ep_degree``-way sharding.

    ``dispatch_s`` — all-to-all the routed tokens to their expert owners and
    combine back (migrate the work to the state).  ``allgather_s`` — gather
    every expert's weights to every device (migrate the state to the work).
    ``prefer_dispatch`` is the token-a2a verdict.
    """

    dispatch_s: float
    allgather_s: float
    dispatch_bytes: float
    allgather_bytes: float
    prefer_dispatch: bool

    @property
    def wire_bytes(self) -> float:
        return self.dispatch_bytes if self.prefer_dispatch else self.allgather_bytes


def price_moe_dispatch(
    tokens_per_device: int,
    d_model: int,
    top_k: int,
    n_experts: int,
    d_expert: int,
    ep_degree: int,
    *,
    tp_degree: int = 1,
    bytes_per_elem: float = 2.0,
    link_bw: float = ICI_BW,
    n_links: int = ICI_LINKS,
) -> MoEDispatchCost:
    """Price token all-to-all vs. expert all-gather for one MoE layer.

    Per device and per layer: the a2a plan moves each routed token activation
    out and its expert output back (``2 × T × top_k × d_model`` elements,
    scaled by the off-device fraction); the all-gather plan moves the three
    expert matrices of every non-resident expert
    (``3 × n_experts × d_model × d_expert`` elements, same fraction).
    Token traffic scales with batch, weight traffic doesn't — so dispatch
    wins at serving batch sizes and the crossover tracks ``ep_degree``.

    ``tp_degree`` > 1 is the chunked (deepseek-style) layout where each
    expert's FFN is split ``tp``-ways over the model ranks: every routed
    token is dispatched to all ``tp`` chunk ranks of its expert group and
    comes back as ``tp`` f-slice partials that the sender psums — the
    partial-activation psum term — so both a2a legs scale by ``tp_degree``
    while the off-device fraction is taken over all ``ep × tp`` shards.
    At ``tp_degree == 1`` this reduces to the whole-expert formula.
    """
    tp_degree = max(1, int(tp_degree))
    shards = ep_degree * tp_degree
    off_device = (shards - 1) / shards if shards > 1 else 0.0
    dispatch_bytes = (
        2.0 * tokens_per_device * top_k * d_model * bytes_per_elem
        * tp_degree * off_device
    )
    allgather_bytes = (
        3.0 * n_experts * d_model * d_expert * bytes_per_elem * off_device
    )
    bw = link_bw * n_links
    return MoEDispatchCost(
        dispatch_s=dispatch_bytes / bw,
        allgather_s=allgather_bytes / bw,
        dispatch_bytes=dispatch_bytes,
        allgather_bytes=allgather_bytes,
        # one shard: every expert is already whole and local — nothing migrates
        prefer_dispatch=shards > 1 and dispatch_bytes <= allgather_bytes,
    )
