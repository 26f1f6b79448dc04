"""Multi-pod serving engine: continuous batching + locality routing.

Two backends behind one engine:

* :class:`RealBackend` — actually decodes with the model (per-session
  positions, KV slots), one :class:`~repro_torch.serve.kvcache.KVStore`
  per pod on the run context's device (the card by default).
* :class:`SimBackend` — prices each pod-step with the roofline model;
  used by the pod-scale benchmarks where 256-chip pods are simulated.
  Its constants (``HBM_BW`` = 819e9 B/s a chip, 256 chips a pod, the DCN
  of :mod:`repro_torch.dist.locality`) are the reference's simulated TPU
  pod, kept so that the port equals :mod:`repro.serve.engine` key for
  key: ``tokens_per_s`` is that priced pod's, never the H100's speed.

Per engine step: (1) the geo load-balancer assigns incoming requests to
origin pods, (2) the :class:`LocalityRouter` (the paper's DTD) picks
local/forward/acquire per request, applying KV-state migrations, (3) each
pod certifies its forwarded batch in one :mod:`repro_torch.serve.certifier`
validate dispatch (stale lease epochs re-route), (4) each pod runs one
batched decode over its active sessions, (5) queue depths feed back as
the CPU_i statistic.

With a :class:`repro_torch.plan.PlacementPlanner` attached, a sixth phase
runs every ``plan.epoch_ms`` of simulated time: the planner scores all
[session, pod] moves in one evaluation on its device (a side CUDA stream on
the card) over the router's touch affinity and executes the bounded plan
*between* steps — zero-byte lease prefetches for cacheless sessions, KV
re-homes for misplaced ones — with wire time priced onto the pod busy clocks
exactly like reactive moves. The router's constraint-(3) panic-acquire is
disabled in this mode (rebalancing is the planner's job; see
``LocalityRouter.planned``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dist.locality import DCN_RTT_S, HBM_BW, price_session_dispatch
from ..models import decoder
from ..obs.metrics import MetricSet, MonotonicSampler
from ..obs.trace import TraceRecorder
from .certifier import StepCertifier
from .kvcache import KVStore
from .router import LocalityRouter, RouteDecision

# router-clock advance per decode step when the backend reports no decode
# time (RealBackend): keeps DecayedFrequency decaying deterministically
REAL_STEP_MS = 1.0


@dataclass
class Request:
    sid: int
    origin: int                  # pod chosen by the geo load balancer
    n_tokens: int = 8            # decode tokens requested


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class SimBackend:
    """Roofline-priced pod: decode time = max(weights, cache) HBM reads."""

    def __init__(self, cfg, pod_chips: int = 256) -> None:
        self.cfg = cfg
        self.pod_chips = pod_chips
        self.weight_bytes = cfg.active_param_count() * 2.0
        self.lengths: Dict[Tuple[int, int], int] = {}   # (pod, sid) -> len

    def ensure(self, pod: int, sid: int, length: int) -> None:
        self.lengths[(pod, sid)] = max(self.lengths.get((pod, sid), 0), length)

    def drop(self, pod: int, sid: int) -> int:
        return self.lengths.pop((pod, sid), 0)

    def decode_time_s(self, pod: int, sids: List[int],
                      kv_bytes_per_token: float) -> float:
        if not sids:
            return 0.0
        cache = sum(self.lengths.get((pod, s), 0) for s in sids) * kv_bytes_per_token
        t_w = self.weight_bytes / self.pod_chips / HBM_BW
        t_c = cache / self.pod_chips / HBM_BW
        return max(t_w, t_c)

    def step(self, pod: int, sids: List[int]) -> None:
        for s in sids:
            self.lengths[(pod, s)] = self.lengths.get((pod, s), 0) + 1


class RealBackend:
    """Actual decode on ``ctx.device`` (one KVStore per pod).

    Each ``step`` is one ``decoder.decode_step`` over all ``n_slots`` of the
    pod's store with ``[B]`` positions and one argmax copied back.  As in
    the reference, a slot the pod does not decode this step still steps (at
    position 0, token 0), and ``alloc`` does not clear a recycled slot:
    ``ensure`` only sets the new session's ``length`` on it.
    """

    def __init__(self, cfg, ctx, params, n_pods: int, n_slots: int,
                 max_len: int) -> None:
        self.cfg, self.ctx, self.params = cfg, ctx, params
        self.stores = [KVStore(cfg, n_slots, max_len, device=ctx.device,
                               mesh=getattr(ctx, "mesh", None))
                       for _ in range(n_pods)]
        # seq shards per pod mesh: the engine re-prices actual-byte state
        # moves with this, so a seq-sharded migration charges 1/seq_shards
        # of the bytes per hop
        self.seq_shards = self.stores[0].seq_shards

    def ensure(self, pod: int, sid: int, length: int) -> None:
        st = self.stores[pod]
        if not st.has(sid):
            s = st.alloc(sid)
            s.length = length

    def transfer(self, src: int, dst: int, sid: int) -> float:
        """Move a session's KV column between pods; returns bytes shipped."""
        st = self.stores[src]
        if not st.has(sid):
            self.ensure(dst, sid, 0)
            return 0.0
        blob = st.export_session(sid)
        st.free(sid)
        self.stores[dst].import_session(blob)
        return self.stores[dst].nbytes_session()

    def drop(self, pod: int, sid: int) -> int:
        st = self.stores[pod]
        n = st.sessions[sid].length if st.has(sid) else 0
        st.free(sid)
        return n

    def step(self, pod: int, sids: List[int]) -> Dict[int, int]:
        """One batched decode for the pod's sessions; returns new tokens."""
        st = self.stores[pod]
        if not sids:
            return {}
        tokens = np.zeros((st.n_slots,), np.int32)
        pos = np.zeros((st.n_slots,), np.int32)
        for sid in sids:
            s = st.sessions[sid]
            tokens[s.slot] = s.last_token
            pos[s.slot] = s.length
        dev = st.device
        logits, st.caches = decoder.decode_step(
            self.cfg, self.ctx, self.params, st.caches,
            torch.from_numpy(tokens).to(dev), torch.from_numpy(pos).to(dev))
        nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        out = {}
        for sid in sids:
            s = st.sessions[sid]
            s.last_token = int(nxt[s.slot])
            s.length += 1
            out[sid] = s.last_token
        return out


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class EngineMetrics(MetricSet):
    """Fleet counters + per-pod breakdown + token-latency histograms,
    all on one repro_torch.obs registry.

    Attribute access (``m.forwards += 1``) keeps working via the
    MetricSet facade; the registry additionally carries per-pod
    ``pod{p}.forwards/local/wire_bytes`` counters and per-pod
    ``pod{p}.token_lat_s`` histograms (plus the fleet-wide one), which
    ``as_dict`` surfaces as p50/p90/p99 and a ``per_pod`` table — the
    attribution the ROADMAP's SLO-gated trace benchmark reads.
    """

    FIELDS = {
        "steps": 0, "tokens": 0, "sim_time_s": 0.0, "wire_bytes": 0.0,
        "transfers": 0, "forwards": 0, "local": 0,
        "plan_epochs": 0,        # planner invocations
        "plan_moves": 0,         # planned session re-homes executed
        "plan_prefetches": 0,    # planned zero-byte lease prefetches
        "plan_bytes": 0.0,       # state shipped by planned moves
        "plan_block_s": 0.0,     # host wall-time planning spent ON the token
        # path (begin dispatch + finish harvest; sync mode pays the full
        # scoring wait here, async mode only the dispatch + a drained
        # harvest) — sampled through obs.metrics.MonotonicSampler, the one
        # sanctioned wall-clock seam
    }

    def __init__(self, n_pods: int = 0, cert: Optional[object] = None,
                 registry=None) -> None:
        super().__init__(registry)
        # certification counters live in the StepCertifier (single source
        # of truth); as_dict merges them when the engine links it here
        self.cert = cert
        self.n_pods = n_pods
        reg = self.registry
        for p in range(n_pods):
            reg.counter(f"pod{p}.forwards")
            reg.counter(f"pod{p}.local")
            reg.counter(f"pod{p}.wire_bytes", 0.0)
            reg.histogram(f"pod{p}.token_lat_s")
        reg.histogram("token_lat_s")

    # -- per-pod attribution -------------------------------------------------
    def pod_add(self, pod: int, name: str, n=1) -> None:
        self.registry.counter(f"pod{pod}.{name}").value += n

    def observe_token_latency(self, pod: int, lat_s: float,
                              n: int = 1) -> None:
        """Record ``n`` tokens decoded at ``pod`` whose step latency was
        ``lat_s`` (the pod's full busy time for that step: wire + certify
        + decode — what a request experiences per token)."""
        self.registry.histogram("token_lat_s").observe(lat_s, n)
        if 0 <= pod < self.n_pods:
            self.registry.histogram(f"pod{pod}.token_lat_s").observe(
                lat_s, n)

    def token_latency(self, pod: Optional[int] = None):
        """The (per-pod) token-latency histogram, for quantile/SLO reads."""
        name = "token_lat_s" if pod is None else f"pod{pod}.token_lat_s"
        return self.registry.histogram(name)

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "steps": self.steps, "tokens": self.tokens,
            "sim_time_s": self.sim_time_s,
            "tokens_per_s": self.tokens / max(1e-9, self.sim_time_s),
            "wire_GB": self.wire_bytes / 1e9,
            "transfers": self.transfers, "forwards": self.forwards,
            "local": self.local,
            "plan_epochs": self.plan_epochs, "plan_moves": self.plan_moves,
            "plan_prefetches": self.plan_prefetches,
            "plan_GB": self.plan_bytes / 1e9,
            "plan_block_s": self.plan_block_s,
        }
        reg = self.registry
        fleet = reg.histogram("token_lat_s")
        for label, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
            v = fleet.quantile(q)
            out[f"token_lat_{label}_s"] = 0.0 if v is None else v
        per_pod: Dict[int, Dict[str, Any]] = {}
        for p in range(self.n_pods):
            h = reg.histogram(f"pod{p}.token_lat_s")
            p50, p99 = h.quantile(0.5), h.quantile(0.99)
            per_pod[p] = {
                "forwards": reg.counter(f"pod{p}.forwards").value,
                "local": reg.counter(f"pod{p}.local").value,
                "wire_GB": reg.counter(f"pod{p}.wire_bytes").value / 1e9,
                "token_lat_p50_s": 0.0 if p50 is None else p50,
                "token_lat_p99_s": 0.0 if p99 is None else p99,
            }
        out["per_pod"] = per_pod
        if self.cert is not None:
            out.update(self.cert.as_dict())
        return out


class MultiPodEngine:
    def __init__(self, n_pods: int, backend, router: LocalityRouter,
                 certifier: Optional[StepCertifier] = None,
                 planner=None, sanitize: bool = False,
                 plan_async: bool = True, trace=None,
                 device="cuda") -> None:
        self.n_pods = n_pods
        self.backend = backend
        self.router = router
        # repro_torch.obs tracing: pass a TraceRecorder (or True for a fresh
        # one); None/False keeps every site a single dead branch.  Spans
        # are stamped from the deterministic pod busy clocks / router
        # tick clock, so traced and untraced runs are byte-identical.
        if trace is True:
            trace = TraceRecorder()
        elif trace is False:
            trace = None
        self.trace = trace
        # the sanctioned wall-clock seam for plan_block_s (host scoring
        # time is genuinely wall time; everything else here is simulated)
        self._mono = MonotonicSampler()
        # forwarded requests are certified at the owning pod in one batch
        # per engine step (the paper's commit phase at the lease owner);
        # a certifier built here keeps its epoch store on ``device``
        self.certifier = certifier or StepCertifier(
            n_pods, sanitize=sanitize, device=device)
        if self.certifier.sanitize and self.certifier.owner_of is None:
            # owner-at-drain cross-check reads the router's live ownership
            self.certifier.owner_of = \
                lambda sid: self.router.owner.get(sid, -1)
        # optional proactive placement planner (repro_torch.plan): shares the
        # router's clock/stats implementation and takes over rebalancing.
        # plan_async overlaps each epoch's scoring with the following
        # decode step (kick at the epoch boundary, harvest at the next
        # step's start).  A harvested plan equals the synchronous plan at
        # its kick (every input is snapshotted there), but it is applied
        # one step later, so async and sync runs differ, as in the reference
        self.planner = planner
        self.plan_async = plan_async
        self._plan_clock_ms = 0.0
        self._pending_plan = None
        if planner is not None:
            router.planned = True
            router.affinity = planner.affinity
        self.queues: List[List[Request]] = [[] for _ in range(n_pods)]
        self.session_len: Dict[int, int] = {}
        self.session_home: Dict[int, int] = {}
        # (latency, serialization) charges per pod since its last step,
        # split from the priced wire_s; settled in run_step
        self._pending_wire: List[List[Tuple[float, float]]] = \
            [[] for _ in range(n_pods)]
        # per-pod busy clocks: pods decode independently (no cross-pod
        # barrier), so simulated wall time is the busiest pod's clock
        self._pod_clock = np.zeros((n_pods,), np.float64)
        self.metrics = EngineMetrics(n_pods=n_pods,
                                     cert=self.certifier.metrics)

    def submit(self, req: Request) -> RouteDecision:
        m = self.metrics
        length = self.session_len.get(req.sid, 0)
        dec = self.router.route(req.origin, req.sid, length)
        src = req.origin if dec.action == "forward" else -1
        if dec.action == "acquire":
            src = self.session_home.get(req.sid, dec.target)
            if src != dec.target:
                shipped = self._move_session_state(
                    req.sid, src, dec.target, length)
                if hasattr(self.backend, "transfer") \
                        and shipped > dec.wire_bytes:
                    # the real cache column outweighed the router's
                    # estimate: re-price the state move with actual bytes
                    # (seq-sharded columns move in parallel shard hops)
                    repriced = price_session_dispatch(
                        0.0, 0.0, shipped, handoff_bytes=0.0,
                        seq_shards=getattr(self.backend, "seq_shards", 1))
                    dec = dataclasses.replace(
                        dec, wire_bytes=shipped,
                        wire_s=repriced.migrate_state_s)
                m.transfers += 1
        elif dec.action == "forward":
            m.forwards += 1
            m.pod_add(dec.target, "forwards")
        else:
            m.local += 1
            m.pod_add(dec.target, "local")
        tr = self.trace
        if tr is not None:
            if dec.action == "acquire":
                # the lease/ownership round + state landing, priced as
                # wire_s; rendered on the acquiring pod's lease track
                tr.span("lease-acquire", f"pod{dec.target}/lease",
                        self.router._now, 1e3 * dec.wire_s, sid=req.sid)
            elif dec.action == "forward":
                tr.instant("route-forward", "router", ts=self.router._now,
                           sid=req.sid, target=dec.target)
            else:
                tr.instant("route-local", "router", ts=self.router._now,
                           sid=req.sid, target=dec.target)
        # the ownership round stamps the session's lease epoch at every
        # pod (idempotent when ownership didn't move): forwards still in
        # flight with an older epoch fail certification and re-route
        self.certifier.bump(req.sid, dec.epoch)
        self.backend.ensure(dec.target, req.sid, length)
        self.session_home[req.sid] = dec.target
        if dec.action == "forward":
            # forwarded work is certified at the owner before it may decode:
            # it joins the pod's next per-step certification batch
            self.certifier.enqueue(dec.target, req, dec.epoch)
        else:
            self.queues[dec.target].append(req)
        m.wire_bytes += dec.wire_bytes
        if dec.wire_bytes > 0:
            m.pod_add(dec.target, "wire_bytes", dec.wire_bytes)
        if dec.wire_s > 0:
            # receiver waits out the RTT; byte serialization occupies the
            # NIC at both endpoints of the transfer
            serial_s = max(0.0, dec.wire_s - DCN_RTT_S)
            self._pending_wire[dec.target].append((DCN_RTT_S, serial_s))
            if 0 <= src < self.n_pods and src != dec.target:
                self._pending_wire[src].append((0.0, serial_s))
        return dec

    def _move_session_state(self, sid: int, src: int, dst: int,
                            length: int) -> float:
        """Physically relocate a session between pods — cache column plus
        its queued work (the lease carries the class's pending
        transactions with it, paper §2) — and return the bytes shipped
        (the router's estimate for drop-based backends).  Shared by the
        reactive acquire path and the planner's re-homes, so the two can
        never drift."""
        if hasattr(self.backend, "transfer"):
            shipped = self.backend.transfer(src, dst, sid)
        else:
            self.backend.drop(src, sid)
            shipped = length * self.router.kv_bytes_per_token
        self.backend.ensure(dst, sid, length)
        self.session_home[sid] = dst
        moved = [r for r in self.queues[src] if r.sid == sid]
        if moved:
            self.queues[src] = [r for r in self.queues[src] if r.sid != sid]
            self.queues[dst].extend(moved)
        return shipped

    def _wire_time_s(self, pod: int) -> float:
        """Settle the pod's transfers since its last step.

        Each entry is (latency, serialization) split out of the priced plan
        time from ``price_session_dispatch``.  Concurrent RPCs overlap
        their latency but serialize on the pod's NIC: one RTT (if the pod
        awaits any inbound data), summed byte time.
        """
        arrivals = self._pending_wire[pod]
        if not arrivals:
            return 0.0
        self._pending_wire[pod] = []
        return max(rtt for rtt, _ in arrivals) + sum(s for _, s in arrivals)

    def run_step(self) -> None:
        """One decode step on every pod over its queued sessions."""
        m = self.metrics
        # harvest the plan kicked at the previous step's epoch boundary:
        # its scoring ran on-device while that whole step decoded, so the
        # wait here is (near) zero — the overlapped epoch's landing point
        if self._pending_plan is not None:
            pending, self._pending_plan = self._pending_plan, None
            self._harvest_plan_epoch(pending)
        step_t = 0.0
        for pod in range(self.n_pods):
            t_base_ms = 1e3 * float(self._pod_clock[pod])
            # inbound KV/requests must land before the pod decodes them
            t_wire = self._wire_time_s(pod)
            pod_t = t_wire
            # certify the step's forwarded batch in one validate dispatch;
            # its time lands on the pod's busy clock (scaling with the
            # batch, not a per-request constant)
            passed, aborted, t_cert = self.certifier.drain(pod)
            n_cert = len(passed) + len(aborted)
            pod_t += t_cert
            self.queues[pod].extend(passed)
            for r in aborted:
                # the session was acquired away while the forward was in
                # flight: certification rejected the stale lease epoch —
                # re-route against the current ownership ledger
                if self.router.affinity is not None:
                    # cert aborts damp the pod's affinity: sessions whose
                    # forwards keep dying here are contended, not attracted
                    self.router.affinity.record_abort(
                        self.router._now, pod, (r.sid,))
                self.submit(r)
            reqs = self.queues[pod]
            t_dec = 0.0
            n_dec = 0
            if reqs:
                sids = []
                for r in reqs:
                    if r.n_tokens > 0:
                        sids.append(r.sid)
                sids = list(dict.fromkeys(sids))
                if hasattr(self.backend, "decode_time_s"):
                    t_dec = self.backend.decode_time_s(
                        pod, sids, self.router.kv_bytes_per_token)
                    pod_t += t_dec
                self.backend.step(pod, sids)
                for r in reqs:
                    r.n_tokens -= 1
                # the pod decodes each *session* once per step, however many
                # requests share it — advance session_len in lockstep with
                # the backend's cache length so KV migrations are priced on
                # real sizes
                for sid in sids:
                    self.session_len[sid] = self.session_len.get(sid, 0) + 1
                    m.tokens += 1
                n_dec = len(sids)
                # per-token latency at this pod this step: the busy time a
                # decoded token just experienced (wire + certify + decode)
                if pod_t > 0:
                    m.observe_token_latency(pod, pod_t, n_dec)
                self.queues[pod] = [r for r in reqs if r.n_tokens > 0]
            tr = self.trace
            if tr is not None:
                # the pod's step timeline: wire landing, certify batch,
                # decode — laid back-to-back on the pod's busy clock
                if t_wire > 0:
                    tr.span("wire", f"pod{pod}", t_base_ms, 1e3 * t_wire)
                if t_cert > 0:
                    tr.span("certify", f"pod{pod}",
                            t_base_ms + 1e3 * t_wire, 1e3 * t_cert,
                            batch=n_cert, aborts=len(aborted))
                if t_dec > 0:
                    tr.span("decode", f"pod{pod}",
                            t_base_ms + 1e3 * (t_wire + t_cert),
                            1e3 * t_dec, sessions=n_dec)
            self._pod_clock[pod] += pod_t
            step_t = max(step_t, pod_t)
        # pods run in parallel with no cross-pod barrier: simulated wall
        # time is the busiest pod's accumulated clock
        m.sim_time_s = float(np.max(self._pod_clock))
        dt_ms = 1000.0 * step_t if step_t > 0 else REAL_STEP_MS
        self.router.tick(dt_ms)
        m.steps += 1
        # queue depth -> CPU_i statistic for constraint (3): backlog relative
        # to the fleet mean, so the valve trips on genuine stragglers (~2x
        # the mean) instead of always flagging whichever pod is busiest
        depths = np.asarray([float(len(q)) for q in self.queues])
        cap = max(8.0, 2.0 * float(depths.mean()))
        self.router.observe_cpu(depths / cap)
        if self.planner is not None:
            self._plan_clock_ms += dt_ms
            if self._plan_clock_ms >= self.planner.cfg.epoch_ms:
                self._plan_clock_ms = 0.0
                if self.plan_async:
                    # kick now, harvest at the next step's start: the
                    # scoring (a side stream on the card) overlaps the
                    # coming decode step instead of stalling the loop here
                    self._pending_plan = self._begin_plan_epoch()
                else:
                    self._harvest_plan_epoch(self._begin_plan_epoch())

    # -- proactive placement (repro_torch.plan) -----------------------------
    def _begin_plan_epoch(self):
        """Snapshot the epoch's inputs and dispatch the [session, pod]
        scoring (one evaluation on the planner's device) without waiting
        on it."""
        from ..plan.score import price_move_costs

        self._mono.mark()
        r = self.router
        self.metrics.plan_epochs += 1
        n_cls = r.affinity.node.n_cols
        owner = np.full((n_cls,), -1, dtype=np.int32)
        state = np.zeros((n_cls,), dtype=np.float64)
        for sid, pod in r.owner.items():
            if sid < n_cls:
                owner[sid] = pod
                state[sid] = self.session_len.get(sid, 0) * r.kv_bytes_per_token
        work = np.full((n_cls,), r.request_bytes + r.response_bytes)
        fwd_cost, move_cost = price_move_costs(
            state, work, seq_shards=r.seq_shards)
        pending = self.planner.begin(r._now, owner, state, fwd_cost,
                                     move_cost, r.cpu)
        self.metrics.plan_block_s += self._mono.lap()
        tr = self.trace
        if tr is not None:
            # async epoch: opened at the kick, closed at the harvest — the
            # async scoring/decode overlap shows up as this span bracketing
            # the next step's pod spans
            tr.abegin("plan-epoch", "plan", pending.epoch, ts=r._now,
                      classes=int(n_cls))
        return pending

    def _harvest_plan_epoch(self, pending) -> None:
        """Materialize a kicked epoch's plan and execute it between steps
        (off the critical path).  Staleness guards re-check live ownership:
        a session acquired away (or evicted) since the kick keeps its
        snapshot move from firing."""
        r = self.router
        self._mono.mark()
        plan = self.planner.finish(pending)
        self.metrics.plan_block_s += self._mono.lap()
        executed = []
        for mv in plan.moves:
            if r.owner.get(mv.cc) == mv.src and mv.src != mv.dst:
                self._execute_move(mv.cc, mv.dst)
                executed.append(mv)
        self.planner.committed(executed)
        tr = self.trace
        if tr is not None:
            tr.aend("plan-epoch", "plan", pending.epoch, ts=r._now,
                    moves=len(executed))

    def _execute_move(self, sid: int, dst: int) -> None:
        """Planned lease prefetch / session re-home.

        Ownership and epoch semantics are identical to a reactive acquire
        (in-flight forwards against the old owner abort and re-route); the
        difference is *when*: between steps, with the state's wire time
        priced onto the endpoint pods' busy clocks instead of stalling a
        request."""
        r, m = self.router, self.metrics
        src = self.session_home.get(sid, r.owner[sid])
        epoch = r.apply_move(sid, dst)
        self.certifier.bump(sid, epoch)
        length = self.session_len.get(sid, 0)
        shipped = self._move_session_state(sid, src, dst, length) \
            if src != dst else 0.0
        tr = self.trace
        if shipped > 0:
            m.plan_moves += 1
            m.transfers += 1
            m.wire_bytes += shipped
            m.plan_bytes += shipped
            m.pod_add(dst, "wire_bytes", shipped)
            if tr is not None:
                tr.instant("plan-move", "plan", ts=r._now, sid=sid, dst=dst)
            priced = price_session_dispatch(
                0.0, 0.0, shipped, handoff_bytes=0.0,
                seq_shards=getattr(self.backend, "seq_shards", r.seq_shards))
            # off the critical path: nobody awaits this transfer, so its
            # RTT overlaps decode — only the byte serialization occupies
            # the endpoint NICs (contrast submit(), where the acquiring
            # pod waits out the RTT before it may decode the session)
            serial = max(0.0, priced.migrate_state_s - DCN_RTT_S)
            self._pending_wire[dst].append((0.0, serial))
            if 0 <= src < self.n_pods and src != dst:
                self._pending_wire[src].append((0.0, serial))
        else:
            m.plan_prefetches += 1
            if tr is not None:
                tr.instant("plan-prefetch", "plan", ts=r._now, sid=sid,
                           dst=dst)

    def evict_session(self, sid: int) -> None:
        """Retire a finished session everywhere it has state.

        Frees the cache column and queued work, drops its queued forwards
        from the certification batches (they would otherwise abort at drain
        and *resubmit*, resurrecting the session), and stamps the router's
        tombstone epoch into the certifier store — so a forward of the dead
        tenancy still on the wire fails certification, and a later recycle
        of the sid places at an epoch above the tombstone (see
        ``LocalityRouter.evict``).
        """
        home = self.session_home.pop(sid, None)
        self.session_len.pop(sid, None)
        for pod in range(self.n_pods):
            self.queues[pod] = [r for r in self.queues[pod] if r.sid != sid]
        if home is not None:
            self.backend.drop(home, sid)
        self.certifier.purge(sid)
        tomb = self.router.evict(sid)
        self.certifier.bump(sid, tomb)

    def drain(self, max_steps: int = 10_000) -> None:
        steps = 0
        while (any(self.queues) or self.certifier.has_pending()) \
                and steps < max_steps:
            self.run_step()
            steps += 1
