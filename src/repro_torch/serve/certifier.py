"""Batched certification of forwarded requests at the pod controller.

The serving analogue of the simulator's commit phase (Lilac-TM §3.2:
forwarded transactions are certified at the lease owner *without
re-execution*).  Sessions play the conflict classes; a session's *lease
epoch* — bumped by :class:`repro_torch.serve.router.LocalityRouter`
whenever ownership moves — plays the version stamp.  A forwarded request
snapshots the epoch at routing time; the owning pod certifies the step's
forwarded batch in ONE :func:`repro_torch.core.stm.validate_batch` call.
A certifier transaction reads one session and writes nothing, so the call
takes the drain route with no class view: on the card the ``drain`` kernel
flushes the pending epoch stamps into the device table and certifies in one
launch (W = 0, no owners), on the CPU its twin.  A request whose session
was acquired away while it was on the wire fails certification and is
re-routed with a fresh snapshot — the serving rendition of "the forwarded
transaction lost its lease".

The batch's validate time is priced into the pod's busy clock by a
roofline model that scales with the batch (one fixed kernel dispatch plus
gather/compare bytes), replacing any per-request certification constant.
``hbm_bw`` is the reference's simulated TPU pod (:data:`repro_torch.dist.
locality.HBM_BW`): the priced time is the simulation's, not the H100's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.stm import Transaction, VersionedStore, validate_batch
from ..dist.locality import HBM_BW
from ..obs.metrics import MetricSet

# fixed per-batch cost: kernel dispatch + result sync
CERT_DISPATCH_S = 20e-6
# packed bytes per read-set slot crossing HBM: item + snapshot version +
# gathered current version (int32 each)
CERT_BYTES_PER_SLOT = 12.0


class CertifierMetrics(MetricSet):
    """Certification counters on the repro_torch.obs registry.

    Attribute reads/writes (``m.batches += 1``) route to registry
    counters via the MetricSet facade; ``as_dict`` keeps the exact key
    set the engine has always merged into its own dict.
    """

    FIELDS = {"batches": 0, "certified": 0, "aborts": 0,
              "time_s": 0.0, "max_batch": 0}

    def as_dict(self) -> Dict[str, float]:
        return {
            "cert_batches": self.batches, "certified": self.certified,
            "cert_aborts": self.aborts, "cert_time_s": self.time_s,
            "cert_max_batch": self.max_batch,
        }


class StepCertifier:
    """Per-pod certification queues over a replicated session-epoch store.

    ``device`` holds the epoch store's device table ("cuda" by default;
    "cuda" without a card raises).  ``backend`` is kept for the
    reference's signature and takes ``"auto"`` only: the store's device
    picks the route.  ``jax_min`` keeps the reference's name: batches
    below it settle with the numpy loop (same verdicts, no device call).
    ``sanitize`` (with ``owner_of``) raises until the sanitizer is ported.
    """

    def __init__(self, n_pods: int, *, backend: str = "auto",
                 hbm_bw: float = HBM_BW,
                 dispatch_s: float = CERT_DISPATCH_S,
                 jax_min: int = 8, sanitize: bool = False,
                 owner_of=None, device="cuda") -> None:
        if backend != "auto":
            raise ValueError(f"backend {backend!r}: the port dispatches by "
                             "the store's device (backend='auto' only)")
        if sanitize:
            raise NotImplementedError(
                "StepCertifier(sanitize=True) is not ported yet: it comes "
                "with the runtime-analysis slice (ROADMAP queue 1 item 7)")
        self.n_pods = n_pods
        self.backend = backend
        self.hbm_bw = hbm_bw
        self.dispatch_s = dispatch_s
        # batches below this settle with the numpy loop (same verdicts,
        # no device call); tests force 1 to pin the packed path
        self.jax_min = jax_min
        # session-epoch store (grows in power-of-two steps); versions[sid]
        # is the session's current lease epoch, replicated at every pod —
        # the engine bumps it synchronously on acquire, standing in for the
        # AB+URB ownership round
        self.store = VersionedStore(64, device=device)
        self.pending: List[List[Tuple[object, int]]] = [
            [] for _ in range(n_pods)]
        # deferred epoch stamps: bump() appends here and the queue settles
        # through ONE VersionedStore.apply_batch scatter at the next store
        # read (drain / epoch), instead of a per-call apply_versioned —
        # the ownership round's writes ride the same array path as the
        # certification reads (and reach the device table inside the next
        # drain's launch)
        self._bumps: List[Tuple[int, int]] = []
        self.metrics = CertifierMetrics()

    # -- epoch store ---------------------------------------------------------
    def _ensure(self, sid: int) -> None:
        self.store.grow_to(sid + 1)

    def epoch(self, sid: int) -> int:
        self._ensure(sid)
        self._flush_bumps()
        return int(self.store.versions[sid])

    def bump(self, sid: int, epoch: int) -> None:
        """Ownership moved: stamp the session's new lease epoch (deferred
        to the next store read; ordering within the queue is preserved —
        ``apply_batch`` is last-writer-wins per item)."""
        self._ensure(sid)
        self._bumps.append((sid, epoch))

    def _flush_bumps(self) -> None:
        if not self._bumps:
            return
        self.store.apply_batch(
            [{sid: float(e)} for (sid, e) in self._bumps],
            [e for (_sid, e) in self._bumps])
        self._bumps = []

    def purge(self, sid: int) -> int:
        """Drop the evicted session's queued forwards everywhere; returns
        how many were dropped.  Without this an in-flight forward of a dead
        session would abort at drain and *resubmit*, resurrecting the
        session the caller just retired."""
        n = 0
        for pod in range(self.n_pods):
            kept = [(r, e) for (r, e) in self.pending[pod] if r.sid != sid]
            n += len(self.pending[pod]) - len(kept)
            self.pending[pod] = kept
        return n

    # -- the per-step batch --------------------------------------------------
    def enqueue(self, pod: int, req, epoch: int) -> None:
        """Queue a forwarded request for the pod's next certification batch."""
        self._ensure(getattr(req, "sid"))
        self.pending[pod].append((req, epoch))

    def has_pending(self) -> bool:
        return any(self.pending)

    def certify_time_s(self, n_txns: int, read_len: int = 1) -> float:
        """Roofline validate time for one batch: fixed dispatch + bytes.

        Scales with the batch (rows × packed read slots), not per request —
        the whole point of draining the step's forwards in one call.
        """
        if n_txns == 0:
            return 0.0
        return self.dispatch_s + (
            n_txns * max(1, read_len) * CERT_BYTES_PER_SLOT / self.hbm_bw)

    def drain(self, pod: int) -> Tuple[List, List, float]:
        """Certify the pod's queued forwards in one batch.

        Returns ``(passed_requests, aborted_requests, validate_time_s)``;
        aborted requests carried a stale lease epoch (the session was
        acquired away after routing) and must be re-routed by the caller.
        """
        entries = self.pending[pod]
        if not entries:
            self._flush_bumps()
            return [], [], 0.0
        self.pending[pod] = []
        self._flush_bumps()
        if len(entries) >= self.jax_min:
            txns = []
            for i, (req, epoch) in enumerate(entries):
                t = Transaction(txid=i + 1, origin=pod)
                t.log_read(req.sid, epoch)
                txns.append(t)
            ok = validate_batch(self.store, txns)
        else:
            ok = [int(self.store.versions[req.sid]) == epoch
                  for (req, epoch) in entries]
        m = self.metrics
        m.batches += 1
        m.max_batch = max(m.max_batch, len(entries))
        t_s = self.certify_time_s(len(entries))
        m.time_s += t_s
        passed = [req for (req, _), o in zip(entries, ok) if o]
        aborted = [req for (req, _), o in zip(entries, ok) if not o]
        m.certified += len(passed)
        m.aborts += len(aborted)
        return passed, aborted, t_s
