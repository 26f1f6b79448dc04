"""Lilac-TM core on PyTorch: the commit path of :mod:`repro.core`.

The same modules as the reference — lease management (Algorithm 1 and the
sharded batched manager), the DTD, the Transaction Forwarder, the TL2 STM,
the simulated GCS and the discrete-event cluster — with the replica version
tables, write-lock derivation and batched certification on a torch device —
and ``vec_sim``, the counterpart of the reference's vectorized sweep model
(``jax_sim``), with every sweep point batched on the device.
"""
from .conflict import ConflictClassMap
from .cluster import Cluster, Metrics, SimConfig, TxnSpec, Workload
from .dtd import DTD, DTDConfig, C_AB, C_P2P, C_URB
from .events import EventQueue
from .forwarder import CommitNotice, ForwardPolicy, ForwardRequest
from .gcs import GCSLatency, SimGCS
from .lease import ALCLeaseManager, FGLLeaseManager, LeaseRequest, LOR
from .stats import CpuMeter, DecayedFrequency
from .stm import Transaction, VersionedStore, validate_batch
from .workloads import BankWorkload, TpccConflictMap, TpccLayout, TpccWorkload
from . import vec_sim

ALGORITHMS = {
    # paper variant -> (lease_kind, dtd policy)
    "ALC": ("alc", "local"),
    "FGL": ("fgl", "local"),
    "MG-ALC": ("alc", "opt"),
    "LILAC-TM-ST": ("fgl", "short"),
    "LILAC-TM-LT": ("fgl", "long"),
    "LILAC-TM-OPT": ("fgl", "opt"),
}


def make_cluster(algorithm: str, workload, cfg: SimConfig = None, ccmap=None, **overrides):
    """Build a cluster configured for one of the paper's algorithm variants."""
    from dataclasses import replace

    lease_kind, policy = ALGORITHMS[algorithm]
    cfg = cfg or SimConfig()
    dtd = replace(cfg.dtd, policy=policy)
    cfg = replace(cfg, lease_kind=lease_kind, dtd=dtd, **overrides)
    return Cluster(cfg, workload, ccmap=ccmap)
