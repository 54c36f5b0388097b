from kubedtn_tpu_torch.topology.engine import SimEngine, uid_from_vni, vni_from_uid
from kubedtn_tpu_torch.topology.reconciler import Reconciler, ReconcileResult, calc_diff
from kubedtn_tpu_torch.topology.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    TopologyStore,
    WatchEvent,
    retry_on_conflict,
)

__all__ = [
    "SimEngine",
    "Reconciler",
    "ReconcileResult",
    "calc_diff",
    "TopologyStore",
    "WatchEvent",
    "ConflictError",
    "NotFoundError",
    "AlreadyExistsError",
    "retry_on_conflict",
    "vni_from_uid",
    "uid_from_vni",
]
