"""dtnlint pass registry: rule tag → pass module (each exposes
``run(project, graph) -> list[Finding]``)."""

from __future__ import annotations

from kubedtn_tpu_torch.analysis.passes import (
    dtype_drift,
    host_sync,
    hygiene,
    key_discipline,
    lock_discipline,
    traced_purity,
)

PASSES = {
    "purity": traced_purity.run,
    "key": key_discipline.run,
    "sync": host_sync.run,
    "lock": lock_discipline.run,
    "dtype": dtype_drift.run,
    "hygiene": hygiene.run,
}
