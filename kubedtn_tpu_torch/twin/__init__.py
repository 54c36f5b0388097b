"""What-if plane — batched snapshot-fork replica engine.

Port of kubedtn_tpu/twin. The live data plane answers "what IS the
network doing"; this package answers "what WOULD it do" — fork a
consistent snapshot of the running twin, apply N perturbed futures
(link degrades/failures, node blackholes, offered-load scaling,
property deltas), and advance all N replicas × T virtual ticks with the
replicas laid out as N x E rows of one state: every shaping slot of a
step is one launch of kernel K1 over all of them.

Layers:
- snapshot: consistent capture from a live plane / engine / sim /
  router state (crossing the pipeline flush() barrier — the runner
  never stops), and its snapshot files (save_snapshot /
  load_snapshot).
- spec: the perturbation vocabulary and its compilation into padded
  per-replica edit batches (device scatters, update_links semantics).
- engine: the batched replica engine — sim._finish_step /
  router._finish_router_step over the replica-major rows, on-device
  metric reductions (latency histogram against the telemetry bucket
  ladder, loss, throughput, queue occupancy), optional split of the
  lanes over the cards of a parallel/mesh replica mesh.
- report: ranking + rendering of a sweep.
- query: the daemon-side WhatIfRequest service surface.
"""

from kubedtn_tpu_torch.twin.engine import (SweepResult, run_sweep,
                                           run_sweep_routed)
from kubedtn_tpu_torch.twin.report import rank_results, render_report
from kubedtn_tpu_torch.twin.snapshot import (
    TwinSnapshot,
    load_snapshot,
    save_snapshot,
    snapshot_from_engine,
    snapshot_from_plane,
    snapshot_from_router,
    snapshot_from_sim,
)
from kubedtn_tpu_torch.twin.spec import (Perturbation, Scenario,
                                         compile_scenarios)

__all__ = [
    "Perturbation",
    "Scenario",
    "SweepResult",
    "TwinSnapshot",
    "compile_scenarios",
    "load_snapshot",
    "rank_results",
    "render_report",
    "run_sweep",
    "run_sweep_routed",
    "save_snapshot",
    "snapshot_from_engine",
    "snapshot_from_plane",
    "snapshot_from_router",
    "snapshot_from_sim",
]
