"""Federated serving planes with zero-loss live tenant migration, under
a fleet supervisor.

Port of kubedtn_tpu/federation: many daemons, each a multi-tenant
(optionally sharded) plane, a migration layer that moves tenants between
them without losing a frame, and a supervisor that watches the planes'
health, keeps the tenant→plane ledger and evacuates a dead plane's
tenants onto survivors. See federation.migrate for the crash-safe
migration state machine, federation.journal for its checkpoint-grade
record persistence, federation.placement for the ledger and the
placement policy, and federation.supervisor for the suspicion machine,
the evacuation and the rolling upgrade. `FleetSupervisor.attach`
installs the controller's `placement_hook` and every daemon's `fleet`.
"""

from kubedtn_tpu_torch.federation.migrate import (STEPS,
                                                  FederationController,
                                                  MigrationCoordinator,
                                                  MigrationError,
                                                  MigrationStats,
                                                  PlaneHandle,
                                                  restore_tenant_slice,
                                                  stats_for)
from kubedtn_tpu_torch.federation.placement import (PlacementError,
                                                    PlacementLedger,
                                                    choose_plane,
                                                    plane_score,
                                                    rebalance_plan)
from kubedtn_tpu_torch.federation.supervisor import (FleetError,
                                                     FleetStats,
                                                     FleetSupervisor,
                                                     fork_from_checkpoint,
                                                     grpc_probe)

__all__ = ["STEPS", "FederationController", "FleetError", "FleetStats",
           "FleetSupervisor", "MigrationCoordinator", "MigrationError",
           "MigrationStats", "PlacementError", "PlacementLedger",
           "PlaneHandle", "choose_plane", "fork_from_checkpoint",
           "grpc_probe", "plane_score", "rebalance_plan",
           "restore_tenant_slice", "stats_for"]
