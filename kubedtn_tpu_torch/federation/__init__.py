"""Federated serving planes with zero-loss live tenant migration.

Port of kubedtn_tpu/federation (its migration half): many daemons, each
a multi-tenant (optionally sharded) plane, and a migration layer that
moves tenants between them without losing a frame. See
federation.migrate for the crash-safe migration state machine and
federation.journal for its checkpoint-grade record persistence. The
fleet supervisor and its placement ledger (the JAX package's
federation/{supervisor,placement}.py) are not ported yet;
`FederationController.placement_hook` stays None until they are.
"""

from kubedtn_tpu_torch.federation.migrate import (STEPS,
                                                  FederationController,
                                                  MigrationCoordinator,
                                                  MigrationError,
                                                  MigrationStats,
                                                  PlaneHandle,
                                                  restore_tenant_slice,
                                                  stats_for)

__all__ = ["STEPS", "FederationController", "MigrationCoordinator",
           "MigrationError", "MigrationStats", "PlaneHandle",
           "restore_tenant_slice", "stats_for"]
