"""Multi-tenant serving plane — many topologies, one shared SoA.

Port of kubedtn_tpu/tenancy. Many independent topologies share ONE data
plane:

- **TenantRegistry** (registry.py): tenants map namespaces to a QoS
  class, admission quotas and (optionally) a reserved CONTIGUOUS edge
  block in the shared SoA, carved with parallel.partition.tenant_block
  so tenant blocks compose with shard blocks.
- **AdmissionController** (admission.py): host-side token buckets per
  tenant (frames/s + bytes/s) enforced at the DRAIN stage — an
  over-budget tenant's wires are skipped for the tick with a typed,
  metered ThrottleVerdict; frames stay queued, never silently dropped.
- **QoS classes** gold/silver/bronze scale the per-wire drain budget by
  1 / 0.5 / 0.25 under contention.
- **Per-tenant observability**: the telemetry window ring and the
  plane's cumulative counters slice per tenant (columnar ownership
  masks, exact through compact()'s renumbering) into the
  `kubedtn_tenant_*` series and the `Local.Tenant*` RPCs.

The ISOLATION CONTRACT: a tenant's delivered byte stream and telemetry
totals in a cohabited plane are BYTE-IDENTICAL to a solo plane running
only its topology with the same seed. The port's mechanism is the same
as the JAX package's: every row's draws are keyed by
engine.link_key_id (the link's declared identity, two words of the
Philox counter — ops/netem.py), never by batch composition or padding.
"""

from kubedtn_tpu_torch.tenancy.admission import (AdmissionController,
                                                 HostTokenBucket,
                                                 ThrottleVerdict)
from kubedtn_tpu_torch.tenancy.registry import (QOS_CLASSES, QOS_LEVELS,
                                                Tenant, TenantRegistry)

__all__ = [
    "QOS_CLASSES", "QOS_LEVELS", "Tenant", "TenantRegistry",
    "AdmissionController", "HostTokenBucket", "ThrottleVerdict",
]
