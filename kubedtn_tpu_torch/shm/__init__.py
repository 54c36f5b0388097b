"""Shared-memory ingest plane: native SPSC ring transport between
producer processes and the daemon, in place of the per-frame gRPC hop
for co-located producers.

Port of kubedtn_tpu/shm.

- `ring`: mmap'd segment handle over the `kdt_shm_*` C implementation
  (seqlock-style commit words; a crashed producer can never publish a
  torn frame).
- `ingest`: the daemon side, feeding `drain_ingress` columnar spans
  — admission evaluated at the ring head, backlog folded into the
  adaptive-budget signal, trace ids riding the slot layout.
- `sender`: producer-side handle with the `_PeerSender` outage-buffer
  discipline (ring-full queues, never drops).
- `producer`: `python -m kubedtn_tpu_torch.shm.producer` — the real
  subprocess used by bench soaks and the producer-crash chaos
  scenario.

gRPC (unary/stream/bulk) remains the compatibility fallback and the
control-RPC surface; everything downstream of the drain is
transport-blind.
"""

from kubedtn_tpu_torch.shm.ingest import ShmIngest
from kubedtn_tpu_torch.shm.ring import (DEFAULT_SLOT_SIZE, DEFAULT_SLOTS,
                                  RING_SUFFIX, ShmRing, ShmRingError)
from kubedtn_tpu_torch.shm.sender import ShmSender

__all__ = [
    "DEFAULT_SLOTS",
    "DEFAULT_SLOT_SIZE",
    "RING_SUFFIX",
    "ShmIngest",
    "ShmRing",
    "ShmRingError",
    "ShmSender",
]
