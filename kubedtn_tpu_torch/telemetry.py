"""Link telemetry, device half: the per-edge window accumulator's layout
and the fold the live tick runs on every shaped class group.

Port of kubedtn_tpu/telemetry.py's device functions (`tel_matrix`,
`tel_accumulate`) and of the constants they and their readers share. The
host half (LinkTelemetry's window ring, the FlightRecorder) belongs to
the host live plane and comes with it.

The open window is an `[E, KCOLS]` float32 accumulator chained through
the tick like the dynamic edge-state columns. Each class group adds one
`[R, KCOLS]` row contribution at its rows with one row-indexed
`index_add_`. Rows are unique within a class group (padding rows, index
E, land on an extra row that is cut off), so every real row takes one
add per group: the sum is exact whatever order CUDA's atomics take.

The latency buckets are the reference daemon's request-duration ladder
(milliseconds) scaled to µs, with one overflow bin.
"""

from __future__ import annotations

import torch

from kubedtn_tpu_torch.ops.netem import scatter_rows

# The reference's bucket edges in ms (reference latency_histograms.go:15);
# a copy of kubedtn_tpu.metrics.metrics.BUCKETS.
BUCKETS = (0, 1, 5, 10, 20, 50, 100, 200, 500, 1000, 2000, 5000)

# Latency histogram bin upper edges in µs; one overflow bin at the end.
BUCKET_EDGES_US = tuple(float(b) * 1000.0 for b in BUCKETS[1:])
N_BINS = len(BUCKET_EDGES_US) + 1

# -- window column layout (the K axis of the [W, E, K] ring) -----------
T_TX = 0           # slots offered to the shaping kernels
T_DELIVERED = 1    # left the qdisc chain
T_BYTES = 2        # delivered bytes
T_DROP_LOSS = 3    # netem loss
T_DROP_QUEUE = 4   # TBF 50ms-queue overflow
T_CORRUPT = 5      # delivered but corrupt-flagged
T_LAT_SUM_US = 6   # sum of delivered shaping latency (µs)
T_QDEPTH = 7       # frames deferred to the holdback buffer (host-side)
T_HIST0 = 8        # first latency bucket; N_BINS buckets follow
KCOLS = T_HIST0 + N_BINS

COLUMN_NAMES = ("tx", "delivered", "bytes", "dropped_loss",
                "dropped_queue", "corrupted", "latency_sum_us",
                "queue_depth") + tuple(
                    f"lat_le_{int(e / 1000)}ms" for e in BUCKET_EDGES_US
                ) + ("lat_overflow",)

# -- per-slot cause codes (see ops/netem.cause_codes) ------------------
CAUSE_INVALID = 0    # padding / inactive lane
CAUSE_DELIVERED = 1
CAUSE_LOSS = 2       # netem loss
CAUSE_QUEUE = 3      # TBF queue overflow
CAUSE_NAMES = {CAUSE_INVALID: "invalid", CAUSE_DELIVERED: "delivered",
               CAUSE_LOSS: "dropped_loss", CAUSE_QUEUE: "dropped_queue"}


def init_acc(capacity: int, device) -> torch.Tensor:
    """A zero `[capacity, KCOLS]` open window on `device`."""
    return torch.zeros((capacity, KCOLS), dtype=torch.float32,
                       device=device)


def tel_matrix(sizes, valid, res, row_counts=None) -> torch.Tensor:
    """The per-row `[R, KCOLS]` window contribution of one shaped group:
    the compute half of `tel_accumulate`, computed replicated by every
    shard of the sharded tick, each of which adds only its owned rows."""
    f32 = torch.float32
    deliv = res.delivered.to(f32)
    vald = valid.to(f32)
    # delivered lanes' depart is finite, dropped lanes are +inf: the
    # where() keeps inf out of the sums (inf * 0 would be nan)
    lat = torch.where(res.delivered, res.depart_us, 0.0)
    if row_counts is not None:
        loss_r, queue_r, corr_r = row_counts
    else:
        loss_r = res.dropped_loss.to(f32).sum(1)
        queue_r = res.dropped_queue.to(f32).sum(1)
        corr_r = res.corrupted.to(f32).sum(1)
    # per-row CUMULATIVE bucket counts from `lat` (0 on non-delivered
    # lanes, which all land at 0 <= edge_j, so subtracting the per-row
    # non-delivered count corrects every cumulative at once); per-bin
    # counts are first differences, the overflow bin the remainder
    edges = torch.tensor(BUCKET_EDGES_US, dtype=f32, device=lat.device)
    deliv_total = deliv.sum(1)
    not_deliv = float(res.delivered.shape[1]) - deliv_total
    cum = ((lat[..., None] <= edges).sum(dim=1).to(f32)
           - not_deliv[:, None])                          # [R, 11]
    hist = torch.cat([cum[:, :1], cum[:, 1:] - cum[:, :-1],
                      (deliv_total - cum[:, -1])[:, None]], dim=1)
    return torch.cat([torch.stack([
        vald.sum(1),
        deliv_total,
        (sizes * deliv).sum(1),
        loss_r,
        queue_r,
        corr_r,
        lat.sum(1),
        torch.zeros_like(deliv_total),             # T_QDEPTH: host-side
    ], dim=1), hist], dim=1)                       # [R, KCOLS]


def tel_accumulate(acc, row_idx, sizes, valid, res, row_counts=None):
    """Fold one shaped group into the open window `acc` ([E, KCOLS]):
    ONE row-indexed index_add_ of `tel_matrix`; rows >= E (padding)
    drop. `res` is the group's ShapeResult ([R, K] leaves); `row_counts`
    the tick's (loss[R], queue[R], corrupt[R]) sums, reused when given.
    Returns a NEW accumulator; `acc` is not modified."""
    mat = tel_matrix(sizes, valid, res, row_counts=row_counts)
    return scatter_rows(acc, row_idx, mat, add=True)
