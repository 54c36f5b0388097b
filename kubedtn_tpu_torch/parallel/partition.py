"""Edge partitioner of the sharded live tick: block sharding along the
edge axis.

Port of kubedtn_tpu/parallel/partition.py's `shard_ranges` and
`shard_of_rows`. Shard s owns the contiguous row range
[s*E/S, (s+1)*E/S). A row is CROSS-SHARD for a tick when the shard that
owns it is not the shard that shapes its peer direction; its state rides
the mailbox ring (parallel/exchange.py) to every shard.
"""

from __future__ import annotations

import numpy as np


def shard_ranges(capacity: int, n_shards: int) -> list[tuple[int, int]]:
    """[(lo, hi)) row range per shard. Requires capacity % n_shards == 0."""
    if n_shards <= 0 or capacity % n_shards:
        raise ValueError(
            f"capacity {capacity} not divisible by {n_shards} shards")
    loc = capacity // n_shards
    return [(s * loc, (s + 1) * loc) for s in range(n_shards)]


def shard_of_rows(rows, capacity: int, n_shards: int) -> np.ndarray:
    """Owner shard per row (block sharding)."""
    loc = capacity // n_shards
    return np.asarray(rows, np.int64) // loc
