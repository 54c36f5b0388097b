"""Entry points of the port: the flagship shaping step and the 100k-link
Clos, the counterparts of __graft_entry__.entry() and bench.py's build(),
and the class groups of one live tick.

`entry()` returns the drop-in shaping step over a k=8 fat-tree edge
state (80 switches, 256 links -> 512 directed rows in capacity 1024)
plus example arguments. On the card the step runs kernel K1.
`build_live_tick` packs the groups that runtime.fused_tick (and its
sharded form, whose ring steps run kernel K4) shapes in one tick.
"""

from __future__ import annotations

import numpy as np
import torch

from kubedtn_tpu_torch import resolve_device
from kubedtn_tpu_torch.api.types import LinkProperties
from kubedtn_tpu_torch.models.topologies import (clos, fat_tree,
                                                 load_edge_list_into_state)
from kubedtn_tpu_torch.ops import netem

# BASELINE's 100k-link Clos (bench.py): 100 spines x 500 leaves, two
# parallel links per pair -> 200,000 directed rows in capacity 2^18.
N_SPINE, N_LEAF, LINKS_PER_PAIR = 100, 500, 2


def _build(device, capacity: int = 1024):
    props = LinkProperties(latency="10ms", jitter="1ms", loss="0.5",
                           rate="1Gbit")
    el = fat_tree(8, props)
    state, rows = load_edge_list_into_state(el, capacity=capacity,
                                            device=device)
    E = state.capacity
    sizes = torch.full((E,), 1500.0, dtype=torch.float32, device=device)
    have = torch.as_tensor(np.arange(E) < len(rows), device=device)
    t_arr = torch.zeros((E,), dtype=torch.float32, device=device)
    return el, state, sizes, have, t_arr


def entry(device=None):
    """(fn, example_args): one drop-in shaping step (netem+TBF over every
    edge) on the flagship fat-tree, without donating the state. `device`
    None means the CUDA card."""
    dev = resolve_device(device)
    _, state, sizes, have, t_arr = _build(dev)
    generator = torch.Generator(device=dev).manual_seed(0)

    def fwd(state, sizes, have, t_arr, generator):
        return netem.shape_step_nodonate(state, sizes, have, t_arr,
                                         generator)

    return fwd, (state, sizes, have, t_arr, generator)


def link_key_id(row: int) -> int:
    """A stable 64-bit key id for a row: a multiplicative hash of it,
    standing in for the engine's (pod, uid) link identity."""
    return ((int(row) + 1) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF


def build_live_tick(el, state, n_rows_per_class: int, k_slots: int, seed,
                    device=None) -> dict:
    """One live tick's class groups over the topology `el` loaded in
    `state` (rows 0..2L-1, as load_edge_list_into_state places them).

    The rows' properties are first rewritten with one UpdateLinks
    (`random_link_props(2L, seed)`), in thirds, one per kernel class:
    the first third stays as drawn (rate > 0, iid: the max-plus TBF
    class), the second gets rate 0 (slot-independent), the last
    loss_corr 25 % and reorder 1 % (sequential). `state` is updated in
    place. Then `n_rows_per_class` busy rows are drawn from each third,
    each with 1..`k_slots` frames of 64-1500 bytes (one row with
    exactly k_slots), and packed by runtime._build_group onto `device`
    (None = the CUDA card). Returns {"tbf": quad, "seq": quad, "ind":
    quad}: the (row_idx, sizes, valid, key_ids) groups of one tick."""
    from kubedtn_tpu_torch import runtime
    from kubedtn_tpu_torch.models.topologies import random_link_props
    from kubedtn_tpu_torch.ops import edge_state as es

    dev = resolve_device(device)
    n = 2 * el.n_links
    third = n // 3
    props = random_link_props(n, seed)
    props[third:2 * third, es.P_RATE_BPS] = 0.0
    props[2 * third:, es.P_LOSS_CORR] = 25.0
    props[2 * third:, es.P_REORDER_PROB] = 1.0
    es.update_links(state, np.arange(n, dtype=np.int32), props,
                    np.ones(n, dtype=bool), contiguous=True)
    ranges = {"tbf": (0, third), "ind": (third, 2 * third),
              "seq": (2 * third, n)}
    predicate = {"tbf": netem.tbf_batch_rows,
                 "ind": netem.slot_independent_rows,
                 "seq": lambda p: ~netem.tbf_batch_rows(p)
                 & ~netem.slot_independent_rows(p)}
    rng = np.random.default_rng(seed)
    batches, groups = [], {}
    for kind, (lo, hi) in ranges.items():
        if not bool(predicate[kind](props[lo:hi]).all()):
            raise AssertionError(f"rows [{lo}, {hi}) are not all {kind}")
        rows = np.sort(rng.choice(np.arange(lo, hi), n_rows_per_class,
                                  replace=False))
        counts = rng.integers(1, k_slots + 1, n_rows_per_class)
        counts[0] = k_slots
        groups[kind] = list(range(len(batches),
                                  len(batches) + n_rows_per_class))
        for r, m in zip(rows, counts):
            lens = rng.integers(64, 1501, m).astype(np.float32)
            batches.append((None, int(r), lens, None, False))
    keyid_map = {b[1]: link_key_id(b[1]) for b in batches}
    return {kind: runtime._build_group(batches, groups[kind],
                                       state.capacity, keyid_map, dev)
            for kind in ("tbf", "seq", "ind")}


def build_clos_100k(device=None):
    """The 100k-link Clos loaded on `device` (None = the CUDA card):
    returns (edge list, state, rows), as bench.py's build()."""
    dev = resolve_device(device)
    el = clos(N_SPINE, N_LEAF, hosts_per_leaf=0,
              props=LinkProperties(latency="10ms", rate="10Gbit"),
              links_per_pair=LINKS_PER_PAIR)
    if el.n_links != 100_000:
        raise AssertionError(f"expected 100,000 links, got {el.n_links}")
    state, rows = load_edge_list_into_state(el, device=dev)
    return el, state, rows
