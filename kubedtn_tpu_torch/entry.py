"""Entry points of the port: the flagship shaping step and the 100k-link
Clos, the counterparts of __graft_entry__.entry() and bench.py's build().

`entry()` returns the drop-in shaping step over a k=8 fat-tree edge
state (80 switches, 256 links -> 512 directed rows in capacity 1024)
plus example arguments. On the card the step runs kernel K1.
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
