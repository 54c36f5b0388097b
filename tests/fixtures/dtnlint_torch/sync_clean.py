"""Clean fixture for the port's host-sync pass (every top-level
function a hot root): hot code that stays future-shaped — metadata
reads, host lists and numpy arrays, identity tests, three-argument
`where`, integer repeats, gathers and masked fills."""

import numpy as np
import torch


def hot_tick(state, lens):
    e = state.props.shape[0]             # metadata: no transfer
    arr = np.asarray(lens, np.uint64)    # host list → host array
    if state is None:                    # identity test: no coercion
        return None
    return e, arr


def hot_device_only(state, rows, host):
    n = state.tokens.numel()                       # metadata method
    k = int(state.props.shape[1])                  # coerced metadata
    busy = state.tokens > 0
    kept = torch.where(busy, state.tokens, 0.0)    # three-argument where
    per_slot = state.tokens.repeat_interleave(4, dim=0)   # int repeats
    sized = torch.repeat_interleave(state.tokens, state.pkt_count,
                                    output_size=64)
    gathered = state.tokens.index_select(0, rows)  # index gather
    zeroed = state.tokens.masked_fill(busy, 0.0)   # mask, fixed shape
    m = host > 0
    h = host[m]                                    # numpy mask indexing
    if n > 0 and k > 0:                            # host ints
        h = h + 1
    done = torch.cuda.Event()
    done.record()                                  # records, no wait
    return kept, per_slot, sized, gathered, zeroed, h, done


def hot_host_copy(outs):
    # host arrays the completion already waited for
    return [np.asarray(x) for x in outs]
