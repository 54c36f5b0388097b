"""Known-bad fixture for the port's host-sync pass (run with every
top-level function as a hot root): each line marked `# expect: sync`
must give a finding, and no other line may. Never imported — parsed
only."""

import numpy as np
import torch


def hot_tick(state):
    mirror = np.asarray(state.props)          # expect: sync
    v = float(state.tokens[0])                # expect: sync
    if state:                                 # expect: sync
        v += 1.0
    return mirror, v


def hot_transfers(state):
    total = state.tokens.sum()
    a = total.item()                          # expect: sync
    b = state.pkt_count.tolist()              # expect: sync
    c = state.props.cpu()                     # expect: sync
    d = state.t_last.to("cpu")                # expect: sync
    e = state.corr.to(device=torch.device("cpu"))  # expect: sync
    f = total.numpy()                         # expect: sync
    return a, b, c, d, e, f


def hot_waits(state):
    torch.cuda.synchronize()                  # expect: sync
    done = torch.cuda.Event()
    done.record()
    done.synchronize()                        # expect: sync
    torch.cuda.current_stream().synchronize()  # expect: sync
    return state


def hot_shapes(state):
    busy = state.tokens > 0
    idx = busy.nonzero()                      # expect: sync
    idx2 = torch.nonzero(state.active)        # expect: sync
    where1 = torch.where(busy)                # expect: sync
    sel = torch.masked_select(state.tokens, busy)  # expect: sync
    picked = state.tokens[busy]               # expect: sync
    uniq = torch.unique(state.pkt_count)      # expect: sync
    reps = torch.repeat_interleave(state.tokens, state.pkt_count)  # expect: sync
    reps2 = state.tokens.repeat_interleave(state.pkt_count)  # expect: sync
    if busy.any():                            # expect: sync
        picked = picked + 1
    return idx, idx2, where1, sel, picked, uniq, reps, reps2


def hot_loop(res):
    out = []
    for x in res:
        out.append(x.cpu())                   # expect: sync
    return out
