"""Known-bad fixture for the port's dtype-drift pass: each line marked
`# expect: dtype` must give a finding, and no other line may. Never
imported — parsed only."""

import dataclasses
import time

import numpy as np
import torch

F32 = torch.float32


def freeze_anchor(clock_us):
    return np.float32(clock_us)          # expect: dtype


def tensor_anchor(clock_us, dev):
    return torch.tensor(clock_us, dtype=torch.float32, device=dev)  # expect: dtype


def float_anchor(sim):
    return sim.clock_us.float()          # expect: dtype


def to_anchor(origin_us):
    return origin_us.to(torch.float32)   # expect: dtype


def alias_anchor(anchor_us):
    return anchor_us.to(dtype=F32)       # expect: dtype


def build(snapshot, dev):
    return snapshot.replace(
        clock_us=torch.zeros((), dtype=F32, device=dev))  # expect: dtype


def leak_into_column(state, rows):
    state.pkt_count[rows] = np.float64(1.0)  # expect: dtype


def f64_column(state, vals):
    return dataclasses.replace(state, tokens=vals.double())  # expect: dtype


def f64_column_dtype(state, dev):
    return dataclasses.replace(
        state, t_last=torch.zeros(4, dtype=torch.float64, device=dev))  # expect: dtype


def f64_inplace(state, idx, vals):
    state.backlog_until.index_copy_(0, idx, vals.to(torch.float64))  # expect: dtype


def f64_subscript(state, rows):
    state.tokens[rows] = time.time()     # expect: dtype
