"""Clean fixture for the port's dtype-drift pass: zero findings
expected."""

import dataclasses

import numpy as np
import torch

F32 = torch.float32


def keep_anchor(clock_us):
    return np.float64(clock_us)          # anchors STAY f64


def build(snapshot, clock_us):
    return snapshot.replace(clock_us=np.float64(clock_us))


def column_write(state, rows):
    state.pkt_count[rows] = np.float32(1.0)   # explicit f32: intended


def f32_columns(state, vals, dev):
    return dataclasses.replace(state, tokens=vals.double().float(),
                               t_last=torch.zeros(4, dtype=F32, device=dev))


def f32_inplace(state, idx, vals):
    state.backlog_until.index_copy_(0, idx, vals.to(torch.float32))


def offset_f32(elapsed_us):
    # an offset, not an anchor (runtime._f32's cast)
    return float(np.float32(elapsed_us))


def host_f64(deadlines):
    return np.asarray(deadlines, np.float64)   # f64 kept host side
