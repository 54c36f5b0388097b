"""The sampled exchange probe of the port's sharded live plane, on the
CPU: the counterpart of kubedtn_tpu/runtime.py's `_exchange_probe_for`
and its call in the dispatch (:1587-1588, :2845-2858).

On a plane sharded over 2 virtual CPU shards the probe runs on dispatches
1, 65, 129, ... (every 64th, counting from the first after
enable_sharding), each time on zero mailboxes of the dispatch's padded
row count ([R, NPROP + 3 + NCORR] f32 and [R, 3] i32); its output is the
plain ring's on those mailboxes; `shard_summary()["exchange_seconds"]`
carries its summed wall time rounded to 6 places, as JAX's does. An
unsharded plane, or one sharded over a single shard, never runs it.
"""

import numpy as np
import pytest
import torch

from kubedtn_tpu_torch.ops.edge_state import NCORR, NPROP
from kubedtn_tpu_torch.parallel import exchange as tpex

from test_torch_plane import DET_PROPS, DT, build, frames_for


def spy_probe(plane, calls: list):
    """Wrap the plane's probe: each call records the dispatch count, the
    mailboxes and the output."""
    probe = plane._exchange_probe

    def wrapped(fm, im):
        out = probe(fm, im)
        calls.append((plane._exchange_count, fm.clone(), im.clone(), out))
        return out

    plane._exchange_probe = wrapped


def feed_ticks(sc, ticks: int, seed: int = 3) -> int:
    """`ticks` explicit-clock ticks, each with frames on every wire (so
    each dispatches). Returns the dispatches counted by the plane."""
    rng = np.random.default_rng(seed)
    for t in range(ticks):
        for k, w in enumerate(sc.win):
            w.ingress.extend(frames_for(k, t % 256, 3, rng))
        sc.plane.tick(now_s=(t + 1) * DT)
        for w in sc.wout:
            w.egress.clear()
    assert sc.plane.tick_errors == 0
    return sc.plane._exchange_count


def test_probe_runs_on_every_64th_dispatch_and_equals_the_plain_ring():
    sc = build("torch", DET_PROPS, capacity=64)
    plane = sc.plane
    assert plane.enable_sharding(n_devices=2) == (torch.device("cpu"),) * 2
    calls = []
    spy_probe(plane, calls)
    n = feed_ticks(sc, 130)
    assert n == 130
    assert [c[0] for c in calls] == [1, 65, 129]
    assert plane.shard_exchange_runs == 3
    exch = tpex.make_ring_exchange(2)
    for _, fm, im, (fo, io) in calls:
        R = fm.shape[0]
        assert R > 0 and fm.shape == (R, NPROP + 3 + NCORR)
        assert im.shape == (R, 3) and im.dtype == torch.int32
        assert not fm.any() and not im.any()
        fw, iw = exch([fm, fm.clone()], [im, im.clone()])
        assert torch.equal(fo.view(torch.int32), fw[0].view(torch.int32))
        assert torch.equal(io, iw[0])
    summ = plane.shard_summary()
    assert summ["exchange_seconds"] == round(plane.shard_exchange_s, 6)
    assert plane.shard_exchange_s > 0
    # enable_sharding starts the count and the seconds afresh
    plane.enable_sharding(n_devices=2)
    assert plane._exchange_count == 0 and plane.shard_exchange_s == 0.0
    assert plane.shard_exchange_runs == 0


def test_probe_rows_are_the_dispatch_padded_rows():
    sc = build("torch", DET_PROPS, capacity=64)
    sc.plane.enable_sharding(n_devices=2)
    calls = []
    spy_probe(sc.plane, calls)
    seen = []
    orig = sc.plane._run_exchange_probe

    def rows_seen(rows):
        seen.append(rows)
        orig(rows)

    sc.plane._run_exchange_probe = rows_seen
    feed_ticks(sc, 1)
    assert seen == [calls[0][1].shape[0]]
    # the largest padded row count of the dispatch's class groups, on
    # runtime._pad_rows' ladder 1, 8, 64, ...: DET_PROPS' two TBF links
    # make a group of 2 busy rows, padded to 8
    assert seen == [8]


@pytest.mark.parametrize("shards", [None, 1])
def test_probe_never_runs_unsharded(shards):
    sc = build("torch", DET_PROPS, capacity=64)
    if shards is not None:
        sc.plane.enable_sharding(n_devices=shards)
    assert sc.plane._exchange_probe is None
    feed_ticks(sc, 70)
    assert sc.plane.shard_exchange_runs == 0
    assert sc.plane.shard_exchange_s == 0.0
    summ = sc.plane.shard_summary()
    if shards is None:
        assert summ == {"enabled": False, "mesh_shape": [1], "n_shards": 1}
    else:
        assert summ["exchange_seconds"] == 0.0
