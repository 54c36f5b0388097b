"""The port's edge-sharded simulation step (kubedtn_tpu_torch/parallel/
sharded.py) on the CPU: against the JAX package's `make_sharded_step` on
the forced 8-device CPU mesh (tests/conftest.py), and against the port's
own unsharded step, bit for bit, on 1, 2, 4 and 8 virtual CPU shards.

Both packages shape from one numpy state with the same [E, NU]
uniforms: the JAX step draws them from its key over the whole edge axis
(`jax_threefry_partitionable` makes the sharded draws the unsharded
ones, tests/test_sharded.py), and the port is handed them as `u`. Ints,
flags and counts match exactly; float state within rtol 1e-6 / atol
1e-3, departures within rtol 1e-5 / atol 1e-2, node bytes within rtol
1e-6 (the JAX package sums them in f32 and psums, the port exactly).

Also here: `partition.mailbox_layout` against the JAX function on random
inputs, and `entry.dryrun_multichip(8, device="cpu")` with the JAX
entry's invariants and OK line.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedtn_tpu.ops import netem as jnetem
from kubedtn_tpu.parallel import mesh as jmesh
from kubedtn_tpu.parallel import partition as jpart
from kubedtn_tpu.parallel import sharded as jsh
from kubedtn_tpu_torch import convert, entry
from kubedtn_tpu_torch.api.types import LinkProperties
from kubedtn_tpu_torch.ops import edge_state as tes
from kubedtn_tpu_torch.ops import netem as tnetem
from kubedtn_tpu_torch.ops.cuda import shaping
from kubedtn_tpu_torch.parallel import partition as tpart
from kubedtn_tpu_torch.parallel import sharded as tsh
from kubedtn_tpu_torch.parallel.mesh import make_mesh, shard_edge_state

from test_torch_netem import (assert_results_close, assert_states_close,
                              jax_state, random_state_np, step_inputs,
                              torch_state)

N_NODES = 64          # random_state_np's node ids lie in [0, 64)
CAPACITY = 256        # 32 rows per shard on the 8-device mesh
STAT_FIELDS = [f.name for f in dataclasses.fields(tsh.NodeStats)]


def batch_np(seed: int, B: int = 48, dups: bool = False):
    """One UpdateLinks batch: rows across every shard, random props, a
    tenth of the lanes invalid; with `dups` a few rows appear twice."""
    rng = np.random.default_rng(seed + 7)
    rows = rng.choice(CAPACITY, B, replace=False).astype(np.int32)
    if dups:
        rows[B // 2:B // 2 + 6] = rows[:6]
    props = random_state_np(B, seed + 11)["props"]
    valid = rng.random(B) < 0.9
    return rows, props, valid


def jax_run(d, rows, props, valid, sizes, have, t_arr, key):
    m = jmesh.make_mesh(8)
    js = jmesh.shard_edge_state(jax_state(d), m)
    step = jsh.make_sharded_step(m, N_NODES)
    return step(js, jnp.asarray(rows), jnp.asarray(props),
                jnp.asarray(valid), jnp.asarray(sizes), jnp.asarray(have),
                jnp.asarray(t_arr), key)


def torch_run(d, S, rows, props, valid, sizes, have, t_arr, u):
    mesh = make_mesh(["cpu"] * S)
    shards = shard_edge_state(torch_state(d), mesh)
    step = tsh.make_sharded_step(mesh, N_NODES)
    return step(shards, rows, props, valid, torch.as_tensor(sizes),
                torch.as_tensor(have), torch.as_tensor(t_arr),
                u=torch.as_tensor(u))


def assert_stats_match_jax(j, t):
    for name in STAT_FIELDS:
        want = np.asarray(getattr(j, name))
        got = getattr(t, name).numpy()
        if name.endswith("bytes"):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_step_matches_jax_sharded_step(devices8, seed):
    d = random_state_np(CAPACITY, seed)
    rows, props, valid = batch_np(seed)
    sizes, have, t_arr, _ = step_inputs(CAPACITY, seed)
    key = jax.random.key(seed + 3)
    js, jres, jstats = jax_run(d, rows, props, valid, sizes, have, t_arr,
                               key)
    u = np.asarray(jax.random.uniform(key, (CAPACITY, jnetem.NU),
                                      jnp.float32))
    ts, tres, tstats = torch_run(d, 8, rows, props, valid, sizes, have,
                                 t_arr, u)
    assert_states_close(js, convert.unshard(ts))
    assert_results_close(jres, convert.unshard(tres))
    assert_stats_match_jax(jstats, tstats)
    assert int(np.asarray(jres.delivered).sum()) > 0
    assert float(tstats.dropped.sum()) > 0


def unsharded_step(state, rows, props, valid, sizes, have, t_arr, u):
    """What the sharded step computes, on the whole state: update_links,
    the drop-in step (shape_step_auto's route) and the node counters."""
    state = tes.update_links(state, rows, props, valid)
    state, res = shaping.shape_step(state, sizes, have, t_arr, u,
                                    donate=True)
    stats = tsh.make_node_stats_fn(make_mesh(["cpu"]), N_NODES)(
        [state.src], [state.dst], [res.delivered], [sizes],
        [res.dropped_loss | res.dropped_queue])
    return state, res, stats


def same_bits(a, b, name):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            same_bits(getattr(a, f.name), getattr(b, f.name),
                      f"{name}.{f.name}")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, name
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), name


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sharded_step_equals_unsharded_bitwise(S):
    """Three chained steps, each a batch with duplicate rows, on S
    virtual CPU shards == the unsharded step on the same draws, bit for
    bit: state, ShapeResult and NodeStats."""
    d = random_state_np(CAPACITY, 40 + S)
    mesh = make_mesh(["cpu"] * S)
    shards = shard_edge_state(torch_state(d), mesh)
    whole = torch_state(d)
    step = tsh.make_sharded_step(mesh, N_NODES)
    g_sh = torch.Generator().manual_seed(S)
    g_un = torch.Generator().manual_seed(S)
    for i in range(3):
        rows, props, valid = batch_np(10 * S + i, dups=True)
        sizes, have, t_arr, _ = (torch.as_tensor(x) for x in
                                 step_inputs(CAPACITY, i))
        shards, res, stats = step(shards, rows, props, valid, sizes, have,
                                  t_arr, g_sh)
        u = torch.rand((CAPACITY, tnetem.NU), generator=g_un)
        whole, res_u, stats_u = unsharded_step(whole, rows, props, valid,
                                               sizes, have, t_arr, u)
        same_bits(convert.unshard(shards), whole, f"step {i} state")
        same_bits(convert.unshard(res), res_u, f"step {i} result")
        same_bits(stats, stats_u, f"step {i} stats")
        assert float(stats.tx_packets.sum()) == float(
            res_u.delivered[whole.src < N_NODES].sum())


def test_duplicate_rows_take_the_last_valid_lane():
    """A row twice in one batch ends with its last valid lane's props,
    sharded as unsharded (the CPU scatter writes lanes in order)."""
    d = random_state_np(CAPACITY, 5)
    rows = np.array([3, 200, 3, 200, 3], np.int32)
    props = random_state_np(5, 6)["props"]
    valid = np.array([True, True, True, True, False])
    mesh = make_mesh(["cpu"] * 4)
    shards = shard_edge_state(torch_state(d), mesh)
    for st, (lo, hi) in zip(shards, tpart.shard_ranges(CAPACITY, 4)):
        rows_s, valid_s = tsh._batch_for_shard(rows, valid, lo, hi)
        tes.update_links(st, rows_s, props, valid_s)
    whole = tes.update_links(torch_state(d), rows, props, valid)
    got = convert.unshard(shards)
    same_bits(got, whole, "state")
    np.testing.assert_array_equal(got.props[3].numpy(), props[2])
    np.testing.assert_array_equal(got.props[200].numpy(), props[3])


def test_updated_props_visible_in_the_same_step(devices8):
    """A scatter across all eight shards is what the same step shapes
    with, in both packages: 7 ms of latency on one row of each shard."""
    d = {k: v.copy() for k, v in random_state_np(CAPACITY, 9).items()}
    d["active"][:] = True
    rows = np.arange(8, dtype=np.int32) * (CAPACITY // 8) + 5
    props = np.stack([tes.props_row(LinkProperties(latency="7ms")
                                    .to_numeric())] * 8)
    valid = np.ones(8, bool)
    sizes = np.full(CAPACITY, 100.0, np.float32)
    have = np.ones(CAPACITY, bool)
    t_arr = np.zeros(CAPACITY, np.float32)
    key = jax.random.key(0)
    _, jres, _ = jax_run(d, rows, props, valid, sizes, have, t_arr, key)
    u = np.asarray(jax.random.uniform(key, (CAPACITY, jnetem.NU),
                                      jnp.float32))
    _, tres, _ = torch_run(d, 8, rows, props, valid, sizes, have, t_arr, u)
    dep = convert.unshard(tres).depart_us.numpy()
    np.testing.assert_allclose(dep[rows], 7000.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jres.depart_us)[rows], 7000.0,
                               rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_node_stats_match_jax(devices8, seed):
    """The per-node reduction alone on random per-edge inputs (node ids
    beyond n included, which both drop): counts exact, bytes within
    rtol 1e-6, and the port's 8-shard sums == its unsharded sums bit for
    bit."""
    rng = np.random.default_rng(seed)
    E = CAPACITY
    src = rng.integers(0, N_NODES + 4, E).astype(np.int32)
    dst = rng.integers(0, N_NODES + 4, E).astype(np.int32)
    deliv = rng.random(E) < 0.7
    sizes = rng.uniform(40, 9000, E).astype(np.float32).round()
    drop = rng.random(E) < 0.2
    m = jmesh.make_mesh(8)
    edge = jax.NamedSharding(m, jax.P(jmesh.EDGE_AXIS))
    jstats = jsh.make_node_stats_fn(m, N_NODES)(
        *(jax.device_put(jnp.asarray(x), edge)
          for x in (src, dst, deliv, sizes, drop)))

    def port(S):
        mesh = make_mesh(["cpu"] * S)
        blocks = [convert.shard(torch.as_tensor(x), mesh)
                  for x in (src, dst, deliv, sizes, drop)]
        return tsh.make_node_stats_fn(mesh, N_NODES)(*blocks)

    t8 = port(8)
    assert_stats_match_jax(jstats, t8)
    same_bits(t8, port(1), "stats")
    assert float(t8.tx_packets.sum()) == deliv[src < N_NODES].sum()


@pytest.mark.parametrize("seed", range(6))
def test_mailbox_layout_matches_jax(seed):
    rng = np.random.default_rng(seed)
    S = int(rng.choice([1, 2, 4, 8]))
    E = S * int(rng.integers(4, 64))
    n = int(rng.integers(0, 3 * E))
    src = rng.integers(0, E, n)
    dst = np.where(rng.random(n) < 0.2, -1, rng.integers(0, E, n))
    want = jpart.mailbox_layout(src, dst, E, S)
    got = tpart.mailbox_layout(src, dst, E, S)
    assert got == want
    assert "mailbox_layout" in tpart.__all__


def test_sharded_step_refuses_an_uneven_split_and_a_wrong_mesh():
    state = tes.init_state(CAPACITY, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        shard_edge_state(tes.init_state(100, device="cpu"),
                         make_mesh(["cpu"] * 8))
    shards = shard_edge_state(state, make_mesh(["cpu"] * 4))
    step = tsh.make_sharded_step(make_mesh(["cpu"] * 8), N_NODES)
    z = torch.zeros(CAPACITY)
    with pytest.raises(ValueError, match="4 shards for a mesh of 8"):
        step(shards, [], np.zeros((0, tes.NPROP), np.float32), [], z,
             z.bool(), z, torch.Generator())
    with pytest.raises(ValueError, match="a generator or the draws"):
        tsh.make_sharded_step(make_mesh(["cpu"] * 4), N_NODES)(
            shards, [], np.zeros((0, tes.NPROP), np.float32), [], z,
            z.bool(), z)


def test_dryrun_multichip_on_the_cpu(devices8, capsys):
    """The port's dryrun on 8 virtual CPU shards: packets delivered, the
    cross-shard tx_packets total equal to them, and JAX's OK line."""
    import __graft_entry__

    out = entry.dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out.strip()
    assert out["n_devices"] == 8 and out["device"] == "cpu"
    assert out["delivered"] > 0
    assert out["tx_packets"] == out["delivered"]
    assert line == (f"dryrun_multichip(8): OK — {out['delivered']} packets "
                    f"shaped across 8 shards, psum'd node counters "
                    f"consistent")
    __graft_entry__.dryrun_multichip(8)
    jline = capsys.readouterr().out.strip()
    pattern = r"dryrun_multichip\(8\): OK — (\d+) packets shaped .*"
    assert re.fullmatch(pattern, jline) and re.fullmatch(pattern, line)
    # the same state and batch: 512 rows at 0.5 % loss, so both deliver
    # nearly all of them whatever their draws
    assert abs(int(re.fullmatch(pattern, jline).group(1))
               - out["delivered"]) <= 16
