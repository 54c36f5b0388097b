"""Port parity: kubedtn_tpu_torch.sim against kubedtn_tpu.sim on the
k=4 fat-tree, on the CPU.

Both packages run from one numpy state on the JAX package's own draws,
rebuilt from its key schedule (sim.py:168 splits key(seed) into one key
per step, :91 each step key into the traffic key and the shaping key) and
handed to the port as `StepDraws`.

Every counter, mask and integer must match exactly; float state within
the parity tolerances (state rtol 1e-6 / atol 1e-3, departures rtol 1e-5
/ atol 1e-2). `traffic.credit` equals `sim.run` BIT FOR BIT:
tests/test_torch_traffic.py says why (the port computes the program XLA
compiles for `sim.run`, whose spec and dt are constants). Against a
`sim_step` chain, where XLA rounds each step's `rate * dt` differently,
one step agrees at rtol 1e-6 and the credit (a running remainder below
one packet) drifts by at most one ulp of the increment per step:
`CREDIT_DRIFT_PER_STEP`.

`jax_step_draws`, `fat_tree_state_np` and the assert helpers are shared
by the router tests; a JAX state goes to numpy through
`convert.tree_to_numpy`, as the port's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedtn_tpu import sim as jsim
from kubedtn_tpu.api.types import LinkProperties
from kubedtn_tpu.models import topologies as jT
from kubedtn_tpu.models import traffic as jtr
from kubedtn_tpu_torch import convert, entry
from kubedtn_tpu_torch import sim as tsim
from kubedtn_tpu_torch.models import topologies as tT
from kubedtn_tpu_torch.ops import queues as tq

from test_torch_netem import STATE_TOL, jax_state, jax_to_numpy
from test_torch_queues import jax_shape_uniforms
from test_torch_traffic import (jax_spec, jax_traffic_draws, mixed_spec_np,
                                torch_spec)

# one ulp of a step's credit increment (rate * dt < 8192 bytes here);
# the drift against the traced JAX programs is allowed twice that a step
CREDIT_DRIFT_PER_STEP = 2 * 2.0 ** -11


def jax_step_draws(key, spec_j, dt_us, k_slots, capacity, k_shape=None):
    """The StepDraws of one JAX step under its step key: `k_shape`
    shaping slots (k_slots for sim_step, k_slots + k_fwd routed)."""
    kg, ks = jax.random.split(key)
    return tsim.StepDraws(
        traffic=jax_traffic_draws(kg, spec_j, dt_us, k_slots),
        shape_u=torch.as_tensor(
            jax_shape_uniforms(ks, k_shape or k_slots, capacity)))


def run_draws(seed, steps, spec_j, dt_us, k_slots, capacity, k_shape=None):
    keys = jax.random.split(jax.random.key(seed), steps)
    return [jax_step_draws(k, spec_j, dt_us, k_slots, capacity, k_shape)
            for k in keys]


def fat_tree_state_np(seed: int, loss="1", rate="100Mbit") -> tuple:
    """(edge-state numpy dict, number of directed rows, capacity) of the
    k=4 fat-tree with jitter, loss, duplication and mixed link rates."""
    el = jT.fat_tree(4, LinkProperties(latency="2ms", jitter="500us",
                                       loss=loss, duplicate="2",
                                       rate=rate))
    state, rows = jT.load_edge_list_into_state(el)
    d = jax_to_numpy(state)
    rng = np.random.default_rng(seed)
    n = len(rows)
    d["props"] = d["props"].copy()
    # a third of the links slower than the offered load: TBF overflow
    slow = rng.random(n) < 0.33
    d["props"][:n, 5] = np.where(slow, 8e6, d["props"][:n, 5])
    d["props"][:n, 0] = rng.integers(500, 6000, n)
    return d, n, state.capacity


def cbr_spec_np(capacity, n, seed) -> dict:
    rng = np.random.default_rng(seed + 3)
    on = np.arange(capacity) < n
    return dict(
        mode=np.where(on, jtr.MODE_CBR, jtr.MODE_OFF).astype(np.int32),
        rate_bps=np.where(on, rng.uniform(4e6, 4e7, capacity), 0)
        .astype(np.float32),
        pkt_bytes=rng.choice([700.0, 1500.0], capacity).astype(np.float32),
        on_us=np.zeros(capacity, np.float32),
        off_us=np.zeros(capacity, np.float32))


def assert_counters_equal(jc, tc):
    for name in tq.COUNTER_NAMES:
        np.testing.assert_array_equal(
            getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
            err_msg=name)


def assert_sims_close(js, ts, credit_atol=0.0, bytes_exact=True):
    """A JAX SimState against the port's; traffic.credit bit for bit
    unless `credit_atol` allows a drift."""
    if bytes_exact:
        assert_counters_equal(js.counters, ts.counters)
    want, got = convert.tree_to_numpy(js), convert.tree_to_numpy(ts)
    for group in ("edges", "inflight", "traffic"):
        for name, w in want[group].items():
            g = got[group][name]
            label = f"{group}.{name}"
            assert g.dtype == w.dtype, label
            if name == "credit" and credit_atol:
                np.testing.assert_allclose(g, w, rtol=1e-6,
                                           atol=credit_atol, err_msg=label)
            elif w.dtype != np.float32 or name == "credit":
                np.testing.assert_array_equal(g, w, err_msg=label)
            else:
                np.testing.assert_allclose(g, w, err_msg=label, **STATE_TOL)
    np.testing.assert_array_equal(got["clock_us"], want["clock_us"])


def both_sims(d, q):
    js = jsim.init_sim(jax_state(d), q=q)
    ts = convert.sim_from_numpy(convert.tree_to_numpy(js), device="cpu")
    return js, ts


@pytest.mark.parametrize("steps", [1, 10, 50])
def test_run_matches_jax_run(steps):
    d, n, E = fat_tree_state_np(steps)
    spec_np = cbr_spec_np(E, n, steps)
    spec_j = jax_spec(spec_np)
    k, dt, seed = 4, 1000.0, 7
    js, ts = both_sims(d, q=8)
    js = jsim.run(js, spec_j, steps, dt, k, seed=seed)
    draws = run_draws(seed, steps, spec_j, dt, k, E)
    ts = tsim.run(ts, torch_spec(spec_np), steps, dt, k, draws=draws)
    assert_sims_close(js, ts)
    c = ts.counters
    assert c.tx_packets.sum() > 0
    if steps >= 10:
        for name in ("rx_packets", "dropped_loss", "duplicated"):
            assert getattr(c, name).sum() > 0, name
    if steps == 50:   # long enough for the slow links' queues and rings
        assert c.dropped_queue.sum() > 0 and c.dropped_ring.sum() > 0


@pytest.mark.parametrize("seed", [1, 2])
def test_run_mixed_traffic_matches_jax_run(seed):
    """CBR, Poisson, ON/OFF and silent rows side by side through
    `sim.run`: the sources' state and every counter as in the CBR runs."""
    d, n, E = fat_tree_state_np(seed)
    spec_np = mixed_spec_np(E, seed)
    spec_j = jax_spec(spec_np)
    k, dt, steps = 4, 1000.0, 12
    js, ts = both_sims(d, q=16)
    js = jsim.run(js, spec_j, steps, dt, k, seed=seed)
    draws = run_draws(seed, steps, spec_j, dt, k, E)
    ts = tsim.run(ts, torch_spec(spec_np), steps, dt, k, draws=draws)
    assert_sims_close(js, ts)
    for mode in (jtr.MODE_CBR, jtr.MODE_POISSON, jtr.MODE_ONOFF):
        rows = torch.as_tensor((spec_np["mode"] == mode) & d["active"])
        assert ts.counters.tx_packets[rows].sum() > 0, mode
    off = torch.as_tensor(spec_np["mode"] == jtr.MODE_OFF)
    assert not ts.counters.tx_packets[off].any()


def test_sim_step_chain_matches_jax_sim_step():
    """spec and dt traced on the JAX side: credit within the drift, all
    else as in `run`."""
    d, n, E = fat_tree_state_np(2)
    spec_np = cbr_spec_np(E, n, 2)
    spec_j, spec_t = jax_spec(spec_np), torch_spec(spec_np)
    k, dt, steps = 4, 1000.0, 10
    js, ts = both_sims(d, q=8)
    keys = jax.random.split(jax.random.key(5), steps)
    for key in keys:
        js, jdue = jsim.sim_step(js, spec_j, key, k, jnp.float32(dt))
        ts, tdue = tsim.sim_step(
            ts, spec_t, None, k, dt,
            draws=jax_step_draws(key, spec_j, dt, k, E))
        np.testing.assert_array_equal(tdue.numpy(), np.asarray(jdue))
    assert_sims_close(js, ts, credit_atol=steps * CREDIT_DRIFT_PER_STEP)


@pytest.mark.parametrize("scale", [0.5, 1.7])
def test_finish_step_size_scale_matches_jax(scale):
    d, n, E = fat_tree_state_np(4)
    spec_np = cbr_spec_np(E, n, 4)
    spec_j, spec_t = jax_spec(spec_np), torch_spec(spec_np)
    k, dt = 4, 1000.0
    js, ts = both_sims(d, q=8)
    jstep = jax.jit(lambda s, key: jsim._step_parts(
        s, spec_j, key, k, jnp.float32(dt), size_scale=jnp.float32(scale)))
    for key in jax.random.split(jax.random.key(9), 6):
        js, jdue, jres, jsizes, jt_arr = jstep(js, key)
        ts, tdue, tres, tsizes, tt_arr = tsim._step_parts(
            ts, spec_t, None, k, dt, scale,
            draws=jax_step_draws(key, spec_j, dt, k, E))
        np.testing.assert_array_equal(tdue.numpy(), np.asarray(jdue))
        np.testing.assert_array_equal(tsizes.numpy(), np.asarray(jsizes))
        np.testing.assert_array_equal(tt_arr.numpy(), np.asarray(jt_arr))
        np.testing.assert_array_equal(tres.delivered.numpy(),
                                      np.asarray(jres.delivered))
    # scaled sizes are not whole bytes: byte sums round by summation
    # order, every packet count is still exact
    assert_sims_close(js, ts, credit_atol=6 * CREDIT_DRIFT_PER_STEP,
                      bytes_exact=False)
    for name in tq.COUNTER_NAMES:
        got = getattr(ts.counters, name).numpy()
        want = np.asarray(getattr(js.counters, name))
        if name.endswith("bytes"):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("k_slots,q", [(4, 8), (2, 4), (8, 32)])
def test_run_from_generator_conserves_packets(k_slots, q):
    """The port alone, drawing from its generator: every offered packet
    is delivered, dropped by one cause or still in flight, per edge."""
    d, n, E = fat_tree_state_np(6)
    ts = tsim.init_sim(convert.edge_state_from_numpy(d, device="cpu"), q=q)
    spec = torch_spec(cbr_spec_np(E, n, 6))
    out = tsim.run(ts, spec, 40, 1000.0, k_slots, seed=3)
    assert not tsim.conservation_residual(out).any()
    assert out.counters.rx_packets.sum() > 0
    assert float(out.clock_us) == 40_000.0
    # the same seed gives the same run; the input was left as it was
    again = tsim.run(ts, spec, 40, 1000.0, k_slots, seed=3)
    for name in tq.COUNTER_NAMES:
        assert torch.equal(getattr(out.counters, name),
                           getattr(again.counters, name)), name
    assert not ts.counters.tx_packets.any()


def test_run_plain_shape_fn_equals_the_kernel_path_on_cpu():
    d, n, E = fat_tree_state_np(8)
    ts = tsim.init_sim(convert.edge_state_from_numpy(d, device="cpu"), q=8)
    spec = torch_spec(cbr_spec_np(E, n, 8))
    a = tsim.run(ts, spec, 10, 1000.0, 4, seed=1)
    b = tsim.run(ts, spec, 10, 1000.0, 4, seed=1,
                 shape_fn=tq.shape_packets_plain)
    x, y = convert.tree_to_numpy(a), convert.tree_to_numpy(b)
    for group in ("edges", "inflight", "counters", "traffic"):
        for name in x[group]:
            np.testing.assert_array_equal(x[group][name], y[group][name],
                                          err_msg=f"{group}.{name}")


def test_throughput_and_draw_count_checks():
    d, n, E = fat_tree_state_np(1)
    ts = tsim.init_sim(convert.edge_state_from_numpy(d, device="cpu"), q=8)
    spec = torch_spec(cbr_spec_np(E, n, 1))
    out = tsim.run(ts, spec, 20, 1000.0, 4, seed=0)
    bps = tsim.throughput_bps(ts.counters, out.counters, 20_000.0)
    want = out.counters.rx_bytes.numpy() * 8.0 / 0.02
    np.testing.assert_allclose(bps.numpy(), want, rtol=1e-6)
    with pytest.raises(ValueError, match="draws for"):
        tsim.run(ts, spec, 3, 1000.0, 4, draws=[])


def test_build_sim_entry_point():
    el = tT.fat_tree(4, LinkProperties(latency="1ms", rate="1Gbit"))
    state, rows = tT.load_edge_list_into_state(el, device="cpu")
    s, spec = entry.build_sim(el, state, q=16)
    assert s.inflight.q == 16 and s.edges is state
    assert int((spec.mode == 1).sum()) == len(rows) == 2 * el.n_links
    out = tsim.run(s, spec, 5, 1000.0, 4, seed=0)
    # 12 Mbit/s of 1,500-byte packets is one packet per edge and ms
    assert (out.counters.tx_packets[:len(rows)] == 5).all()
    assert not tsim.conservation_residual(out).any()
