"""Port parity: kubedtn_tpu_torch.ops.netem against kubedtn_tpu.ops.netem.

The same numpy state and the same numpy uniforms go through the JAX
function and its torch counterpart (on the CPU). Flags and integers must
match exactly; floats within the Pallas parity tolerances of
tests/test_pallas_shaping.py (state rtol 1e-6 / atol 1e-3, departures
rtol 1e-5 / atol 1e-2), which cover XLA's fused-multiply contraction on
the JAX side.

The helpers at the top are shared by the other tests/test_torch_*.py
files.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedtn_tpu.ops import edge_state as jes
from kubedtn_tpu.ops import netem as jnetem
from kubedtn_tpu_torch import convert
from kubedtn_tpu_torch.ops import edge_state as tes
from kubedtn_tpu_torch.ops import netem as tnetem
from kubedtn_tpu_torch.ops.cuda import shaping as tshaping

STATE_TOL = dict(rtol=1e-6, atol=1e-3)
DEPART_TOL = dict(rtol=1e-5, atol=1e-2)


def random_state_np(capacity: int, seed: int, active_frac: float = 0.9):
    """{field: numpy} of an EdgeState with randomized-but-plausible
    properties and live state (tests/test_pallas_shaping.py's
    random_state, as numpy, plus a full queue on every 7th row so that
    TBF overflow drops occur too)."""
    rng = np.random.default_rng(seed)
    E = capacity
    props = np.zeros((E, jes.NPROP), np.float32)
    props[:, jes.P_LATENCY_US] = rng.integers(0, 100_000, E)
    props[:, jes.P_LATENCY_CORR] = rng.choice([0, 25, 75], E)
    props[:, jes.P_JITTER_US] = rng.choice([0, 0, 1000, 5000], E)
    props[:, jes.P_LOSS] = rng.choice([0, 0, 1, 25, 100], E)
    props[:, jes.P_LOSS_CORR] = rng.choice([0, 50], E)
    props[:, jes.P_RATE_BPS] = rng.choice([0, 20e6, 1e9, 10e9], E)
    props[:, jes.P_GAP] = rng.choice([0, 0, 2, 5], E)
    props[:, jes.P_DUPLICATE] = rng.choice([0, 0, 10, 50], E)
    props[:, jes.P_DUPLICATE_CORR] = rng.choice([0, 30], E)
    props[:, jes.P_REORDER_PROB] = rng.choice([0, 0, 25], E)
    props[:, jes.P_REORDER_CORR] = rng.choice([0, 40], E)
    props[:, jes.P_CORRUPT_PROB] = rng.choice([0, 0, 5], E)
    props[:, jes.P_CORRUPT_CORR] = rng.choice([0, 20], E)
    backlog = rng.uniform(0, 1e4, E).astype(np.float32)
    backlog[::7] = 2e5
    return dict(
        uid=np.arange(E, dtype=np.int32),
        src=rng.integers(0, 64, E).astype(np.int32),
        dst=rng.integers(0, 64, E).astype(np.int32),
        active=rng.random(E) < active_frac,
        props=props,
        tokens=rng.uniform(0, 1e6, E).astype(np.float32),
        t_last=rng.uniform(-1e4, 0, E).astype(np.float32),
        corr=rng.random((E, jes.NCORR)).astype(np.float32),
        pkt_count=rng.integers(0, 6, E).astype(np.int32),
        backlog_until=backlog,
    )


def jax_state(d) -> jes.EdgeState:
    return jes.EdgeState(**{k: jnp.asarray(v) for k, v in d.items()})


def torch_state(d) -> tes.EdgeState:
    return convert.edge_state_from_numpy(d, device="cpu")


def jax_to_numpy(s) -> dict:
    return {f.name: np.asarray(getattr(s, f.name))
            for f in dataclasses.fields(s)}


def step_inputs(capacity: int, seed: int):
    """(sizes, have_pkt, t_arrival, u) as numpy."""
    rng = np.random.default_rng(seed + 100)
    return (rng.choice([64, 512, 1500], capacity).astype(np.float32),
            rng.random(capacity) < 0.8,
            rng.uniform(0, 1000, capacity).astype(np.float32),
            rng.random((capacity, jnetem.NU)).astype(np.float32))


def assert_states_close(j, t, exact=False):
    """A JAX EdgeState against a torch EdgeState."""
    got = convert.edge_state_to_numpy(t)
    for name, want in jax_to_numpy(j).items():
        if exact or want.dtype != np.float32:
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want, err_msg=name,
                                       **STATE_TOL)


def assert_results_close(j, t):
    """A JAX ShapeResult against a torch ShapeResult."""
    for f in dataclasses.fields(jnetem.ShapeResult):
        want = np.asarray(getattr(j, f.name))
        got = getattr(t, f.name).cpu().numpy()
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, err_msg=f.name,
                                       **DEPART_TOL)


_jax_step_from_u = jax.jit(jnetem._shape_step_from_u)


def run_both(d, sizes, have, t_arr, u):
    """The compiled JAX step and the port's plain step on one input."""
    js, jr = _jax_step_from_u(
        jax_state(d), jnp.asarray(sizes), jnp.asarray(have),
        jnp.asarray(t_arr), jnp.asarray(u))
    ts, tr = tnetem._shape_step_from_u(
        torch_state(d), torch.as_tensor(sizes), torch.as_tensor(have),
        torch.as_tensor(t_arr), torch.as_tensor(u))
    return (js, jr), (ts, tr)


@pytest.mark.parametrize("capacity,seed",
                         [(1024, 0), (2048, 1), (8192, 2), (1000, 3)])
def test_shape_step_from_u_matches_jax(capacity, seed):
    d = random_state_np(capacity, seed)
    (js, jr), (ts, tr) = run_both(d, *step_inputs(capacity, seed))
    assert_results_close(jr, tr)
    assert_states_close(js, ts)
    # the random state exercises every outcome class
    for name in ("delivered", "dropped_loss", "dropped_queue", "corrupted",
                 "duplicated", "reordered"):
        assert bool(getattr(tr, name).any()), name


def test_inactive_and_no_packet_lanes_untouched():
    d = random_state_np(1024, seed=9, active_frac=0.5)
    sizes, _, t_arr, u = step_inputs(1024, 9)
    have = np.arange(1024) % 2 == 0
    (_, jr), (ts, tr) = run_both(d, sizes, have, t_arr, u)
    assert_results_close(jr, tr)
    idle = ~(have & d["active"])
    assert not tr.delivered.numpy()[idle].any()
    assert np.isinf(tr.depart_us.numpy()[idle]).all()
    got = convert.edge_state_to_numpy(ts)
    for name in ("tokens", "t_last", "backlog_until", "corr", "pkt_count"):
        np.testing.assert_array_equal(got[name][idle], d[name][idle],
                                      err_msg=name)


def test_input_state_not_modified():
    d = random_state_np(1024, seed=4)
    ts = torch_state(d)
    tnetem._shape_step_from_u(ts, *map(torch.as_tensor,
                                       step_inputs(1024, 4)))
    assert_states_close(jax_state(d), ts, exact=True)


def test_cause_codes_match_jax():
    d = random_state_np(2048, seed=5)
    (_, jr), (_, tr) = run_both(d, *step_inputs(2048, 5))
    want = np.asarray(jnetem.cause_codes(jr))
    got = tnetem.cause_codes(tr)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0, 1, 2, 3}


def test_roll_epoch_matches_jax():
    d = random_state_np(1024, seed=6)
    d["t_last"][:8] = -9.99e6  # some rows reach the floor
    want = jnetem.roll_epoch(jax_state(d), jnp.float32(2500.0))
    got = tnetem.roll_epoch(torch_state(d), torch.tensor(2500.0))
    assert_states_close(want, got, exact=True)
    assert (got.t_last.numpy() >= -1e7).all()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_row_class_predicates_match_jax(as_tensor):
    props = random_state_np(1024, seed=7)["props"]
    props[::3, jes.P_REORDER_PROB] = 0  # enough iid rows to see both
    props[::3, [jes.P_LATENCY_CORR, jes.P_LOSS_CORR, jes.P_DUPLICATE_CORR,
                jes.P_REORDER_CORR, jes.P_CORRUPT_CORR]] = 0
    p = torch.as_tensor(props) if as_tensor else props
    for jf, tf in ((jnetem.slot_independent_rows,
                    tnetem.slot_independent_rows),
                   (jnetem._iid_random_rows, tnetem._iid_random_rows)):
        want = np.asarray(jf(props))
        got = np.asarray(tf(p))
        np.testing.assert_array_equal(got, want)
        assert want.any() and not want.all()


def test_shape_step_draws_from_generator():
    """shape_step draws [E, NU] uniforms from the given generator, and
    shape_step_auto / _nodonate (plain on CPU tensors) agree with it."""
    d = random_state_np(1024, seed=8)
    sizes, have, t_arr, _ = map(torch.as_tensor, step_inputs(1024, 8))
    outs = []
    for fn in (tnetem.shape_step, tnetem.shape_step_auto,
               tnetem.shape_step_nodonate):
        g = torch.Generator().manual_seed(42)
        outs.append(fn(torch_state(d), sizes, have, t_arr, g))
    u = torch.rand((1024, tnetem.NU), generator=torch.Generator()
                   .manual_seed(42))
    ref_s, ref_r = tnetem._shape_step_from_u(torch_state(d), sizes, have,
                                             t_arr, u)
    for s, r in outs:
        torch.testing.assert_close(r.depart_us, ref_r.depart_us,
                                   rtol=0, atol=0)
        assert torch.equal(tshaping.pack_flags(r),
                           tshaping.pack_flags(ref_r))
        assert torch.equal(s.tokens, ref_s.tokens)
        assert torch.equal(s.corr, ref_s.corr)
