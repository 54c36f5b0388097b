"""Port parity: kubedtn_tpu_torch.ops.queues against kubedtn_tpu.ops.queues.

The same numpy inputs go through the JAX function and its torch
counterpart on the CPU. `shape_packets` is fed the JAX package's own
uniforms, rebuilt from its key schedule (queues.py:115 splits the step key
into one key per slot, netem.py:310 draws [E, NU] from each). Masks,
counts and integers match exactly; floats within the parity tolerances of
tests/test_torch_netem.py.

`jax_shape_uniforms` is shared by the sim and router tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedtn_tpu.ops import netem as jnetem
from kubedtn_tpu.ops import queues as jq
from kubedtn_tpu_torch.ops import netem as tnetem
from kubedtn_tpu_torch.ops import queues as tq

from test_torch_netem import (assert_results_close, assert_states_close,
                              jax_state, random_state_np, torch_state)


def jax_shape_uniforms(ks, k: int, capacity: int) -> np.ndarray:
    """[K, E, NU] uniforms that queues.shape_packets draws under the
    step's shaping key `ks`."""
    keys = jax.random.split(ks, k)
    return np.stack([np.array(jax.random.uniform(
        kk, (capacity, jnetem.NU), dtype=jnp.float32)) for kk in keys])


def slot_inputs(capacity: int, k: int, seed: int):
    """(sizes, valid, t_arrival) [E, K] as numpy, arrival-sorted."""
    rng = np.random.default_rng(seed + 50)
    sizes = rng.choice([64, 512, 1500], (capacity, k)).astype(np.float32)
    valid = rng.random((capacity, k)) < 0.7
    t_arr = np.sort(rng.uniform(0, 1000, (capacity, k)), axis=1) \
        .astype(np.float32)
    return sizes, valid, t_arr


_jax_shape_packets = jax.jit(jq.shape_packets)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("fn", ["shape_packets", "shape_packets_plain"])
def test_shape_packets_matches_jax(k, fn):
    E = 1024
    d = random_state_np(E, seed=k)
    sizes, valid, t_arr = slot_inputs(E, k, k)
    key = jax.random.key(100 + k)
    js, jr = _jax_shape_packets(jax_state(d), jnp.asarray(sizes),
                                jnp.asarray(valid), jnp.asarray(t_arr), key)
    u = torch.as_tensor(jax_shape_uniforms(key, k, E))
    ts0 = torch_state(d)
    ts, tr = getattr(tq, fn)(ts0, torch.as_tensor(sizes),
                             torch.as_tensor(valid), torch.as_tensor(t_arr),
                             u=u)
    assert tuple(tr.depart_us.shape) == (E, k)
    assert_results_close(jr, tr)
    assert_states_close(js, ts)
    # the caller's state stays as it was
    assert_states_close(jax_state(d), ts0, exact=True)
    if k > 1:
        for name in ("delivered", "dropped_loss", "dropped_queue",
                     "duplicated", "reordered"):
            assert bool(getattr(tr, name).any()), name


def test_shape_packets_kernel_path_equals_plain_on_cpu():
    """On CPU tensors the K1 wrapper runs K1's plain version: both loops
    give the same bits, flags packed and unpacked in between."""
    E, k = 512, 4
    d = random_state_np(E, seed=3)
    args = [torch.as_tensor(x) for x in slot_inputs(E, k, 3)]
    u = torch.rand((k, E, tnetem.NU),
                   generator=torch.Generator().manual_seed(1))
    s1, r1 = tq.shape_packets(torch_state(d), *args, u=u)
    s2, r2 = tq.shape_packets_plain(torch_state(d), *args, u=u)
    for f in dataclasses.fields(tnetem.ShapeResult):
        assert torch.equal(getattr(r1, f.name), getattr(r2, f.name)), f.name
    for f in dataclasses.fields(s1):
        assert torch.equal(getattr(s1, f.name), getattr(s2, f.name)), f.name


def test_shape_packets_draws_from_generator():
    E, k = 256, 3
    d = random_state_np(E, seed=4)
    args = [torch.as_tensor(x) for x in slot_inputs(E, k, 4)]
    g = torch.Generator().manual_seed(9)
    _, r1 = tq.shape_packets(torch_state(d), *args, g)
    u = torch.rand((k, E, tnetem.NU),
                   generator=torch.Generator().manual_seed(9))
    _, r2 = tq.shape_packets(torch_state(d), *args, u=u)
    assert torch.equal(r1.depart_us, r2.depart_us)
    with pytest.raises(ValueError, match="generator or the draws"):
        tq.shape_packets(torch_state(d), *args)
    with pytest.raises(ValueError, match="u must have shape"):
        tq.shape_packets(torch_state(d), *args, u=u[:2])


# -- the delay line -------------------------------------------------------

def ring_np(capacity: int, q: int, fill: float, seed: int):
    """A delay line as numpy: each slot occupied with probability `fill`
    (1.0 = every ring full, 0.0 = empty)."""
    rng = np.random.default_rng(seed)
    busy = rng.random((capacity, q)) < fill
    if fill > 0:
        busy[::5] = True            # some rings full whatever the fill
        busy[1::5, : q // 2] = True
    return dict(
        t=np.where(busy, rng.uniform(0, 5000, (capacity, q)), np.inf)
        .astype(np.float32),
        size=np.where(busy, rng.choice([64, 1500], (capacity, q)), 0)
        .astype(np.float32),
        final_dst=np.where(busy, rng.integers(0, 9, (capacity, q)), -1)
        .astype(np.int32),
        corrupted=busy & (rng.random((capacity, q)) < 0.2))


def lanes_np(capacity: int, lanes: int, seed: int):
    rng = np.random.default_rng(seed + 7)
    deliver = rng.random((capacity, lanes)) < 0.6
    return (np.where(deliver, rng.uniform(0, 9000, (capacity, lanes)),
                     np.inf).astype(np.float32),
            rng.choice([64, 1500], (capacity, lanes)).astype(np.float32),
            rng.integers(0, 9, (capacity, lanes)).astype(np.int32),
            rng.random((capacity, lanes)) < 0.3, deliver)


def jax_ring(d):
    return jq.InFlight(**{k: jnp.asarray(v) for k, v in d.items()})


def torch_ring(d):
    return tq.InFlight(**{k: torch.as_tensor(v) for k, v in d.items()})


def assert_rings_equal(j, t):
    for f in dataclasses.fields(tq.InFlight):
        np.testing.assert_array_equal(
            getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name)),
            err_msg=f.name)


def insert_inflight_loop(fl, depart, sizes, final_dst, corrupted, deliver):
    """The reference's literal lane scan in torch: each lane in turn goes
    to the leftmost free slot of its edge."""
    t, size, fdst, corr = (x.clone() for x in (fl.t, fl.size, fl.final_dst,
                                               fl.corrupted))
    e_idx = torch.arange(t.shape[0])
    dropped = torch.zeros(t.shape[0])
    for k in range(depart.shape[1]):
        free = t == torch.inf
        slot = free.to(torch.int8).argmax(dim=1)
        has_free = free.any(dim=1)
        do = deliver[:, k] & has_free
        for buf, new in ((t, depart), (size, sizes), (fdst, final_dst),
                         (corr, corrupted)):
            buf[e_idx, slot] = torch.where(do, new[:, k], buf[e_idx, slot])
        dropped += (deliver[:, k] & ~has_free).float()
    return tq.InFlight(t=t, size=size, final_dst=fdst,
                       corrupted=corr), dropped


_jax_insert = jax.jit(jq.insert_inflight)


@pytest.mark.parametrize("fill", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("q,lanes", [(8, 4), (4, 8), (16, 16)])
def test_insert_inflight_matches_jax_and_the_literal_loop(fill, q, lanes):
    E = 200
    ring = ring_np(E, q, fill, seed=q + lanes)
    args = lanes_np(E, lanes, seed=q)
    jfl, jdrop = _jax_insert(jax_ring(ring), *map(jnp.asarray, args))
    targs = [torch.as_tensor(a) for a in args]
    tfl, tdrop = tq.insert_inflight(torch_ring(ring), *targs)
    assert_rings_equal(jfl, tfl)
    np.testing.assert_array_equal(tdrop.numpy(), np.asarray(jdrop))
    lfl, ldrop = insert_inflight_loop(torch_ring(ring), *targs)
    for f in dataclasses.fields(tq.InFlight):
        assert torch.equal(getattr(tfl, f.name), getattr(lfl, f.name))
    assert torch.equal(tdrop, ldrop)
    if fill == 1.0:     # every delivering lane is lost
        np.testing.assert_array_equal(tdrop.numpy(), args[4].sum(axis=1))
    if fill == 0.0 and q >= lanes:
        assert not tdrop.any()


def test_insert_inflight_leaves_its_input():
    ring = ring_np(64, 8, 0.5, seed=1)
    fl = torch_ring(ring)
    tq.insert_inflight(fl, *[torch.as_tensor(a) for a in lanes_np(64, 4, 1)])
    assert_rings_equal(jax_ring(ring), fl)


@pytest.mark.parametrize("dt_us", [0.0, 1000.0, 1e9])
def test_pop_due_matches_jax(dt_us):
    ring = ring_np(300, 16, 0.6, seed=2)
    jfl, jdue = jax.jit(jq.pop_due)(jax_ring(ring), jnp.float32(dt_us))
    fl = torch_ring(ring)
    tfl, tdue = tq.pop_due(fl, torch.tensor(dt_us))
    np.testing.assert_array_equal(tdue.numpy(), np.asarray(jdue))
    assert_rings_equal(jfl, tfl)
    # empty slots stay +inf; the input keeps its sizes for the caller
    assert torch.equal(torch.isinf(tfl.t), torch.isinf(fl.t) | tdue)
    assert_rings_equal(jax_ring(ring), fl)


def test_init_shapes_and_device_rule():
    fl = tq.init_inflight(10, 4, "cpu")
    assert fl.q == 4 and torch.isinf(fl.t).all()
    assert (fl.final_dst == -1).all() and not fl.corrupted.any()
    c = tq.init_counters(10, "cpu")
    ptrs = {getattr(c, n).data_ptr() for n in tq.COUNTER_NAMES}
    assert len(ptrs) == len(tq.COUNTER_NAMES) == 10
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tq.init_inflight(10)
