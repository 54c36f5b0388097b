"""The CUDA kernels of kubedtn_tpu_torch against their plain versions, on
the card. Every test here needs a CUDA device and skips without one.

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from kubedtn_tpu_torch import convert
from kubedtn_tpu_torch.ops import edge_state as es
from kubedtn_tpu_torch.ops import netem
from kubedtn_tpu_torch.ops.cuda import philox, shaping

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def random_state(capacity, seed, dev):
    """A state with every netem/TBF feature in use on some rows."""
    rng = np.random.default_rng(seed)
    E = capacity
    props = np.zeros((E, es.NPROP), np.float32)
    for col, choices in ((es.P_LATENCY_CORR, [0, 25, 75]),
                         (es.P_JITTER_US, [0, 0, 1000, 5000]),
                         (es.P_LOSS, [0, 0, 1, 25, 100]),
                         (es.P_LOSS_CORR, [0, 50]),
                         (es.P_RATE_BPS, [0, 20e6, 1e9, 10e9]),
                         (es.P_GAP, [0, 0, 2, 5]),
                         (es.P_DUPLICATE, [0, 0, 10, 50]),
                         (es.P_DUPLICATE_CORR, [0, 30]),
                         (es.P_REORDER_PROB, [0, 0, 25]),
                         (es.P_REORDER_CORR, [0, 40]),
                         (es.P_CORRUPT_PROB, [0, 0, 5]),
                         (es.P_CORRUPT_CORR, [0, 20])):
        props[:, col] = rng.choice(choices, E)
    props[:, es.P_LATENCY_US] = rng.integers(0, 100_000, E)
    backlog = rng.uniform(0, 1e4, E).astype(np.float32)
    backlog[::7] = 2e5
    return convert.edge_state_from_numpy(dict(
        uid=np.arange(E, dtype=np.int32),
        src=np.zeros(E, np.int32), dst=np.zeros(E, np.int32),
        active=rng.random(E) < 0.9, props=props,
        tokens=rng.uniform(0, 1e6, E).astype(np.float32),
        t_last=rng.uniform(-1e4, 0, E).astype(np.float32),
        corr=rng.random((E, es.NCORR)).astype(np.float32),
        pkt_count=rng.integers(0, 6, E).astype(np.int32),
        backlog_until=backlog), device=dev)


def inputs(E, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    sizes = torch.tensor([64.0, 512.0, 1500.0], device=dev)[
        torch.randint(0, 3, (E,), generator=g, device=dev)]
    have = torch.rand(E, generator=g, device=dev) < 0.8
    t_arr = torch.rand(E, generator=g, device=dev) * 1000.0
    u = torch.rand((E, netem.NU), generator=g, device=dev)
    return sizes, have, t_arr, u


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bitwise(a, b, name):
    assert torch.equal(bits(a), bits(b)), name


@pytest.mark.parametrize("capacity", [1000, 8192])
def test_k1_equals_plain(dev, capacity):
    state = random_state(capacity, 1, dev)
    args = inputs(capacity, 2, dev)
    before = shaping.LAUNCHES["shape_step_rows"]
    p_state, p_res = netem._shape_step_from_u(state, *args)
    k_state, k_res = shaping.shape_step(state, *args, donate=False)
    torch.cuda.synchronize()
    assert shaping.LAUNCHES["shape_step_rows"] == before + 1
    for f in dataclasses.fields(netem.ShapeResult):
        assert_bitwise(getattr(k_res, f.name), getattr(p_res, f.name),
                       f.name)
    for name in ("tokens", "t_last", "backlog_until", "corr", "pkt_count"):
        assert_bitwise(getattr(k_state, name), getattr(p_state, name), name)
    assert bool(k_res.dropped_queue.any()) and bool(k_res.reordered.any())


def test_k1_donate_writes_in_place(dev):
    state = random_state(1024, 3, dev)
    args = inputs(1024, 3, dev)
    want, _ = netem._shape_step_from_u(state, *args)
    tokens = state.tokens
    got, _ = shaping.shape_step(state, *args, donate=True)
    assert got.tokens.data_ptr() == tokens.data_ptr()
    assert_bitwise(tokens, want.tokens, "tokens")
    assert_bitwise(got.corr, want.corr, "corr")


@pytest.mark.parametrize("S", [1, 4])
def test_k2_equals_plain(dev, S):
    E = 3000
    ts = shaping.tile_state(random_state(E, 4, dev))
    sizes, have, t_arr, _ = inputs(E, 5, dev)
    act = have.to(torch.int32)
    u_t = torch.rand((S * netem.NU, E), device=dev)
    plain = shaping.shape_steps_plain(ts, sizes, act, t_arr, u_t, S)
    kern = shaping.shape_steps_tiled(
        shaping.TiledShapeState(**{k: v.clone() for k, v in
                                   vars(ts).items()}),
        sizes, act, t_arr, 0, S, u_t)
    torch.cuda.synchronize()
    for i, name in ((1, "depart"), (2, "flags")):
        assert_bitwise(kern[i], plain[i], name)
    for name in ("tokens", "t_last", "backlog", "corr", "count"):
        assert_bitwise(getattr(kern[0], name), getattr(plain[0], name), name)


def test_k3_equals_k2_on_philox_draws(dev):
    E, S, seed = 5000, 3, 99
    ts = shaping.tile_state(random_state(E, 6, dev))
    sizes, _, t_arr, _ = inputs(E, 6, dev)
    act = torch.ones(E, dtype=torch.int32, device=dev)

    def fresh():
        return shaping.TiledShapeState(**{k: v.clone() for k, v in
                                          vars(ts).items()})

    k3 = shaping.shape_steps_tiled(fresh(), sizes, act, t_arr, seed, S)
    k2 = shaping.shape_steps_tiled(fresh(), sizes, act, t_arr, seed, S,
                                   philox.uniforms(seed, E, S, dev))
    torch.cuda.synchronize()
    for i in (1, 2):
        assert_bitwise(k3[i], k2[i], f"output {i}")
    for name in ("tokens", "t_last", "backlog", "corr", "count"):
        assert_bitwise(getattr(k3[0], name), getattr(k2[0], name), name)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    state = random_state(256, 7, dev)
    sizes, have, t_arr, u = inputs(256, 7, dev)
    with pytest.raises(ValueError, match="expected cuda"):
        shaping.shape_step(state, sizes.cpu(), have, t_arr, u, donate=True)
    with pytest.raises(ValueError, match="dtype"):
        shaping.shape_step(state, sizes.double(), have, t_arr, u,
                           donate=True)
    with pytest.raises(ValueError, match="contiguous"):
        shaping.shape_step(state, sizes, have, t_arr,
                           u.T.contiguous().T, donate=True)
