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


@pytest.mark.parametrize("S", [1, 4, 10])
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


# E = 2^18 + 37 is 1,025 blocks of 256 edges: more than one wave over
# the card's SMs, not a multiple of it, with a ragged last block. `have`
# leaves about a fifth of the edges inactive, settled without a step.
@pytest.mark.parametrize("E,S", [(5000, 3), (1, 1), (1, 10), (1000, 1),
                                 (1000, 10), ((1 << 18) + 37, 1),
                                 ((1 << 18) + 37, 10)])
def test_k3_equals_k2_on_philox_draws(dev, E, S):
    """K3 against K2 fed the materialised draws, bit for bit, both
    against the plain version, each updating its state in place."""
    seed = 99
    ts = shaping.tile_state(random_state(E, 6, dev))
    sizes, have, t_arr, _ = inputs(E, 6, dev)
    act = have.to(torch.int32)

    def fresh():
        return shaping.TiledShapeState(**{k: v.clone() for k, v in
                                          vars(ts).items()})

    draws = philox.uniforms(seed, E, S, dev)
    plain = shaping.shape_steps_plain(ts, sizes, act, t_arr, draws, S)
    mine3, mine2 = fresh(), fresh()
    k3 = shaping.shape_steps_tiled(mine3, sizes, act, t_arr, seed, S)
    k2 = shaping.shape_steps_tiled(mine2, sizes, act, t_arr, seed, S, draws)
    torch.cuda.synchronize()
    for i in (1, 2):
        assert_bitwise(k3[i], k2[i], f"output {i}")
        assert_bitwise(k3[i], plain[i], f"output {i} vs plain")
    for name in ("tokens", "t_last", "backlog", "corr", "count"):
        assert_bitwise(getattr(k3[0], name), getattr(k2[0], name), name)
        assert_bitwise(getattr(k3[0], name), getattr(plain[0], name),
                       f"{name} vs plain")
        for mine, out in ((mine3, k3[0]), (mine2, k2[0])):
            assert getattr(out, name).data_ptr() == \
                getattr(mine, name).data_ptr(), f"{name} not in place"


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


# -- K4: the mailbox ring step -------------------------------------------------

def _blocks(S, shape, dev, dtype=torch.int32, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                          dtype=torch.int32, device=dev).view(dtype)
            for _ in range(S)]


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("R", [1, 8, 4096])
def test_k4_equals_plain_rotation(dev, S, R):
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh([dev] * S)
    blocks = _blocks(S, (R, 24), dev, seed=R)
    before = pex.LAUNCHES["ring_step"]
    got = pex.ring_right_shift(blocks, mesh)
    want = pex.ring_right_shift_plain(blocks)
    torch.cuda.synchronize()
    assert pex.LAUNCHES["ring_step"] == before + 1  # one per card
    for s in range(S):
        assert torch.equal(got[s], want[s])
        assert got[s].data_ptr() != blocks[s - 1].data_ptr()


@pytest.mark.parametrize("n_words,offsets", [
    (15, (0, 0)), (4097, (0, 0)), (4096, (1, 1)),
    (3, (0, 1, 0)), (4097, (1, 0, 2, 3)), (98_307, (0, 0, 0, 0, 1, 0, 0, 0))])
def test_k4_ragged_and_unaligned(dev, n_words, offsets):
    """A word count not divisible by 4 takes the scalar tail; a block that
    starts 4, 8 or 12 bytes into its buffer takes the scalar path
    throughout. Shards of one launch may differ in alignment; a ring
    step on one card is still one launch."""
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    S = len(offsets)
    bufs = _blocks(S, (n_words + 3,), dev, torch.float32, seed=n_words)
    blocks = [b[o:o + n_words] for b, o in zip(bufs, offsets)]
    before = pex.LAUNCHES["ring_step"]
    got = pex.ring_right_shift(blocks, make_mesh([dev] * S))
    torch.cuda.synchronize()
    assert pex.LAUNCHES["ring_step"] == before + 1
    for s in range(S):
        assert torch.equal(got[s].view(torch.int32),
                           blocks[s - 1].view(torch.int32))


def test_k4_rejects_what_it_does_not_take(dev):
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh([dev] * 2)
    with pytest.raises(ValueError, match="32-bit words"):
        pex.ring_right_shift([torch.zeros(4, 3, dtype=torch.int64,
                                          device=dev)] * 2, mesh)
    with pytest.raises(ValueError, match="contiguous"):
        pex.ring_right_shift([torch.zeros(4, 6, dtype=torch.int32,
                                          device=dev)[:, ::2]] * 2, mesh)
    with pytest.raises(ValueError, match="block 1"):
        pex.ring_right_shift([torch.zeros(4, 3, dtype=torch.int32,
                                          device=dev),
                              torch.zeros(5, 3, dtype=torch.int32,
                                          device=dev)], mesh)
    with pytest.raises(ValueError, match="blocks for a mesh"):
        pex.ring_right_shift([torch.zeros(4, 3, dtype=torch.int32,
                                          device=dev)] * 3, mesh)


@pytest.fixture
def two_cards(dev):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the ring step across cards")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_k4_across_two_cards(two_cards):
    """Block s lands on the other card: stored over NVLink by the kernel
    on the writer's card, ordered by an event the reader's stream waits
    on."""
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(two_cards)
    blocks = [_blocks(1, (4096, 24), d, seed=i)[0]
              for i, d in enumerate(two_cards)]
    got = pex.ring_right_shift(blocks, mesh)
    for d in two_cards:
        torch.cuda.synchronize(d)
    assert got[0].device == two_cards[0] and got[1].device == two_cards[1]
    assert torch.equal(got[1].cpu(), blocks[0].cpu())
    assert torch.equal(got[0].cpu(), blocks[1].cpu())


def test_k4_waits_for_work_queued_on_the_receiving_card(two_cards):
    """The allocator may hand the step a block that work still queued on
    the receiving card writes: the ring step's store must land after it.
    A long sleep, then a fill of a freed block of the step's size, sit on
    cuda:1's stream before the step. Peer access is enabled and every
    kernel loaded beforehand: either would first wait for the card."""
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(two_cards)
    blocks = [_blocks(1, (4096, 24), d, seed=i)[0]
              for i, d in enumerate(two_cards)]
    pex.ring_right_shift(blocks, mesh)
    with torch.cuda.device(two_cards[1]):
        torch.cuda._sleep(1)
        torch.empty_like(blocks[1]).fill_(7)
    for d in two_cards:
        torch.cuda.synchronize(d)
    with torch.cuda.device(two_cards[1]):
        stale = torch.empty_like(blocks[1])
        stale_ptr = stale.data_ptr()
        torch.cuda._sleep(200_000_000)
        stale.fill_(7)
        del stale
    got = pex.ring_right_shift(blocks, mesh)
    assert got[1].data_ptr() == stale_ptr, "the step took another block"
    for d in two_cards:
        torch.cuda.synchronize(d)
    assert torch.equal(got[1].cpu(), blocks[0].cpu())
    assert torch.equal(got[0].cpu(), blocks[1].cpu())


@pytest.mark.parametrize("S", [2, 4, "two_cards"])
def test_sharded_live_tick_equals_unsharded_on_the_card(dev, S, request):
    """A small Clos through the live tick on the card: the sharded program
    on S virtual shards (K4 ring steps), or on two cards, equals the
    unsharded one bit for bit."""
    from kubedtn_tpu_torch import entry, runtime
    from kubedtn_tpu_torch import telemetry as tele
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.models.topologies import (
        clos, load_edge_list_into_state)
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    el = clos(8, 40, 0, props=LinkProperties(latency="10ms",
                                              rate="10Gbit"),
              links_per_pair=2)
    state, _ = load_edge_list_into_state(el, device=dev)
    g = entry.build_live_tick(el, state, 60, 16, 5, device=dev)
    state.backlog_until[g["tbf"][0][:4].long()] = 2e5
    E = state.capacity

    def unsharded():
        key, dyn, tel, outs = runtime.tick_key(3), None, \
            tele.init_acc(E, dev), []
        for _ in range(3):
            key, _s, dyn, o, tel = runtime.fused_tick(
                state, dyn, key, 1000.0, g["seq"], g["tbf"], g["ind"], tel)
            outs.append(o)
        return outs, dyn, tel

    if S == "two_cards":
        mesh = make_mesh(request.getfixturevalue("two_cards"))
    else:
        mesh = make_mesh([dev] * S)
    S = len(mesh)

    def sharded():
        fn = runtime.make_sharded_fused(mesh)
        shards = convert.shard(state, mesh)
        key, dyn, outs = runtime.tick_key(3), None, []
        tel = convert.shard(tele.init_acc(E, dev), mesh)
        for _ in range(3):
            key, _s, dyn, o, tel = fn(shards, dyn, key, 1000.0, g["seq"],
                                      g["tbf"], g["ind"], tel)
            outs.append(o)
        return outs, convert.unshard(dyn, dev), convert.unshard(tel, dev)

    want = unsharded()
    before = pex.LAUNCHES["ring_step"]
    got = sharded()
    torch.cuda.synchronize()
    # 3 ticks x 3 classes x (S - 1) ring steps, one launch per card each
    assert pex.LAUNCHES["ring_step"] == \
        before + 3 * 3 * (S - 1) * len(pex.ring_plan(mesh))

    def cmp(a, b):
        if isinstance(a, dict):
            for k in a:
                cmp(a[k], b[k])
        elif isinstance(a, (tuple, list)):
            for x, y in zip(a, b):
                cmp(x, y)
        else:
            assert_bitwise(a.to(b.device), b, "sharded vs unsharded")

    cmp(got, want)
    assert any(bool(o["tbf"][5].any()) for o in want[0])
