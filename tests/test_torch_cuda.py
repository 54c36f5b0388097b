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


# -- the K-slot simulator and the routed fabric --------------------------------

def _assert_trees_bitwise(a, b, name=""):
    """(Nested) dataclasses of tensors, on any devices, bit for bit."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_trees_bitwise(getattr(a, f.name), getattr(b, f.name),
                                  f"{name}.{f.name}")
    else:
        assert_bitwise(a.cpu(), b.cpu(), name)


@pytest.mark.parametrize("E", [1, 1000, (1 << 18) + 37])
@pytest.mark.parametrize("K", [1, 4])
def test_shape_packets_launches_k1_per_slot_and_equals_plain(dev, E, K):
    from kubedtn_tpu_torch.ops import queues

    state = random_state(E, 11, dev)
    g = torch.Generator(device=dev).manual_seed(E + K)
    sizes = torch.tensor([64.0, 512.0, 1500.0], device=dev)[
        torch.randint(0, 3, (E, K), generator=g, device=dev)]
    valid = torch.rand((E, K), generator=g, device=dev) < 0.8
    t_arr = torch.sort(torch.rand((E, K), generator=g, device=dev) * 1000.0,
                       dim=1).values
    u = torch.rand((K, E, netem.NU), generator=g, device=dev)
    before = shaping.LAUNCHES["shape_step_rows"]
    tokens = state.tokens.clone()
    k_state, k_res = queues.shape_packets(state, sizes, valid, t_arr, u=u)
    assert shaping.LAUNCHES["shape_step_rows"] == before + K
    p_state, p_res = queues.shape_packets_plain(state, sizes, valid, t_arr,
                                                u=u)
    assert shaping.LAUNCHES["shape_step_rows"] == before + K
    torch.cuda.synchronize()
    _assert_trees_bitwise(k_res, p_res)
    _assert_trees_bitwise(k_state, p_state)
    assert_bitwise(state.tokens, tokens, "the caller's state")
    assert tuple(k_res.depart_us.shape) == (E, K)


def test_shape_packets_raises_on_what_k1_does_not_take(dev):
    from kubedtn_tpu_torch.ops import queues

    E, K = 256, 2
    state = random_state(E, 12, dev)
    sizes = torch.full((E, K), 1500.0, device=dev)
    valid = torch.ones((E, K), dtype=torch.bool, device=dev)
    t_arr = torch.zeros((E, K), device=dev)
    u = torch.rand((K, E, netem.NU), device=dev)
    with pytest.raises(ValueError, match="dtype"):
        queues.shape_packets(state, sizes.double(), valid, t_arr, u=u)
    with pytest.raises(ValueError, match="expected cuda"):
        queues.shape_packets(state, sizes, valid, t_arr, u=u.cpu())


@pytest.mark.parametrize("fill", [0.0, 0.6, 1.0])
def test_insert_inflight_and_pop_due_on_the_card_equal_the_cpu(dev, fill):
    from kubedtn_tpu_torch.ops import queues

    E, Q, L = 5000, 32, 8
    rng = np.random.default_rng(int(fill * 10))
    busy = rng.random((E, Q)) < fill
    busy[::7] = fill > 0
    fl = queues.InFlight(
        t=torch.as_tensor(np.where(busy, rng.uniform(0, 5000, (E, Q)),
                                   np.inf).astype(np.float32)),
        size=torch.as_tensor(np.where(busy, 1500.0, 0.0)
                             .astype(np.float32)),
        final_dst=torch.as_tensor(np.where(busy, 3, -1).astype(np.int32)),
        corrupted=torch.as_tensor(busy & (rng.random((E, Q)) < 0.2)))
    deliver = rng.random((E, L)) < 0.6
    args = [torch.as_tensor(a) for a in (
        np.where(deliver, rng.uniform(0, 9000, (E, L)), np.inf)
        .astype(np.float32),
        rng.choice([64.0, 1500.0], (E, L)).astype(np.float32),
        rng.integers(0, 9, (E, L)).astype(np.int32),
        rng.random((E, L)) < 0.3, deliver)]
    c_fl, c_drop = queues.insert_inflight(fl, *args)
    g_fl, g_drop = queues.insert_inflight(
        convert.tree_to(fl, dev), *[a.to(dev) for a in args])
    _assert_trees_bitwise(g_fl, c_fl)
    assert_bitwise(g_drop.cpu(), c_drop, "dropped_ring")
    c_pop, c_due = queues.pop_due(c_fl, torch.tensor(2500.0))
    g_pop, g_due = queues.pop_due(g_fl, torch.tensor(2500.0, device=dev))
    _assert_trees_bitwise(g_pop, c_pop)
    assert torch.equal(g_due.cpu(), c_due)


def _small_clos(dev, seed=3):
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.models.topologies import (
        clos, load_edge_list_into_state, random_link_props)

    el = clos(4, 12, 0, props=LinkProperties(latency="1ms"),
              links_per_pair=2)
    state, rows = load_edge_list_into_state(el, device=dev)
    n = len(rows)
    es.update_links(state, np.arange(n, dtype=np.int32),
                    random_link_props(n, seed), np.ones(n, dtype=bool),
                    contiguous=True)
    return el, state


def test_routes_on_the_card_equal_the_cpu(dev):
    """dist, next hops, ECMP groups and reachability (whose matmul may
    run in TF32: 0/1 operands make that exact)."""
    from kubedtn_tpu_torch.ops import routing

    el, state = _small_clos(dev)
    cpu = convert.tree_to(state, "cpu")
    n = el.n_nodes
    for fn in (lambda s: routing.recompute_routes(s, n, 4),
               lambda s: routing.recompute_routes(s, n, 4, dst_chunk=4),
               lambda s: routing.recompute_routes_ecmp(s, n, 4, 4),
               lambda s: (routing.reachability(s, n),)):
        for got, want in zip(fn(state), fn(cpu)):
            assert_bitwise(got.cpu(), want, "routes")
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert torch.equal(routing.reachability(state, n).cpu(),
                           routing.reachability(cpu, n))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def test_incremental_routes_on_the_card_equal_the_cpu(dev):
    from kubedtn_tpu_torch.ops import routing

    el, state = _small_clos(dev)
    n, L = el.n_nodes, el.n_links
    both = np.concatenate([[1, 17, 40], np.array([1, 17, 40]) + L])
    out = {}
    for where in (dev, "cpu"):
        s = convert.tree_to(state, where)
        seed = torch.full((n, n), torch.inf, device=where)
        dist = routing.refine_dist(s, n, seed, 64)
        nh = routing.next_hop_edges(s, dist, n)
        rows = torch.as_tensor(both, device=where)
        w = routing.edge_weights_latency(s)[rows].cpu().numpy()
        s_k, d_k = s.src[rows].cpu().numpy(), s.dst[rows].cpu().numpy()
        down = es.delete_links(
            es.EdgeState(**{k: v.clone() for k, v in vars(s).items()}),
            both, np.ones(len(both), dtype=bool))
        out[str(where)] = routing.update_routes_incremental(
            down, n, dist, nh, s_k, d_k, w,
            np.full(len(both), np.inf, np.float32))
        full = routing.refine_dist(down, n, seed, 64)
        assert torch.equal(out[str(where)][0], full)
    (gd, gn, gc), (cd, cn, cc) = out[str(dev)], out["cpu"]
    assert_bitwise(gd.cpu(), cd, "dist")
    assert torch.equal(gn.cpu(), cn) and gc == cc > 0


@pytest.mark.parametrize("k_paths", [None, 2])
def test_routed_run_on_the_card_repeats_and_equals_the_cpu(dev, k_paths):
    """The same state and seed give the same bits twice (no float atomic
    on the path), K1 launches once per slot and step and equals the run
    over the plain step, and the card agrees with the CPU on the same
    draws."""
    from kubedtn_tpu_torch import entry, router, sim
    from kubedtn_tpu_torch.models import traffic
    from kubedtn_tpu_torch.ops import queues

    el, state = _small_clos(dev)
    rs, spec, flow_dst, _ = entry.build_routed(
        el, state, np.arange(4, el.n_nodes), seed=5, q=32, k_fwd=4,
        max_hops=4, k_paths=k_paths)
    steps, k = 30, 3
    before = shaping.LAUNCHES["shape_step_rows"]
    a = router.run_routed(rs, spec, flow_dst, steps, 1000.0, k, 4, seed=1)
    assert shaping.LAUNCHES["shape_step_rows"] == before + steps * (k + 4)
    b = router.run_routed(rs, spec, flow_dst, steps, 1000.0, k, 4, seed=1)
    _assert_trees_bitwise(a, b)
    plain = router.run_routed(rs, spec, flow_dst, steps, 1000.0, k, 4,
                              seed=1, shape_fn=queues.shape_packets_plain)
    assert shaping.LAUNCHES["shape_step_rows"] == \
        before + 2 * steps * (k + 4)
    _assert_trees_bitwise(a, plain)
    assert float(a.node_rx_packets.sum()) > 0
    g = torch.Generator(device=dev).manual_seed(2)
    draws = [sim.StepDraws(
        traffic=traffic.draw(spec, 1000.0, k, g),
        shape_u=queues.draw_shape_uniforms(state, k + 4, g))
        for _ in range(steps)]
    on_card = router.run_routed(rs, spec, flow_dst, steps, 1000.0, k, 4,
                                draws=draws)
    on_cpu = router.run_routed(
        convert.tree_to(rs, "cpu"), convert.tree_to(spec, "cpu"),
        flow_dst.cpu(), steps, 1000.0, k, 4,
        draws=[convert.tree_to(d, "cpu") for d in draws])

    def close(card, cpu, name):
        if dataclasses.is_dataclass(card):
            for f in dataclasses.fields(card):
                close(getattr(card, f.name), getattr(cpu, f.name),
                      f"{name}.{f.name}")
        elif card.dtype != torch.float32 or ".counters" in name \
                or name.startswith((".node_rx", ".fwd_", ".no_route")):
            assert torch.equal(card.cpu(), cpu), name
        else:
            torch.testing.assert_close(card.cpu(), cpu, rtol=1e-5,
                                       atol=1e-2, msg=name)

    close(on_card, on_cpu, "")


# -- the host live plane on the card ----------------------------------------

PLANE_PROPS = (dict(latency="10ms"), dict(rate="1Mbit"),
               dict(latency="5ms", latency_corr="30"),
               dict(latency="2ms", rate="20Mbit"))


def _plane(device, depth, props=PLANE_PROPS, seed=0):
    """A small live plane (one pod pair per props entry, wires on both
    ends) through the port's store, reconciler and engine on `device`."""
    import types

    from kubedtn_tpu_torch.api.types import (Link, LinkProperties,
                                             Topology, TopologySpec)
    from kubedtn_tpu_torch.runtime import WireDataPlane
    from kubedtn_tpu_torch.topology.engine import SimEngine
    from kubedtn_tpu_torch.topology.reconciler import Reconciler
    from kubedtn_tpu_torch.topology.store import TopologyStore
    from kubedtn_tpu_torch.wire.server import Daemon

    store = TopologyStore()
    engine = SimEngine(store, capacity=64, device=device)
    for i, p in enumerate(props):
        lp = LinkProperties(**p)
        for a, b in ((f"a{i}", f"b{i}"), (f"b{i}", f"a{i}")):
            store.create(Topology(name=a, spec=TopologySpec(links=[
                Link(local_intf="eth1", peer_intf="eth1", peer_pod=b,
                     uid=i + 1, properties=lp)])))
        engine.setup_pod(f"a{i}")
        engine.setup_pod(f"b{i}")
    Reconciler(store, engine).drain()
    daemon = Daemon(engine)
    plane = WireDataPlane(daemon, dt_us=10_000, seed=seed,
                          pipeline_depth=depth)
    plane.pipeline_explicit_clock = True

    def wd(pod, uid):
        return types.SimpleNamespace(
            local_pod_name=pod, kube_ns="default", link_uid=uid,
            intf_name_in_pod="eth1", veth_name_local_host="",
            peer_intf_id=0, peer_ip="")

    win = [daemon._add_wire(wd(f"a{i}", i + 1)) for i in range(len(props))]
    wout = [daemon._add_wire(wd(f"b{i}", i + 1)) for i in range(len(props))]
    return engine, plane, win, wout


def _drive_plane(device, depth, shards=None, ticks=8, drain=30):
    engine, plane, win, wout = _plane(device, depth)
    if shards:
        plane.enable_sharding(n_devices=shards) if device == "cpu" else \
            plane.enable_sharding([torch.device(device)] * shards)
    rng = np.random.default_rng(1)
    got = [[] for _ in wout]
    for t in range(ticks + drain):
        if t < ticks:
            for k, w in enumerate(win):
                w.ingress.extend(
                    bytes([k, t]) + j.to_bytes(2, "big") + b"\x5a" * int(s)
                    for j, s in enumerate(rng.integers(60, 1497,
                                                       (20, 30, 70, 40)[k])))
        plane.tick(now_s=(t + 1) * 0.01)
        for k, w in enumerate(wout):
            while w.egress:
                got[k].append((t, w.egress.popleft()))
    assert plane.tick_errors == 0 and not plane._inflight
    counters = {f.name: getattr(plane.counters, f.name).copy()
                for f in dataclasses.fields(plane.counters)}
    return got, plane, counters, engine


def test_plane_depth1_equals_depth2_on_card(dev):
    g1, p1, c1, _ = _drive_plane("cuda", 1)
    g2, p2, c2, _ = _drive_plane("cuda", 2)
    assert [[f for _t, f in w] for w in g1] == \
        [[f for _t, f in w] for w in g2]
    assert (p1.shaped, p1.dropped) == (p2.shaped, p2.dropped)
    for k in c1:
        np.testing.assert_array_equal(c1[k], c2[k], err_msg=k)
    assert p1.fallbacks > 0 and p1.shaped > 0


@pytest.mark.parametrize("depth", [1, 2])
def test_plane_on_card_equals_cpu_on_deterministic_links(dev, depth):
    gc, pc, cc, ec = _drive_plane("cuda", depth)
    gh, ph, ch, eh = _drive_plane("cpu", depth)
    assert gc == gh  # bytes, order and release tick
    assert (pc.shaped, pc.dropped) == (ph.shaped, ph.dropped)
    for k in cc:
        np.testing.assert_array_equal(cc[k], ch[k], err_msg=k)
    for f in ("tokens", "t_last", "backlog_until"):
        torch.testing.assert_close(getattr(ec.state, f).cpu(),
                                   getattr(eh.state, f), rtol=1e-5,
                                   atol=1e-2, msg=f)
    assert torch.equal(ec.state.pkt_count.cpu(), eh.state.pkt_count)


def test_sharded_plane_on_card_equals_unsharded(dev):
    from kubedtn_tpu_torch.parallel import exchange as pex

    g1, p1, c1, _ = _drive_plane("cuda", 2)
    pex.reset_launches()
    g2, p2, c2, _ = _drive_plane("cuda", 2, shards=2)
    # the plane's own ring steps, beyond its exchange probe's (one K4
    # launch a probe run on 2 virtual shards)
    assert pex.LAUNCHES["ring_step"] > p2.shard_exchange_runs >= 1
    assert g1 == g2
    assert (p1.shaped, p1.dropped) == (p2.shaped, p2.dropped)
    for k in c1:
        np.testing.assert_array_equal(c1[k], c2[k], err_msg=k)


def test_native_library_builds_on_card_machine(dev):
    from kubedtn_tpu_torch import native

    assert native.have_native()
    assert native.library_path().exists()
    w = native.TimingWheel(tick_us=1000)
    w.schedule_batch(np.array([5000.0, 1000.0, 3000.0]),
                     np.array([7, 8, 9], np.uint64))
    assert w.next_due_us() is not None
    assert w.advance_np(4000).tolist() == [8, 9]
    assert w.advance_np(9000).tolist() == [7]


def _cross_node_run(device, depth):
    """Two pod pairs across two daemons, each behind a real gRPC server
    on 127.0.0.1: node A (engine on `device`) shapes and sends, node B
    (CPU engine) receives pod-side. Returns B's egress per wire."""
    import types

    from kubedtn_tpu_torch.api.types import (Link, LinkProperties,
                                             Topology, TopologySpec)
    from kubedtn_tpu_torch.runtime import WireDataPlane
    from kubedtn_tpu_torch.topology.engine import SimEngine
    from kubedtn_tpu_torch.topology.store import TopologyStore
    from kubedtn_tpu_torch.wire import proto as pb
    from kubedtn_tpu_torch.wire.client import DaemonClient
    from kubedtn_tpu_torch.wire.server import Daemon, make_server

    props = PLANE_PROPS[:2]
    nodes = []
    for dev_ in (device, "cpu"):
        store = TopologyStore()
        engine = SimEngine(store, capacity=64, device=dev_)
        daemon = Daemon(engine)
        server, port = make_server(daemon, port=0, host="127.0.0.1",
                                   log_rpcs=False)
        server.start()
        engine.node_ip = f"127.0.0.1:{port}"
        nodes.append((store, engine, daemon, server, engine.node_ip))
    (sa, ea, da, srv_a, addr_a), (sb, eb, db, srv_b, addr_b) = nodes
    plane = None
    try:
        for store in (sa, sb):
            for i, p in enumerate(props):
                lp = LinkProperties(**p)
                for x, y, addr in ((f"a{i}", f"b{i}", addr_a),
                                   (f"b{i}", f"a{i}", addr_b)):
                    t = Topology(name=x, spec=TopologySpec(links=[
                        Link(local_intf="eth1", peer_intf="eth1",
                             peer_pod=y, uid=i + 1, properties=lp)]))
                    t.status.src_ip, t.status.net_ns = addr, f"/ns/{x}"
                    store.create(t)
        for i in range(len(props)):
            t = sa.get("default", f"a{i}")
            assert ea.add_links(t, t.spec.links)
        c = DaemonClient(addr_b)
        win, wout = [], []
        for i in range(len(props)):
            r = c.AddGRPCWireRemote(pb.WireDef(
                local_pod_name=f"b{i}", kube_ns="default", link_uid=i + 1,
                intf_name_in_pod="eth1", peer_ip=addr_a))
            win.append(da._add_wire(types.SimpleNamespace(
                local_pod_name=f"a{i}", kube_ns="default", link_uid=i + 1,
                intf_name_in_pod="eth1", veth_name_local_host="",
                peer_ip=addr_b, peer_intf_id=r.peer_intf_id)))
            wout.append(db.wires.get_by_key(f"default/b{i}", i + 1))
        c.close()
        plane = WireDataPlane(da, dt_us=10_000, seed=0,
                              pipeline_depth=depth)
        plane.pipeline_explicit_clock = True
        rng = np.random.default_rng(1)
        for t in range(40):
            if t < 8:
                for k, w in enumerate(win):
                    w.ingress.extend(
                        bytes([k, t]) + j.to_bytes(2, "big")
                        + b"\x5a" * int(s)
                        for j, s in enumerate(rng.integers(60, 1497,
                                                           (20, 30)[k])))
            plane.tick(now_s=(t + 1) * 0.01)
        plane.flush()
        assert plane.flush_peers(60.0)
        assert plane.tick_errors == 0 and da.forward_errors == 0
        assert plane.ring_dropped == 0 and db.bulk_unresolved == 0
        return [list(w.egress) for w in wout], plane.shaped, plane.dropped
    finally:
        if plane is not None:
            plane.stop()
        srv_a.stop(0)
        srv_b.stop(0)


@pytest.mark.parametrize("depth", [1, 2])
def test_cross_node_plane_on_card_delivers_what_the_cpu_does(dev, depth):
    card = _cross_node_run("cuda", depth)
    cpu = _cross_node_run("cpu", depth)
    assert card == cpu
    assert all(len(w) > 0 for w in card[0]) and card[2] > 0


# -- the what-if twin: K1 over replicas x rows --------------------------------

@pytest.mark.parametrize("E,n_rep", [(1000, 1), (1000, 3), (8192, 15)])
def test_k1_shared_uniform_rows_equals_plain(dev, E, n_rep):
    """K1 over n_rep x E rows reading the [E, NU] uniforms at row % E:
    one launch, bit for bit the plain step on the uniforms repeated."""
    state = random_state(E * n_rep, 13 + n_rep, dev)
    sizes, have, t_arr, _ = inputs(E * n_rep, 14, dev)
    u = inputs(E, 15, dev)[3]
    before = shaping.LAUNCHES["shape_step_rows"]
    k_state, dep, fl = shaping.shape_step_flags(
        state, sizes, have, t_arr, u, donate=False, u_rows=E)
    assert shaping.LAUNCHES["shape_step_rows"] == before + 1
    p_state, p_res = netem._shape_step_from_u(state, sizes, have, t_arr,
                                              u.repeat(n_rep, 1))
    torch.cuda.synchronize()
    assert_bitwise(dep, p_res.depart_us, "depart")
    assert_bitwise(fl, shaping.pack_flags(p_res), "flags")
    for name in ("tokens", "t_last", "backlog_until", "corr", "pkt_count"):
        assert_bitwise(getattr(k_state, name), getattr(p_state, name), name)


def test_k1_rejects_uniform_rows_it_does_not_take(dev):
    state = random_state(1024, 16, dev)
    sizes, have, t_arr, u = inputs(1024, 16, dev)
    with pytest.raises(ValueError, match="divisor"):
        shaping.shape_step_flags(state, sizes, have, t_arr, u[:384],
                                 donate=False, u_rows=384)
    with pytest.raises(ValueError, match="shape"):
        shaping.shape_step_flags(state, sizes, have, t_arr, u,
                                 donate=False, u_rows=512)


def test_twin_sweep_on_the_card_equals_the_cpu(dev):
    """A 5-lane sweep on a random mesh: one K1 launch per slot and step
    over every lane's rows; replica 0 == sim.run on the card, bit for
    bit; the card's lanes == the CPU's on the same draws (counters and
    integers exactly, floats within the parity tolerances)."""
    from kubedtn_tpu_torch import sim
    from kubedtn_tpu_torch.api.types import LinkProperties as LP
    from kubedtn_tpu_torch.models import topologies, traffic
    from kubedtn_tpu_torch.ops import queues
    from kubedtn_tpu_torch.twin import (Perturbation, Scenario, run_sweep,
                                        snapshot_from_sim)
    from kubedtn_tpu_torch.twin.engine import replica_lane

    el = topologies.random_mesh(24, 60, seed=3, props=LP(
        latency="2ms", jitter="1ms", loss="1"))
    state, rows = topologies.load_edge_list_into_state(el, device=dev)
    spec = traffic.cbr_everywhere(state.capacity, len(rows), 2e6, 400.0,
                                  device=dev)
    snap = snapshot_from_sim(sim.run(sim.init_sim(state, q=16), spec, 10,
                                     1000.0, 4, seed=1))
    scen = [Scenario("baseline"),
            Scenario("slow", (Perturbation("degrade", uid=1,
                                           props=LP(latency="40ms")),)),
            Scenario("fail", (Perturbation("fail", uid=2),)),
            Scenario("bh", (Perturbation("blackhole", node=0),)),
            Scenario("half", (Perturbation("scale", factor=0.5),))]
    g = torch.Generator(device=dev).manual_seed(4)
    dt = sim.as_dt(1000.0, dev)
    draws = [sim.StepDraws(traffic=traffic.draw(spec, dt, 4, g),
                           shape_u=queues.draw_shape_uniforms(state, 4, g))
             for _ in range(20)]
    before = shaping.LAUNCHES["shape_step_rows"]
    card = run_sweep(snap, scen, steps=20, dt_us=1000.0, spec=spec,
                     k_slots=4, keep_final=True, draws=draws)
    assert shaping.LAUNCHES["shape_step_rows"] == before + 20 * 4
    ref = sim.run(snap.sim, spec, 20, 1000.0, 4, draws=draws)
    _assert_trees_bitwise(replica_lane(card.final, 0, 5), ref)
    cpu = run_sweep(snapshot_from_sim(convert.tree_to(snap.sim, "cpu")),
                    scen, steps=20, dt_us=1000.0,
                    spec=convert.tree_to(spec, "cpu"), k_slots=4,
                    keep_final=True,
                    draws=[convert.tree_to(d, "cpu") for d in draws])
    a, b = card.final, cpu.final
    for tree in ("edges", "inflight", "counters"):
        for f in dataclasses.fields(getattr(a, tree)):
            x = getattr(getattr(a, tree), f.name).cpu()
            y = getattr(getattr(b, tree), f.name)
            if x.dtype != torch.float32 or tree == "counters":
                assert torch.equal(x, y), f"{tree}.{f.name}"
            else:
                fin = torch.isfinite(y)
                assert torch.equal(torch.isfinite(x), fin), f.name
                tol = (dict(rtol=1e-5, atol=1e-2) if tree == "inflight"
                       else dict(rtol=1e-6, atol=1e-3))
                torch.testing.assert_close(x[fin], y[fin], **tol)
    for mc, mp in zip(card.metrics, cpu.metrics):
        for k in ("tx_packets", "delivered_packets", "dropped_loss",
                  "dropped_queue", "dropped_ring", "latency_hist"):
            assert mc[k] == mp[k], k


# -- checkpoint and restart, the exporter, kdt_ext (on the card machine) ---

def _feed_plane(win, t, rng):
    for k, w in enumerate(win):
        w.ingress.extend(
            bytes([k, t]) + j.to_bytes(2, "big") + b"\x5a" * int(s)
            for j, s in enumerate(rng.integers(60, 1497,
                                               (20, 30, 70, 40)[k])))


def test_checkpoint_loads_onto_the_card(dev, tmp_path):
    """A checkpoint and a snapshot file written from a CPU plane load
    onto the card by default (device=None), every column bit for bit."""
    from kubedtn_tpu_torch import checkpoint
    from kubedtn_tpu_torch.sim import init_sim
    from kubedtn_tpu_torch.twin import (load_snapshot, save_snapshot,
                                        snapshot_from_engine)

    engine, plane, win, _wout = _plane("cpu", 1)
    rng = np.random.default_rng(1)
    for t in range(3):
        _feed_plane(win, t, rng)
        plane.tick(now_s=(t + 1) * 0.01)
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, engine.store, engine,
                    sim=init_sim(engine.state, q=8), dataplane=plane)
    _store, e2 = checkpoint.load(path)
    assert e2.device.type == "cuda" and e2._rows == engine._rows
    for f in dataclasses.fields(e2.state):
        assert torch.equal(getattr(e2.state, f.name).cpu(),
                           getattr(engine.state, f.name)), f.name
    sim = checkpoint.load_sim(path, e2)
    assert sim.inflight.t.device.type == "cuda"
    p = str(tmp_path / "snap.npz")
    save_snapshot(p, snapshot_from_engine(engine, q=8))
    snap = load_snapshot(p)
    assert snap.sim.edges.uid.device.type == "cuda"
    for f in dataclasses.fields(snap.sim.edges):
        assert torch.equal(getattr(snap.sim.edges, f.name).cpu(),
                           getattr(engine.state, f.name)), f.name


def test_restored_daemon_on_the_card_resumes_and_scrapes(dev, tmp_path):
    """save_live on the card mid-run, entry.restore_daemon onto the card
    at the cut's clock with its exporter: the per-wire egress equals the
    uninterrupted plane's (release ticks too on the wires without a
    seq-slots holdback at the cut), and a scrape's node totals equal the
    restored plane's counters."""
    import urllib.request

    from kubedtn_tpu_torch import checkpoint, entry

    engine, plane, win, wout = _plane("cuda", 1)
    rng = np.random.default_rng(1)
    for t in range(3):
        _feed_plane(win, t, rng)
        plane.tick(now_s=(t + 1) * 0.01)
        for w in wout:
            w.egress.clear()
    held = {h[0].wire_id for h in plane._holdback.values()}
    path = str(tmp_path / "ckpt")
    checkpoint.save_live(path, engine.store, engine, plane)
    r = entry.restore_daemon(path, capacity=64, now_s=0.03,
                             metrics_port=0,
                             plane_kwargs=dict(dt_us=10_000))
    try:
        assert r["engine"].device.type == "cuda"
        d = r["daemon"]
        runs = {"control": (plane, win, wout),
                "restored": (r["plane"],
                             [d.wires.get_by_key(w.pod_key, w.uid)
                              for w in win],
                             [d.wires.get_by_key(w.pod_key, w.uid)
                              for w in wout])}
        got = {}
        for name, (pl, wi, wo) in runs.items():
            pl.pipeline_explicit_clock = True
            frng = np.random.default_rng(2)
            out = [[] for _ in wo]
            for t in range(3, 30):
                if t < 5:
                    _feed_plane(wi, t, frng)
                pl.tick(now_s=(t + 1) * 0.01)
                for k, w in enumerate(wo):
                    while w.egress:
                        out[k].append((t, w.egress.popleft()))
            got[name] = out
        for k, w in enumerate(win):
            a, b = got["control"][k], got["restored"][k]
            assert [f for _t, f in a] == [f for _t, f in b]
            if w.wire_id not in held:
                assert a == b
        url = f"http://127.0.0.1:{r['metrics']['port']}/metrics"
        body = urllib.request.urlopen(url, timeout=30).read().decode()
        c = r["plane"].counters
        active = np.fromiter(r["engine"]._rows.values(), np.int64)
        line = [l for l in body.splitlines()
                if l.startswith("kubedtn_node_tx_packets_total ")][0]
        assert float(line.split()[1]) == float(c.tx_packets[active].sum())
    finally:
        r["metrics"]["server"].stop()


def test_kdt_ext_on_the_card_machine(dev):
    """Where the interpreter's headers resolve, kdt_ext builds and
    slice_frames equals the Python path; where not, it is None with the
    reason."""
    from kubedtn_tpu_torch import native

    _inc, ok = native.python_include()
    mod = native.kdt_ext()
    if not ok:
        assert mod is None and "Python.h" in native.kdt_ext_reason()
        return
    blob = bytes(range(256)) * 4
    offs = np.array([0, 10, 300, 1000], np.uint64)
    lens = np.array([5, 0, 200, 24], np.uint64)
    assert mod.slice_frames(blob, offs, lens, 0, 4) == [
        blob[o:o + n] for o, n in zip(offs.tolist(), lens.tolist())]


# -- tenancy on the card ----------------------------------------------------

TENANT_PROPS = {
    "t0": dict(latency="2ms", jitter="1ms", loss="10"),
    "t1": dict(rate="2Mbit"),
    "t2": dict(latency="1ms", loss="10", loss_corr="25"),
}


@pytest.mark.parametrize("depth,shards", [(1, None), (2, 2)])
def test_cohabited_plane_on_card_equals_solo(dev, depth, shards):
    """Three tenants cohabiting one plane on the card (t1 in a reserved
    block; at depth 2 on 2 virtual shards, whose ring steps are K4):
    each tenant's bytes, telemetry totals and counters == its solo
    plane's on the card at depth 1, bit for bit."""
    from kubedtn_tpu_torch.parallel import exchange as pex

    from _torch_tenant_harness import mods, run_schedule

    m = mods("torch")
    names = sorted(TENANT_PROPS)
    pex.reset_launches()
    shard = (None if shards is None
             else lambda p: p.enable_sharding(n_devices=shards))
    co = run_schedule(m, names, TENANT_PROPS, depth=depth, device=dev,
                      shard=shard, registry_kw={"t1": {"block_edges": 6}})
    if shards:
        assert pex.LAUNCHES["ring_step"] > 0
    for ns in names:
        so = run_schedule(m, [ns], TENANT_PROPS, depth=1, device=dev)
        assert co[0][ns] == so[0][ns], ns
        np.testing.assert_array_equal(co[1][ns], so[1][ns])
        assert co[2][ns] == so[2][ns]


def test_tenant_scoped_sweep_k1_equals_plain_on_card(dev):
    """A 3-lane sweep of t1's scoped fork of a live plane on the card:
    one K1 launch per slot and step, the final state == the same sweep
    over the plain step, bit for bit; rows outside t1 carry nothing."""
    from kubedtn_tpu_torch import sim
    from kubedtn_tpu_torch.api.types import LinkProperties as LP
    from kubedtn_tpu_torch.models import traffic
    from kubedtn_tpu_torch.ops import queues
    from kubedtn_tpu_torch.twin import Perturbation, Scenario, run_sweep
    from kubedtn_tpu_torch.twin.query import build_cbr_spec

    from _torch_tenant_harness import mods, tenant_plane

    plane, reg, _w = tenant_plane(mods("torch"), sorted(TENANT_PROPS),
                                  TENANT_PROPS, device=dev)
    snap = reg.tenant_snapshot(plane, "t1")
    rows = reg.rows_of("t1")
    assert int(snap.sim.edges.active.sum()) == rows.size
    scen = [Scenario("baseline"),
            Scenario("slow", (Perturbation("degrade", uid=3,
                                           props=LP(rate="1Mbit")),)),
            Scenario("half", (Perturbation("scale", factor=0.5),))]
    spec = build_cbr_spec(snap.sim.edges, rate_bps=4e6, pkt_bytes=300.0)
    g = torch.Generator(device=dev).manual_seed(6)
    dt = sim.as_dt(1000.0, dev)
    draws = [sim.StepDraws(traffic=traffic.draw(spec, dt, 4, g),
                           shape_u=queues.draw_shape_uniforms(
                               snap.sim.edges, 4, g))
             for _ in range(10)]
    kw = dict(steps=10, dt_us=1000.0, spec=spec, k_slots=4,
              keep_final=True, draws=draws)
    before = shaping.LAUNCHES["shape_step_rows"]
    card = run_sweep(snap, scen, **kw)
    assert shaping.LAUNCHES["shape_step_rows"] == before + 10 * 4
    plain = run_sweep(snap, scen, shape_fn=queues.shape_packets_plain, **kw)
    _assert_trees_bitwise(card.final, plain.final)
    tx = card.final.counters.tx_packets.cpu().numpy().reshape(3, -1)
    outside = np.setdiff1d(np.arange(tx.shape[1]), rows)
    assert not tx[:, outside].any() and tx[0, rows].sum() > 0
    plane.stop()


# -- the SLO autopilot's search on the card -----------------------------------

def test_autopilot_search_k1_equals_plain_on_card(dev):
    """A paged gold tenant's grid scored on the card: ONE sweep, one K1
    launch per slot and step over (1 + candidates) x E rows; the same
    seed ranks the same again, bit for bit; the grid's sweep through K1
    == the same sweep over the plain step, bit for bit."""
    from kubedtn_tpu_torch import sim
    from kubedtn_tpu_torch.autopilot import (Autopilot, candidate_grid,
                                             score_candidates)
    from kubedtn_tpu_torch.models import traffic
    from kubedtn_tpu_torch.ops import queues
    from kubedtn_tpu_torch.slo import SloSpec, evaluate_tenant
    from kubedtn_tpu_torch.telemetry import KCOLS, T_DELIVERED, T_TX
    from kubedtn_tpu_torch.twin import Scenario, run_sweep
    from kubedtn_tpu_torch.twin.query import build_cbr_spec

    from _torch_tenant_harness import mods, tenant_plane

    props = {"t0": dict(latency="2ms", loss="25"),
             "t1": dict(latency="1ms", rate="2Mbit")}
    plane, reg, _w = tenant_plane(mods("torch"), sorted(props), props,
                                  device=dev)
    snap = reg.tenant_snapshot(plane, "t0")
    row = np.zeros(KCOLS)
    row[T_TX], row[T_DELIVERED] = 1000.0, 750.0
    v = evaluate_tenant("t0", "gold", SloSpec.for_qos("gold"), row, 5.0,
                        row)
    grid = candidate_grid(v, Autopilot(reg, plane, None)._edge_props(
        snap, "t0"), seed=0, width=2)
    steps, k = 20, 4
    before = shaping.LAUNCHES["shape_step_rows"]
    a = score_candidates(snap, "t0", "gold", v.spec, grid, verdict=v,
                         steps=steps, seed=3, k_slots=k)
    assert shaping.LAUNCHES["shape_step_rows"] == before + steps * k
    assert a.replicas == len(grid) + 1 and a.winner is not None
    b = score_candidates(snap, "t0", "gold", v.spec, grid, verdict=v,
                         steps=steps, seed=3, k_slots=k)
    assert [(s.candidate.name, s.projected_burn) for s in a.ranked] == \
        [(s.candidate.name, s.projected_burn) for s in b.ranked]
    scen = [Scenario("baseline", ())] + [c.scenario() for c in grid]
    spec = build_cbr_spec(snap.sim.edges)
    g = torch.Generator(device=dev).manual_seed(8)
    dt = sim.as_dt(1000.0, dev)
    draws = [sim.StepDraws(traffic=traffic.draw(spec, dt, k, g),
                           shape_u=queues.draw_shape_uniforms(
                               snap.sim.edges, k, g))
             for _ in range(4)]
    kw = dict(steps=4, dt_us=1000.0, spec=spec, k_slots=k,
              keep_final=True, draws=draws)
    card = run_sweep(snap, scen, **kw)
    plain = run_sweep(snap, scen, shape_fn=queues.shape_packets_plain, **kw)
    _assert_trees_bitwise(card.final, plain.final)
    plane.stop()


def _migrated_record(dev, depth, props, frame_bytes, shards=None):
    """A 2^16-row federation (each plane's engine at capacity 2^16) on
    `dev`: the TBF tenant moves A -> B in its feed gap, A optionally on
    virtual shards. Returns (per-wire deliveries, delivery ticks, the
    accounting, the journal record without its wall-clock fields)."""
    from _torch_federation_harness import fmods, run_migrated

    m = fmods("torch")
    rec, h, acct, _stats, fed = run_migrated(
        m, depth=depth, props=props, frame_bytes=frame_bytes,
        device=dev, capacity=1 << 16, shards=shards)
    assert rec["state"] == "done" and acct["mismatch"] == 0.0
    assert fed.handle("B").engine.state.capacity == 1 << 16
    record = {k: v for k, v in fed.coordinator(rec["migration_id"])
              .record().items()
              if k not in ("started_s", "finished_s", "step_seconds")}
    return h.deliv, h.ticks, acct, record


@pytest.mark.parametrize("depth", [1, 2])
def test_migration_on_card_equals_the_cpu(dev, depth):
    """Live tenant migration between two 2^16-row planes on the card
    (deterministic links; the source at depth 2 on 2 virtual shards, so
    K4 runs on its dispatches) delivers what the same migration on the
    CPU delivers, on the same ticks, with the same record."""
    from kubedtn_tpu_torch.parallel import exchange as pex

    from _torch_federation_harness import DET_PROPS

    shards = 2 if depth == 2 else None
    pex.reset_launches()
    card = _migrated_record(dev, depth, DET_PROPS, 1500, shards)
    if shards:
        assert pex.LAUNCHES["ring_step"] > 0
    cpu = _migrated_record(torch.device("cpu"), depth, DET_PROPS, 1500,
                           shards)
    assert card[0] == cpu[0] and card[1] == cpu[1]
    assert card[2] == cpu[2]
    assert card[3] == cpu[3]


def test_migration_on_card_equals_never_migrated(dev):
    """On the card, the drawing tenant (jitter + 10 % loss) migrated
    mid-run delivers the never-migrated stream on the same ticks."""
    from _torch_federation_harness import fmods, reference, run_migrated

    m = fmods("torch")
    ref = reference(m, 1, device=dev)
    rec, h, acct, _stats, _fed = run_migrated(m, depth=1, device=dev)
    assert rec["state"] == "done" and acct["mismatch"] == 0.0
    assert h.deliv == ref[0] and h.ticks == ref[3]


def test_fleet_failover_and_upgrade_on_card_at_a_small_clos(dev):
    """chip_smoke.py's phase 19 on the card at a small Clos (three
    clos(4, 10) x 2 tenants in 2^10 rows): the plane killed
    mid-migration is declared dead over real gRPC dials and evacuated,
    the restored rows equal their sources, the survivor's streams equal
    a hand-restored twin's, the accounting is exact, K4 equals its
    plain version on the survivor's mailbox, and the upgrade of the
    survivor over gRPC accounts for every frame fed: delivered at the
    egress wires or dropped by a counted cause, c0 delivered whole (the
    phase checks each and raises SystemExit on a failure)."""
    import chip_smoke

    card = torch.cuda.get_device_name(0)
    m, _k1, k4 = chip_smoke.run_fleet_phase(
        dev, card, n_spine=4, n_leaf=10, n_links=32, block=200,
        capacity=1 << 10)
    assert k4 > 0 and m["b"]["k4_launches"] > 0
    assert m["b"]["survivors"] == {"t0": "B", "t1": "C", "t2": "B"}
    c = m["c"]
    assert sorted(c["fed"]) == ["c0", "t1"]
    assert c["fed"]["c0"] == c["delivered"]["c0"] > 0
    for t, fed in c["fed"].items():
        n = c["counters"][t]
        assert n["delivered_packets"] == c["delivered"][t]
        assert fed == (c["delivered"][t] + n["dropped_loss"]
                       + n["dropped_queue"] + n["dropped_ring"])


def test_plane_failover_on_card_equals_the_cpu(dev):
    """scenarios.plane_failover with both planes' engines on the card
    gives the CPU run's outcome (but the wall time): the same
    evacuation, the same exact accounting."""
    from kubedtn_tpu_torch.scenarios import plane_failover

    out = {}
    for d in (dev, torch.device("cpu")):
        r = plane_failover(pairs=2, warm_ticks=20, device=d)
        r.pop("wall_s")
        out[d.type] = r
    assert out["cuda"] == out["cpu"]
    assert out["cuda"]["in_guardrails"]


def test_k4_on_an_evacuation_survivor_mailbox_equals_plain(dev, tmp_path):
    """A tenant evacuated onto a survivor at depth 2 on 2 virtual shards:
    the survivor's dispatches launch K4, and K4 equals its plain version
    bit for bit on a ring step of that mailbox."""
    import _torch_fleet_harness as H
    from kubedtn_tpu_torch.parallel import exchange as pex

    m = H.fmods("torch")
    chaos = m.chaos.ChaosInjector()
    ck = str(tmp_path / "ckA")
    f = H.fleet(m, str(tmp_path), chaos=chaos, ck_a=ck, device=dev,
                depth=2, suspect_after=1, dead_after=2)
    d_a, p_a, _r, s_a, e_a = f["A"]
    d_b, p_b, r_b = f["B"][:3]
    p_b.enable_sharding(n_devices=2)
    k = H.feed_and_tick(d_a, p_a, "t1", 0, 3)
    m.ckpt.save_live(ck, s_a, e_a, p_a)
    chaos.kill_plane(f["fed"].handle("A"))
    for _ in range(3):
        f["sup"].sweep()
    assert f["sup"].ledger.get("t1") == "B" and r_b.rows_of("t1").size
    captured = []
    real = pex.ring_right_shift

    def capture(blocks, mesh):
        if not captured:
            captured.append(([b.clone() for b in blocks], tuple(mesh)))
        return real(blocks, mesh)

    pex.reset_launches()
    pex.ring_right_shift = capture
    try:
        H.feed_and_tick(d_b, p_b, "t1", 0, 4, k0=k)
        p_b.flush()
    finally:
        pex.ring_right_shift = real
    assert pex.LAUNCHES["ring_step"] > 0 and captured
    blocks, mesh = captured[0]
    for a, b in zip(pex.ring_right_shift(blocks, mesh),
                    pex.ring_right_shift_plain(blocks)):
        assert torch.equal(a, b)


# -- the Kubernetes-facing control plane and the BASELINE rungs ---------------

def test_k1_equals_plain_at_2_21_rows(dev):
    """K1 over 2^21 rows (scale_1m's capacity) equals the plain step bit
    for bit, two chained steps, one launch each."""
    E = 1 << 21
    state = random_state(E, 21, dev)
    k_state, p_state = state, state
    for step in range(2):
        sizes, have, t_arr, u = inputs(E, 30 + step, dev)
        before = shaping.LAUNCHES["shape_step_rows"]
        k_state, k_res = shaping.shape_step(k_state, sizes, have, t_arr, u,
                                            donate=False)
        p_state, p_res = netem._shape_step_from_u(p_state, sizes, have,
                                                  t_arr, u)
        torch.cuda.synchronize()
        assert shaping.LAUNCHES["shape_step_rows"] == before + 1
        for f in dataclasses.fields(netem.ShapeResult):
            assert_bitwise(getattr(k_res, f.name), getattr(p_res, f.name),
                           f"step {step} {f.name}")
        for name in ("tokens", "t_last", "backlog_until", "corr",
                     "pkt_count"):
            assert_bitwise(getattr(k_state, name), getattr(p_state, name),
                           f"step {step} {name}")


def test_manager_on_card_reconciles_a_small_clos_from_the_apiserver(dev):
    """chip_smoke.py's phase 21(a) on the card at a 4 x 10 Clos: the CRs
    on the port's fake apiserver, a K8sBridge, two ControllerManagers
    electing a leader through the Lease, the CNI shim's ADD for every
    pod to 160 rows on the card, equal per link end to the store ->
    Reconciler engine, statuses pushed and listed back, ping (K1) on a
    10 ms link, spec edits through the watch, the takeover, DEL to 0
    rows (the phase checks each and raises SystemExit on a failure)."""
    import chip_smoke

    card = torch.cuda.get_device_name(0)
    before = shaping.LAUNCHES["shape_step_rows"]
    m = chip_smoke.run_manager_phase(dev, card, n_spine=4, n_leaf=10,
                                     lpp=2, capacity=1 << 10)
    assert shaping.LAUNCHES["shape_step_rows"] == before + chip_smoke.MGR_K1
    assert m["ping"]["fwd_us"] == 10_000.0
    assert m["takeover_s"] <= chip_smoke.MGR_LEASE_S + chip_smoke.MGR_RENEW_S
    assert m["bridge"]["status_pushed"] == 14


# -- the scale path: the sharded step, the sharded router, the probe ----------

def test_scale_phase_on_the_card_at_a_small_clos(dev, monkeypatch):
    """chip_smoke.py's phase 22 on the card at an 8 x 40 Clos (1,280
    rows in 2,048) with small rung arguments: the sharded step at 2, 4
    and 8 virtual shards and the sharded router on 4 == their unsharded
    runs bit for bit (and the router == the same over the plain step),
    with K1 launched exactly S a step and 4 x 12 a routed step."""
    import chip_smoke as cs
    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.models.topologies import (
        clos, load_edge_list_into_state, random_link_props)

    monkeypatch.setattr(cs, "SH_BATCH", 200)
    monkeypatch.setattr(cs, "SR_BUDGET", 1 << 12)
    monkeypatch.setattr(cs, "SR_OVERFLOW_BUDGET", 2)
    el = clos(8, 40, 0, props=LinkProperties(latency="10ms",
                                              rate="10Gbit"),
              links_per_pair=2)
    state, _ = load_edge_list_into_state(el, device=dev)
    n = 2 * el.n_links
    es.update_links(state, np.arange(n, dtype=np.int32),
                    random_link_props(n, 1), np.ones(n, bool),
                    contiguous=True)
    routed = entry.build_routed(
        el, state, np.arange(8, el.n_nodes), seed=31,
        rate_bps=cs.ROUTED_RATE_BPS, q=cs.SIM_Q, k_fwd=cs.ROUTED_K_FWD,
        max_hops=cs.ROUTE_HOPS)[:3]
    m, k1 = cs.run_scale_phase(el, state, dev, "test", routed=routed,
                               rung_kw={
        "routes_10k": dict(n_nodes=200, n_links=600, dst_chunk=40),
        "chaos_flaps": dict(n_nodes=60, n_links=180, events=2,
                            steps_per_event=10),
        "reconverge_10k": dict(pods=3, leaves_per_pod=8)})
    assert k1["sharded_step"] == sum(cs.SH_SHARDS) * cs.SH_STEPS
    assert k1["sharded_router"] == cs.SR_SHARDS * 12 * (
        cs.SR_STEPS + cs.SR_OVERFLOW_STEPS)
    assert k1["rungs"] == 10 * 10 * 5
    assert m["b"]["overflow"]["fwd_dropped"] > 0


def test_dryrun_multichip_on_the_card(dev, capsys):
    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.ops.cuda import shaping

    shaping.reset_launches()
    out = entry.dryrun_multichip(8)
    assert out["device"].startswith("cuda")
    assert out["tx_packets"] == out["delivered"] > 0
    assert shaping.LAUNCHES["shape_step_rows"] == 8   # K1 once a shard
    assert "dryrun_multichip(8): OK" in capsys.readouterr().out


def test_exchange_probe_of_a_sharded_plane_on_the_card(dev):
    """The sampled exchange probe on the card: it runs on the first
    dispatch, each run one K4 launch (2 virtual shards, 1 ring step),
    and its output == the plain ring's on an owned mailbox."""
    from kubedtn_tpu_torch import runtime
    from kubedtn_tpu_torch.ops.edge_state import NCORR, NPROP
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    _g, plane, _c, _e = _drive_plane("cuda", 2, shards=2, ticks=2)
    assert plane.shard_exchange_runs == 1
    assert plane.shard_summary()["exchange_seconds"] > 0
    fm = torch.randn((64, NPROP + 3 + NCORR), device=dev)
    im = torch.randint(-5, 5, (64, 3), device=dev, dtype=torch.int32)
    im[:, pex.OWNER_COL] = 1
    before = pex.LAUNCHES["ring_step"]
    got = plane._exchange_probe(fm, im)
    torch.cuda.synchronize()
    assert pex.LAUNCHES["ring_step"] == before + 1
    want = runtime.exchange_probe(make_mesh(["cpu"] * 2))(fm.cpu(),
                                                          im.cpu())
    assert_bitwise(got[0].cpu(), want[0], "probe f32 payload")
    assert_bitwise(got[1].cpu(), want[1], "probe i32 payload")



def test_live_plane_soaks_on_the_card(dev):
    """live_plane and the TBF live_plane_soak at the CPU tests' sizes on
    a plane on the card: every frame delivered, every window alive."""
    from kubedtn_tpu_torch import scenarios

    r = scenarios.live_plane(pairs=2, frames_per_wire=1_000, rounds=1,
                             timeout_s=120.0, device=dev)
    assert r["device"].startswith("cuda")
    assert r["frames_delivered"] == 2 * 1024
    assert r["dropped"] == 0 and r["tick_errors"] == 0
    r = scenarios.live_plane_soak(pairs=2, seconds=3.0, window_s=1.0,
                                  rate="2Gbit", chunk=512, device=dev)
    assert r["dropped"] == 0 and r["tick_errors"] == 0
    assert r["windows_frames_per_s"]
    assert all(w > 0 for w in r["windows_frames_per_s"])


def test_chaos_soak_on_the_card(dev):
    """chip_smoke.py's 23(c) at the CPU test's size: A's plane on the
    card, zero loss, the breaker cycling, a cross-node trace."""
    import logging

    from kubedtn_tpu_torch import scenarios

    logging.disable(logging.WARNING)
    try:
        r = scenarios.chaos_soak(pairs=2, seconds=3.0, flap_period_s=1.0,
                                 offered_frames_per_s=6_000, seed=11,
                                 device=dev)
    finally:
        logging.disable(logging.NOTSET)
    assert r["device"].startswith("cuda")
    assert r["frames_lost"] == 0 and r["peer_buffer_dropped"] == 0, r
    assert r["shaping_dropped"] == 0 and r["tick_errors"] == 0, r
    assert r["breaker_cycles"] >= 1, r["breaker"]
    assert r["trace_ok"] and len(r["trace_nodes"]) == 2, r
    for stage in ("ingress", "outage-buffered", "retried", "peer-sent",
                  "received"):
        assert stage in r["trace_stages"], r["trace_stages"]


def test_staged_update_soak_gates_through_k1_on_the_card(dev):
    """chip_smoke.py's 23(d) and (f) at the CPU test's size: zero loss,
    the regressing delta rejected with the plane untouched, K1 launched
    exactly gates x ticks x slots, and the regressing gate's sweep on
    its own snapshot through K1 == the plain version, bit for bit."""
    import chip_smoke
    from kubedtn_tpu_torch import scenarios

    shaping.reset_launches()
    with chip_smoke.GateLog() as gates:
        r = scenarios.staged_update_soak(pairs=2, steady_s=1.0,
                                         staging_s=1.0, gate_ticks=60,
                                         device=dev)
    k1 = shaping.LAUNCHES["shape_step_rows"]
    assert r["frames_lost"] == 0 and r["tick_errors"] == 0, r
    assert r["clean_plans_verified"] == r["clean_plans"] == 2, r
    assert r["regressing_rejected"] and r["gate_left_plane_untouched"], r
    assert len(gates.calls) == 3
    assert k1 == chip_smoke._gate_launches(gates.calls, 60, "test") \
        == 3 * 60 * 4
    out = chip_smoke.replay_gate_sweep(gates.calls[-1], True, "test")
    assert out["k1_compare_launches"] == 60 * 4


def test_whatif_sweep_replay_k1_equals_plain_on_the_card(dev):
    """chip_smoke.py's 24(d) small: whatif_sweep's sweep launches K1
    once a shaping slot and step, and its recorded sweep, swept again
    for 2 steps through K1 and through the plain version, is the same
    in every metric, bit for bit."""
    import chip_smoke
    from kubedtn_tpu_torch import scenarios

    shaping.reset_launches()
    with chip_smoke.SweepLog() as sweeps:
        r = scenarios.whatif_sweep(replicas=6, steps=40, n_nodes=12,
                                   n_links=24, k_slots=2, device=dev)
    assert r["device"] == str(dev) and r["replicas"] == 6
    assert shaping.LAUNCHES["shape_step_rows"] == 40 * 2
    assert len(sweeps.calls) == 1
    out = chip_smoke.replay_whatif_sweep(sweeps.calls[0], True, 2)
    assert out["k1_compare_launches"] == 2 * 2
