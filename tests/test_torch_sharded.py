"""The sharded live tick of the port on the CPU: the mailbox ring exchange
against JAX's ppermute ring on the forced 8-device CPU mesh
(tests/conftest.py), the port's sharded tick against its unsharded tick
bit for bit on 1, 2, 4 and 8 virtual CPU shards, and the port's sharded
tick against the JAX package's shard_map program at the tolerances of
tests/test_torch_live_tick.py.

The installed jax (0.9) checks that a shard_map's replicated outputs are
provably replicated, and the JAX package's sharded programs
(`_make_sharded_fused`, `_exchange_probe_for`) fail that check as they
are built. The `jax_rep_unchecked` fixture builds them with the check
off — what kubedtn_tpu/parallel/mesh.py itself does on older jax
(`check_rep=False`), where its comment states the semantics are the
same. Nothing in the JAX package is edited.

On the CPU the ring steps run kernel K4's plain version, the list
rotation; the card runs the kernel (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from kubedtn_tpu import runtime as jrt
from kubedtn_tpu import telemetry as jtele
from kubedtn_tpu.parallel import exchange as jpex
from kubedtn_tpu.parallel import mesh as jmesh
from kubedtn_tpu_torch import convert, entry
from kubedtn_tpu_torch import runtime as trt
from kubedtn_tpu_torch import telemetry as ttele
from kubedtn_tpu_torch.api.types import LinkProperties
from kubedtn_tpu_torch.models.topologies import (clos,
                                                 load_edge_list_into_state)
from kubedtn_tpu_torch.parallel import exchange as tpex
from kubedtn_tpu_torch.parallel import partition
from kubedtn_tpu_torch.parallel.mesh import make_mesh, shard_edge_state
from test_torch_live_tick import (KINDS, assert_bitwise, assert_dyn_close,
                                  assert_out_close, assert_tel_close,
                                  jax_args, jax_uniforms, torch_args)
from test_torch_netem import jax_state

WF, WI = 21, 3           # the mailbox: NPROP + 3 clocks + NCORR, 3 ints
ELAPSED_US = 1500.0


@pytest.fixture
def jax_rep_unchecked(monkeypatch):
    monkeypatch.setattr(jmesh, "shard_map",
                        functools.partial(jax.shard_map, check_vma=False))
    # a probe cached by an earlier build with the check on would fail
    monkeypatch.setattr(jrt, "_EXCHANGE_PROBE_CACHE", {})


# -- the ring exchange ---------------------------------------------------------

def mailboxes(S: int, R: int, seed: int):
    """Per-shard (fmail [R, WF], imail [R, WI]) with each row owned by
    exactly one shard (column OWNER_COL = 1 there), zero elsewhere."""
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, S, R)
    f = rng.standard_normal((R, WF)).astype(np.float32)
    i = rng.integers(-1000, 1000, (R, WI)).astype(np.int32)
    i[:, tpex.OWNER_COL] = 1
    fm = [np.where((owner == s)[:, None], f, 0).astype(np.float32)
          for s in range(S)]
    im = [np.where((owner == s)[:, None], i, 0).astype(np.int32)
          for s in range(S)]
    return fm, im, f, i


@pytest.mark.parametrize("S", [2, 4, 8])
def test_ring_exchange_matches_jax_ppermute_ring(S):
    R = 64
    fm, im, f, i = mailboxes(S, R, seed=S)
    mesh = jmesh.make_mesh(S)
    exch = jpex.make_ring_exchange(S, jmesh.EDGE_AXIS)
    edge = P(jmesh.EDGE_AXIS)
    jfn = jax.jit(jmesh.shard_map(exch, mesh=mesh, in_specs=(edge, edge),
                                  out_specs=(edge, edge)))
    jf, ji = jfn(jnp.asarray(np.concatenate(fm)),
                 jnp.asarray(np.concatenate(im)))
    tf, ti = tpex.make_ring_exchange(S)([torch.as_tensor(x) for x in fm],
                                        [torch.as_tensor(x) for x in im])
    for s in range(S):
        blk = slice(s * R, (s + 1) * R)
        np.testing.assert_array_equal(tf[s].numpy().view(np.int32),
                                      np.asarray(jf)[blk].view(np.int32))
        np.testing.assert_array_equal(ti[s].numpy(), np.asarray(ji)[blk])
        # every shard now holds every row's owner payload
        np.testing.assert_array_equal(tf[s].numpy(), f)
        np.testing.assert_array_equal(ti[s].numpy(), i)


@pytest.mark.parametrize("S", [2, 4, 8])
def test_exchange_probe_matches_jax(S, jax_rep_unchecked):
    fm, im, _, _ = mailboxes(S, 8, seed=10 + S)
    jf, ji = jrt._exchange_probe_for(jmesh.make_mesh(S))(
        jnp.asarray(fm[0]), jnp.asarray(im[0]))
    tf, ti = trt.exchange_probe(make_mesh(["cpu"] * S))(
        torch.as_tensor(fm[0]), torch.as_tensor(im[0]))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_ring_step_plain_is_the_rotation():
    blocks = [torch.full((3, 24), s, dtype=torch.int32) for s in range(4)]
    before = tpex.LAUNCHES["ring_step"]
    out = tpex.ring_right_shift(blocks, make_mesh(["cpu"] * 4))
    assert [int(b[0, 0]) for b in out] == [3, 0, 1, 2]
    assert tpex.LAUNCHES["ring_step"] == before  # plain runs do not count
    ints = torch.tensor([[7]], dtype=torch.int32)
    f, i = tpex.unpack_words(tpex.pack_words(torch.tensor([[1.5, -0.0]]),
                                             ints), 2)
    assert torch.equal(f.view(torch.int32),
                       torch.tensor([[1.5, -0.0]]).view(torch.int32))
    assert int(i[0, 0]) == 7


def test_partition_and_mesh_helpers():
    assert partition.shard_ranges(256, 4) == [(0, 64), (64, 128),
                                              (128, 192), (192, 256)]
    with pytest.raises(ValueError):
        partition.shard_ranges(100, 3)
    np.testing.assert_array_equal(
        partition.shard_of_rows([0, 63, 64, 255], 256, 4), [0, 0, 1, 3])
    mesh = make_mesh(["cpu", "cpu"])
    assert mesh == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_mesh([])
    el = clos(2, 4, 0, links_per_pair=2)
    state, _ = load_edge_list_into_state(el, device="cpu")
    shards = shard_edge_state(state, mesh)
    assert [s.capacity for s in shards] == [state.capacity // 2] * 2
    back = convert.unshard(shards)
    for name in ("uid", "props", "active", "corr", "pkt_count"):
        assert torch.equal(getattr(back, name), getattr(state, name))
    dyn = (state.tokens, state.t_last, state.backlog_until, state.corr,
           state.pkt_count)
    assert_bitwise(convert.unshard(convert.shard(dyn, mesh)), dyn)


# -- the sharded tick ------------------------------------------------------------

@pytest.fixture(scope="module")
def clos_case():
    """A Clos of 96 links (192 directed rows in E = 256) in the three
    classes of entry.build_live_tick, with one tick's groups whose busy
    rows include both ends of 20 links (row i in the TBF third, row
    96 + i in the sequential third, so the pairs straddle a block for
    every S >= 2) and three overloaded TBF rows (backlog 200 ms), which
    raise the fallback flag."""
    el = clos(4, 12, 0, props=LinkProperties(latency="10ms", rate="10Gbit"),
              links_per_pair=2)
    state, _ = load_edge_list_into_state(el, device="cpu")
    entry.build_live_tick(el, state, 20, 16, 3, device="cpu")
    L = el.n_links
    links = np.arange(40, 60)
    state.backlog_until[links[:3]] = 2e5
    rng = np.random.default_rng(5)
    rows = {"tbf": links, "seq": L + links,
            "ind": np.arange(64, 128, 3)}
    batches, groups = [], {}
    for kind in KINDS:
        groups[kind] = list(range(len(batches),
                                  len(batches) + len(rows[kind])))
        for r in rows[kind]:
            lens = rng.integers(64, 1501, rng.integers(1, 17)) \
                .astype(np.float32)
            batches.append((None, int(r), lens, None, False))
    kmap = {b[1]: entry.link_key_id(b[1]) for b in batches}
    E = state.capacity
    quads = {k: jrt._build_group(batches, groups[k], E, kmap) for k in KINDS}
    return state, quads, L


def straddling_pairs(rows: np.ndarray, L: int, E: int, S: int) -> int:
    """Busy rows whose link's other direction is busy too and lies in
    another shard's block."""
    busy = set(int(r) for r in rows if r < E)
    own = partition.shard_of_rows
    return sum(1 for r in busy if (r + L) in busy
               and own([r], E, S)[0] != own([r + L], E, S)[0])


def run_unsharded(state, a, ticks, uniforms=None):
    key, dyn = trt.tick_key(21), None
    tel, outs = ttele.init_acc(state.capacity, "cpu"), []
    for t in range(ticks):
        key, _sub, dyn, o, tel = trt.fused_tick(
            state, dyn, key, ELAPSED_US, a["seq"], a["tbf"], a["ind"], tel,
            uniforms=None if uniforms is None else uniforms[t])
        outs.append(o)
    return outs, dyn, tel


def run_sharded(state, a, S, ticks, uniforms=None):
    mesh = make_mesh(["cpu"] * S)
    fn = trt.make_sharded_fused(mesh)
    shards = convert.shard(state, mesh)
    key, dyn = trt.tick_key(21), None
    tel = convert.shard(ttele.init_acc(state.capacity, "cpu"), mesh)
    outs = []
    for t in range(ticks):
        key, _sub, dyn, o, tel = fn(
            shards, dyn, key, ELAPSED_US, a["seq"], a["tbf"], a["ind"], tel,
            uniforms=None if uniforms is None else uniforms[t])
        outs.append(o)
    assert len(dyn) == S and len(tel) == S
    return outs, convert.unshard(dyn), convert.unshard(tel)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sharded_tick_equals_unsharded_bitwise(clos_case, S):
    state, quads, L = clos_case
    a = {k: torch_args(quads[k]) for k in KINDS}
    want = run_unsharded(state, a, 3)
    got = run_sharded(state, a, S, 3)
    assert_bitwise(got, want, f"S={S}")
    assert any(bool(o["tbf"][5].any()) for o in want[0]), "no fallback"
    rows = np.concatenate([quads[k][0] for k in KINDS])
    n = straddling_pairs(rows, L, state.capacity, S)
    assert (n > 0) == (S > 1)


def test_sharded_tick_per_class_bitwise(clos_case):
    """Each class alone through the sharded program (4 shards)."""
    state, quads, _ = clos_case
    fn = trt.make_sharded_fused(make_mesh(["cpu"] * 4))
    shards = convert.shard(state, make_mesh(["cpu"] * 4))
    for kind in KINDS:
        args = {k: (torch_args(quads[k]) if k == kind else None)
                for k in KINDS}
        w = trt.fused_tick(state, None, trt.tick_key(8), ELAPSED_US,
                           args["seq"], args["tbf"], args["ind"])
        g = fn(shards, None, trt.tick_key(8), ELAPSED_US, args["seq"],
               args["tbf"], args["ind"])
        assert g[0] == w[0] and g[1] == w[1]
        assert_bitwise(g[3], w[3], kind)
        assert_bitwise(convert.unshard(g[2]), w[2], kind)
        assert g[4] is None


def test_sharded_tick_rejects_a_wrong_mesh(clos_case):
    state, quads, _ = clos_case
    fn = trt.make_sharded_fused(make_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="shards for a mesh"):
        fn(convert.shard(state, make_mesh(["cpu"] * 4)), None,
           trt.tick_key(0), 0.0, None, None, torch_args(quads["ind"]))


@pytest.mark.parametrize("S", [2, 8])
def test_sharded_tick_matches_jax_sharded(clos_case, S, jax_rep_unchecked):
    state, quads, _ = clos_case
    d = convert.edge_state_to_numpy(state)
    js = jax_state(d)
    jfn = jrt._make_sharded_fused(jmesh.make_mesh(S))
    ja = {k: jax_args(quads[k]) for k in KINDS}
    key = jax.random.PRNGKey(3)
    jdyn, jtel = None, jnp.zeros((state.capacity, jtele.KCOLS), jnp.float32)
    us, jouts = [], []
    for _ in range(3):
        us.append({k: torch.as_tensor(v) for k, v in
                   jax_uniforms(jax.random.split(key)[1], quads).items()})
        key, _sub, jdyn, o, jtel = jfn(
            js, jdyn, key, jnp.float32(ELAPSED_US), ja["seq"], ja["tbf"],
            ja["ind"], jtel, has_seq=True, has_tbf=True, has_ind=True,
            has_dyn=jdyn is not None, has_tel=True)
        jouts.append(o)
    a = {k: torch_args(quads[k]) for k in KINDS}
    touts, tdyn, ttel = run_sharded(state, a, S, 3, uniforms=us)
    for t in range(3):
        for kind in KINDS:
            assert_out_close(touts[t][kind], jax.tree.map(np.asarray,
                                                          jouts[t][kind]),
                             kind, f"tick {t}")
    assert_dyn_close(tdyn, jax.tree.map(np.asarray, jdyn))
    assert_tel_close(ttel, np.asarray(jtel))
