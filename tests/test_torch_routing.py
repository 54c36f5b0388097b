"""Port parity: kubedtn_tpu_torch.ops.routing against
kubedtn_tpu.ops.routing on the CPU.

Graphs are built once with the JAX package's generators and handed to
both packages as one numpy edge state. `dist`, `nh`, the reachability
mask and the incremental path's `cells` must equal the JAX package's
exactly: min-plus relaxation only adds and takes minima, one rounding
per add in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedtn_tpu.api.types import LinkProperties
from kubedtn_tpu.models import topologies as jT
from kubedtn_tpu.ops import edge_state as jes
from kubedtn_tpu.ops import routing as jR
from kubedtn_tpu_torch.ops import routing as tR

from test_torch_netem import jax_state, jax_to_numpy, torch_state


def with_latencies(d: dict, seed: int, lo=1000, hi=20000) -> dict:
    """The state with per-row random latencies (breaks ties)."""
    rng = np.random.default_rng(seed)
    d = dict(d, props=d["props"].copy())
    d["props"][:, jes.P_LATENCY_US] = rng.uniform(
        lo, hi, d["props"].shape[0]).astype(np.float32)
    return d


def cut(d: dict, rows) -> dict:
    """delete_links on the numpy state."""
    d = {k: v.copy() for k, v in d.items()}
    d["uid"][rows] = -1
    d["active"][rows] = False
    d["props"][rows] = 0.0
    return d


def graph(name: str):
    """(numpy edge state, n_nodes) of a named small graph."""
    lat = LinkProperties(latency="1ms")
    if name == "line":
        el = jT.line(6, LinkProperties(latency="10ms"))
    elif name == "partition":
        el = jT.line(7, lat)
    elif name == "directed":
        el = jT.line(5, lat)
    elif name == "clos":
        el = jT.clos(3, 6, 0, props=lat, links_per_pair=2)
    elif name == "clos_hetero":
        el = jT.clos(4, 8, 0, props=lat)
    elif name == "fat_tree":
        el = jT.fat_tree(4, lat)
    else:
        raise KeyError(name)
    state, _ = jT.load_edge_list_into_state(el)
    d = jax_to_numpy(state)
    if name == "partition":     # cut the link 2-3, both directions
        d = cut(d, [2, 2 + el.n_links])
    if name == "directed":      # only the directions i -> i+1 are left
        d = cut(d, np.arange(el.n_links, 2 * el.n_links))
    if name == "clos_hetero":
        d = with_latencies(d, 5)
    return d, el.n_nodes


GRAPHS = ["line", "partition", "directed", "clos", "clos_hetero",
          "fat_tree"]


def same(got: torch.Tensor, want, name=""):
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, name
    np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


@pytest.mark.parametrize("name", GRAPHS)
def test_reachability_and_adjacency_match_jax(name):
    d, n = graph(name)
    same(tR.adjacency(torch_state(d), n), jR.adjacency(jax_state(d), n))
    got = tR.reachability(torch_state(d), n)
    same(got, jR.reachability(jax_state(d), n))
    if name == "partition":
        assert got[0, 2] and not got[0, 3] and got[3, 6]
    if name == "directed":
        assert torch.equal(got, torch.ones(n, n).triu() > 0)


@pytest.mark.parametrize("name", GRAPHS)
def test_all_pairs_dist_chunked_unchunked_jax(name):
    d, n = graph(name)
    js, ts = jax_state(d), torch_state(d)
    want = jR.all_pairs_dist(js, jR.edge_weights_latency(js), None, n, 8)
    w = tR.edge_weights_latency(ts)
    same(w, jR.edge_weights_latency(js))
    got = tR.all_pairs_dist(ts, w, None, n, 8)
    same(got, want)
    chunk = next(c for c in (5, 4, 3, 2, 7) if n % c == 0)
    same(tR.all_pairs_dist(ts, w, None, n, 8, chunk), want)
    same(tR.all_pairs_dist(ts, w, None, n, 8, 10 * n), want)
    assert bool(torch.isinf(got).any()) == (name in ("partition",
                                                     "directed"))
    with pytest.raises(ValueError, match="must divide"):
        tR.all_pairs_dist(ts, w, None, n, 8, n - 1)


@pytest.mark.parametrize("name", GRAPHS)
def test_recompute_routes_and_max_hops_match_jax(name):
    d, n = graph(name)
    js, ts = jax_state(d), torch_state(d)
    for hops in (1, 8):
        jd, jn = jR.recompute_routes(js, n, max_hops=hops)
        td, tn = tR.recompute_routes(ts, n, max_hops=hops)
        same(td, jd, f"dist hops={hops}")
        same(tn, jn, f"nh hops={hops}")
    chunk = next(c for c in (5, 4, 3, 2, 7) if n % c == 0)
    td2, tn2 = tR.recompute_routes(ts, n, max_hops=8, dst_chunk=chunk)
    same(td2, jd)
    same(tn2, jn)
    # every next hop realises its distance; none where there is no path
    w, dst = tR.edge_weights_latency(ts), ts.dst.long()
    ii, jj = torch.nonzero(tn >= 0, as_tuple=True)
    e = tn[ii, jj].long()
    assert torch.equal(w[e] + td[dst[e], jj], td[ii, jj])
    assert (tn[~torch.isfinite(td)] == -1).all()
    assert (tn.diagonal() == -1).all()


@pytest.mark.parametrize("k_paths", [1, 2, 4])
@pytest.mark.parametrize("name", ["clos", "fat_tree", "partition"])
def test_ecmp_next_hops_match_jax(name, k_paths):
    d, n = graph(name)
    js, ts = jax_state(d), torch_state(d)
    jd, jn = jR.recompute_routes_ecmp(js, n, k_paths=k_paths, max_hops=8)
    td, tn = tR.recompute_routes_ecmp(ts, n, k_paths=k_paths, max_hops=8)
    same(td, jd)
    same(tn, jn)
    assert tuple(tn.shape) == (n, n, k_paths)
    if k_paths == 1:
        same(tn[:, :, 0], jR.next_hop_edges(js, jd, n))
    elif name != "partition":    # equal-cost fabrics have real groups
        assert ((tn >= 0).sum(dim=-1) >= 2).any()
    chunk = next(c for c in (5, 4, 3, 7) if n % c == 0)
    same(tR.ecmp_next_hop_edges(ts, td, n, k_paths, chunk), jn)


def test_refine_dist_matches_jax_and_converges():
    d, n = graph("clos_hetero")
    js, ts = jax_state(d), torch_state(d)
    seed = np.full((n, n), np.inf, np.float32)
    want = jR.refine_dist(js, n, jnp.asarray(seed), 64)
    got = tR.refine_dist(ts, n, torch.as_tensor(seed), 64)
    same(got, want)
    same(tR.refine_dist(ts, n, torch.as_tensor(seed), 64, 4), want)
    same(tR.refine_dist(ts, n, got, 64), want)          # a fixpoint
    same(tR.refine_dist(ts, n, torch.as_tensor(seed), 1),
         jR.refine_dist(js, n, jnp.asarray(seed), 1))   # the cap binds


# -- incremental reconvergence --------------------------------------------

class Net:
    """A graph held as one numpy state, with the routes of both
    packages kept converged beside it."""

    def __init__(self, el, lat_seed=None):
        self.el = el
        self.n = el.n_nodes
        state, _ = jT.load_edge_list_into_state(el)
        self.d = jax_to_numpy(state)
        if lat_seed is not None:
            self.d = with_latencies(self.d, lat_seed)
        self.orig = {k: v.copy() for k, v in self.d.items()}
        inf = np.full((self.n, self.n), np.inf, np.float32)
        js, ts = jax_state(self.d), torch_state(self.d)
        self.jdist = jR.refine_dist(js, self.n, jnp.asarray(inf), 64)
        self.jnh = jR.next_hop_edges(js, self.jdist, self.n)
        self.tdist = tR.refine_dist(ts, self.n, torch.as_tensor(inf), 64)
        self.tnh = tR.next_hop_edges(ts, self.tdist, self.n)
        same(self.tdist, self.jdist)
        same(self.tnh, self.jnh)

    def weights(self, rows):
        w = np.where(self.d["active"], self.d["props"][:, 0] + 1.0, np.inf)
        return w.astype(np.float32)[rows]

    def event(self, rows, new_state: dict) -> int:
        """Move to `new_state`, whose rows `rows` changed weight, through
        both packages' incremental paths; hold them equal; returns
        cells."""
        rows = np.asarray(rows)
        w_old = self.weights(rows)
        s_k, d_k = self.d["src"][rows], self.d["dst"][rows]
        self.d = new_state
        w_new = self.weights(rows)
        self.jdist, self.jnh, jcells = jR.update_routes_incremental(
            jax_state(self.d), self.n, self.jdist, self.jnh, s_k, d_k,
            w_old, w_new)
        t_in, t_copy = self.tdist, self.tdist.clone()
        self.tdist, self.tnh, tcells = tR.update_routes_incremental(
            torch_state(self.d), self.n, self.tdist, self.tnh, s_k, d_k,
            w_old, w_new)
        assert torch.equal(t_in, t_copy)    # the input is left as it was
        same(self.tdist, self.jdist, "dist")
        same(self.tnh, self.jnh, "nh")
        assert tcells == jcells
        return tcells

    def down(self, rows) -> int:
        return self.event(rows, cut(self.d, rows))

    def up(self, rows) -> int:
        new = {k: v.copy() for k, v in self.d.items()}
        for k in ("uid", "src", "dst", "active", "props"):
            new[k][rows] = self.orig[k][rows]
        return self.event(rows, new)

    def assert_exact(self):
        """The incremental result is the converged full recompute."""
        ts = torch_state(self.d)
        inf = torch.full((self.n, self.n), torch.inf)
        full = tR.refine_dist(ts, self.n, inf, 64)
        np.testing.assert_allclose(self.tdist.numpy(), full.numpy(),
                                   rtol=1e-5, atol=1e-1)
        w, dst = tR.edge_weights_latency(ts), ts.dst.long()
        ii, jj = torch.nonzero(self.tnh >= 0, as_tuple=True)
        e = self.tnh[ii, jj].long()
        np.testing.assert_allclose(
            (w[e] + self.tdist[dst[e], jj]).numpy(),
            self.tdist[ii, jj].numpy(), rtol=1e-5, atol=1e-1)
        assert (self.tnh[~torch.isfinite(self.tdist)] == -1).all()


def both_directions(links, n_links):
    links = np.asarray(links)
    return np.concatenate([links, links + n_links]).astype(np.int32)


def mesh(n_nodes, n_links, seed):
    return Net(jT.random_mesh(n_nodes, n_links, seed=seed,
                              props=LinkProperties(latency="1ms")),
               lat_seed=seed + 1)


@pytest.mark.parametrize("mesh_seed,ev_seed", [(7, 0), (9, 2)])
def test_incremental_down_then_up_matches_jax(mesh_seed, ev_seed):
    net = mesh(120, 360, mesh_seed)
    rng = np.random.default_rng(ev_seed)
    for _ in range(2):
        rows = both_directions(rng.choice(net.el.n_links, 2, replace=False),
                               net.el.n_links)
        assert net.down(rows) > 0
        net.assert_exact()
        net.up(rows)
        net.assert_exact()
    # back where it began, up to the rounding of other path sums
    np.testing.assert_allclose(
        net.tdist.numpy(), Net(net.el, lat_seed=mesh_seed + 1).tdist.numpy(),
        rtol=1e-6)


def test_incremental_ten_link_flap_matches_jax():
    net = mesh(150, 450, 21)
    rows = both_directions(
        np.random.default_rng(5).choice(net.el.n_links, 10, replace=False),
        net.el.n_links)
    first = net.tdist.clone()
    assert net.down(rows) > 0
    net.assert_exact()
    net.up(rows)
    net.assert_exact()
    np.testing.assert_allclose(net.tdist.numpy(), first.numpy(), rtol=1e-6)


@pytest.mark.parametrize("mesh_seed,ev_seed", [(31, 9), (44, 17), (58, 23)])
def test_incremental_mixed_event_matches_jax(mesh_seed, ev_seed):
    net = mesh(120, 360, mesh_seed)
    L = net.el.n_links
    pick = np.random.default_rng(ev_seed).choice(L, 6, replace=False)
    slow, fast = both_directions(pick[:3], L), both_directions(pick[3:], L)
    new = {k: v.copy() for k, v in net.d.items()}
    new["props"][slow, jes.P_LATENCY_US] *= 50.0     # increases
    new["props"][fast, jes.P_LATENCY_US] *= 0.02     # decreases
    assert net.event(np.concatenate([slow, fast]), new) > 0
    net.assert_exact()


def three_tier_net():
    return Net(jT.three_tier(pods=4, leaves_per_pod=12, aggs_per_pod=2,
                             cores=4, uplinks_per_leaf=2, cores_per_agg=2,
                             seed=1))


@pytest.mark.parametrize("factor", [50.0, 0.02])
def test_incremental_one_direction_takes_one_block(factor):
    """One directed row slower (or faster): a single projection, the
    chooser's one-block strategy."""
    net = mesh(120, 360, 3)
    new = {k: v.copy() for k, v in net.d.items()}
    new["props"][5, jes.P_LATENCY_US] *= factor
    assert net.event(np.array([5]), new) > 0
    net.assert_exact()


@pytest.mark.parametrize("n_up,n_dn,slower,faster",
                         [(1, 1, 1.3, 0.9), (2, 2, 2.0, 0.8),
                          (1, 1, 50.0, 0.5)])
def test_incremental_mixed_event_with_grouped_products(n_up, n_dn, slower,
                                                       faster):
    """A mixed event on links that few shortest paths cross: the
    improvement products stay on grouped blocks (no dense pass), seeded
    with the increases' invalidation."""
    net = mesh(120, 360, 31)
    L = net.el.n_links
    ts = torch_state(net.d)
    rows = torch.arange(2 * L)
    cols_f, rows_f = tR._per_edge_up_flags(
        net.tdist, ts.src[rows], ts.dst[rows],
        tR.edge_weights_latency(ts)[rows])
    foot = (cols_f.sum(dim=1) + rows_f.sum(dim=1)).numpy()
    foot = foot[:L] + foot[L:]          # per link, both directions
    narrow = [int(x) for x in np.argsort(foot, kind="stable")
              if foot[x] > 0][:n_up + n_dn]
    slow = both_directions(narrow[:n_up], L)
    fast = both_directions(narrow[n_up:], L)
    new = {k: v.copy() for k, v in net.d.items()}
    new["props"][slow, jes.P_LATENCY_US] *= slower
    new["props"][fast, jes.P_LATENCY_US] *= faster
    cells = net.event(np.concatenate([slow, fast]), new)
    net.assert_exact()
    assert 0 < cells < net.n * net.n


def test_incremental_no_change_event_is_free():
    net = mesh(100, 300, 12)
    rows = both_directions([0], net.el.n_links)
    new = {k: v.copy() for k, v in net.d.items()}
    new["props"][rows, jes.P_LATENCY_US] = 1e9
    net.event(rows, new)        # nothing routes through it any more
    assert net.down(rows) == 0
    # an event whose weights did not change at all
    assert net.event(rows, net.d) == 0


def test_incremental_stub_uplink_takes_the_row_projection():
    net = three_tier_net()
    leaf0 = 4 + 4 * 2
    row = int(np.nonzero(net.d["src"] >= leaf0)[0][0])
    rows = both_directions([row % net.el.n_links], net.el.n_links)
    cells = net.down(rows)
    net.assert_exact()
    assert 0 < cells < net.n * net.n // 4


def test_incremental_link_up_reconnects_a_partition():
    net = Net(jT._mk(["n0", "n1", "n2", "n3", "n4"],
                     [(0, 1), (1, 2), (2, 3), (3, 4)],
                     LinkProperties(latency="1ms")))
    rows = both_directions([3], net.el.n_links)
    net.down(rows)
    assert not torch.isfinite(net.tdist[0, 4])
    assert net.up(rows) > 0
    assert torch.isfinite(net.tdist[0, 4]) and net.tnh[0, 4] >= 0
    net.assert_exact()


def test_incremental_dense_fallback_matches_jax():
    """A cut that every pair crosses: the chooser goes dense."""
    net = Net(jT.line(12, LinkProperties(latency="1ms")))
    rows = both_directions([5], net.el.n_links)
    net.down(rows)
    net.assert_exact()
    net.up(rows)
    net.assert_exact()


def test_segment_min_and_take_follow_jax_index_rules():
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([0, 5, -1, 3, 99])
    same(tR._take(x, idx), jnp.asarray(x.numpy())[jnp.asarray(idx.numpy())])
    seg = torch.tensor([2, 0, 2, 3])            # 3 = the drop segment
    got = tR._segment_min(x, seg, 3)
    assert torch.equal(got[0], x[1]) and torch.isinf(got[1]).all()
    assert torch.equal(got[2], x[0])
    assert dataclasses.is_dataclass(torch_state(graph("line")[0]))
