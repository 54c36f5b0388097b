"""The port's control plane (topology/store, freelist, reconciler,
SimEngine) against the JAX package's, given the same sequence of
Topology CRs: add, update, delete, a destroyed pod, growth past the
capacity, and compact(). After every step the row bindings (row_of /
reverse_row), the per-row link key ids and every EdgeState column must
be EXACTLY equal. ping on a deterministic link gives JAX's one-way
delays, and trace JAX's path.
"""

import numpy as np
import pytest

import kubedtn_tpu.api.types as jtypes
import kubedtn_tpu.topology.engine as jeng
import kubedtn_tpu.topology.freelist as jfree
import kubedtn_tpu.topology.reconciler as jrec
import kubedtn_tpu.topology.store as jst
import kubedtn_tpu_torch.api.types as ttypes
import kubedtn_tpu_torch.topology.engine as teng
import kubedtn_tpu_torch.topology.freelist as tfree
import kubedtn_tpu_torch.topology.reconciler as trec
import kubedtn_tpu_torch.topology.store as tst

PKG = {"jax": (jeng, jst, jrec, jtypes), "torch": (teng, tst, trec, ttypes)}
FIELDS = ("uid", "src", "dst", "active", "props", "tokens", "t_last",
          "corr", "pkt_count", "backlog_until")

PROPS = [dict(latency="10ms"), dict(latency="5ms", jitter="1ms",
                                    loss="2"),
         dict(rate="10Mbit"), dict(latency="1ms", rate="1Gbit",
                                   loss_corr="20", loss="5"),
         dict(), dict(duplicate="3", reorder_prob="4", gap=2)]


def links_of(ty, pod, peers):
    """Spec links of `pod` to each (peer, uid, props index)."""
    return [ty.Link(local_intf=f"e{uid}", peer_intf=f"e{uid}",
                    peer_pod=peer, uid=uid,
                    properties=ty.LinkProperties(**PROPS[p]))
            for peer, uid, p in peers]


# pod -> [(peer, uid, props index)]; both ends of a link list it
FABRIC = {
    "p0": [("p1", 1, 0), ("p2", 2, 1), ("p3", 3, 2)],
    "p1": [("p0", 1, 0), ("p2", 4, 3)],
    "p2": [("p0", 2, 1), ("p1", 4, 3), ("p3", 5, 4)],
    "p3": [("p0", 3, 2), ("p2", 5, 4)],
}
# a second wave that outgrows capacity 16 (2 rows per link)
GROWTH = {
    "p4": [("p0", 6, 5), ("p1", 7, 0), ("p2", 8, 1), ("p3", 9, 2),
           ("p5", 10, 3)],
    "p5": [("p4", 10, 3), ("p0", 11, 4), ("p1", 12, 5)],
}


class Side:
    """One package's store + engine + reconciler, driven by CR edits."""

    def __init__(self, pkg, capacity=16):
        eng, st, rec, ty = PKG[pkg]
        self.ty = ty
        self.store = st.TopologyStore()
        kw = {"device": "cpu"} if pkg == "torch" else {}
        self.engine = eng.SimEngine(self.store, capacity=capacity, **kw)
        self.rec = rec.Reconciler(self.store, self.engine)

    def create(self, fabric):
        for pod, peers in fabric.items():
            t = self.ty.Topology(name=pod, spec=self.ty.TopologySpec(
                links=links_of(self.ty, pod, peers)))
            t.status.src_ip, t.status.net_ns = "10.0.0.1", f"/ns/{pod}"
            t.status.links = []
            self.store.create(t)
        self.rec.drain()

    def edit(self, pod, fn):
        t = self.store.get("default", pod)
        t.spec.links = fn(t.spec.links)
        self.store.update(t)
        self.rec.drain()

    def snapshot(self):
        e = self.engine
        st = e.state
        cols = {}
        for f in FIELDS:
            x = getattr(st, f)
            cols[f] = np.array(x.cpu() if hasattr(x, "cpu") else x)
        keys = sorted(e._rows)
        return {"cols": cols, "cap": st.capacity,
                "rows": {k: (e.row_of(*k), e.reverse_row(*k))
                         for k in keys},
                "keyid": np.array(e._row_keyid),
                "free": len(e._free), "shaped": sorted(e._shaped_rows)}


def assert_same(a, b):
    assert a["cap"] == b["cap"]
    assert a["rows"] == b["rows"]
    np.testing.assert_array_equal(a["keyid"], b["keyid"])
    assert a["free"] == b["free"] and a["shaped"] == b["shaped"]
    for f in FIELDS:
        np.testing.assert_array_equal(a["cols"][f], b["cols"][f],
                                      err_msg=f)


def swap_props(i):
    return lambda links: [l.with_properties(type(l.properties)(**PROPS[i]))
                          for l in links]


STEPS = {
    "add": lambda s: None,
    "update": lambda s: s.edit("p0", swap_props(3)),
    "update-peer": lambda s: s.edit("p2", swap_props(5)),
    "delete": lambda s: s.edit("p1", lambda links: links[:1]),
    "destroy": lambda s: s.engine.destroy_pod("p3"),
    "grow": lambda s: s.create(GROWTH),
    "compact": lambda s: s.engine.compact(),
    "update-after-compact": lambda s: s.edit("p4", swap_props(1)),
}


@pytest.fixture(scope="module")
def sequence():
    """Both packages through the whole CR sequence; the snapshot after
    every step."""
    out = {}
    for pkg in ("jax", "torch"):
        s = Side(pkg)
        s.create(FABRIC)
        snaps = []
        for name, step in STEPS.items():
            step(s)
            snaps.append((name, s.snapshot()))
        out[pkg] = (s, snaps)
    return out


@pytest.mark.parametrize("i,name", list(enumerate(STEPS)))
def test_engine_equals_jax_after_step(sequence, i, name):
    (nj, sj), (nt, st_) = sequence["jax"][1][i], sequence["torch"][1][i]
    assert nj == nt == name
    assert_same(sj, st_)


def test_sequence_exercised_growth_and_compact(sequence):
    snaps = dict(sequence["torch"][1])
    assert snaps["add"]["cap"] == 16 and snaps["grow"]["cap"] == 32
    rows = sorted(r for r, _rev in snaps["compact"]["rows"].values())
    assert rows == list(range(len(rows)))  # dense after compact
    # destroy_pod took p3's links (both directions) away
    assert not any(k[0] == "default/p3" for k in snaps["destroy"]["rows"])


@pytest.mark.parametrize("pod,uid", [("default/p0", 1), ("default/p4", 10),
                                     ("default/x/y", -3), ("", 0)])
def test_link_key_id_is_jax_fnv(pod, uid):
    assert teng.link_key_id(pod, uid) == jeng.link_key_id(pod, uid)


@pytest.mark.parametrize("fn", ["vni_from_uid", "uid_from_vni"])
def test_vni_helpers(fn):
    assert getattr(teng, fn)(4242) == getattr(jeng, fn)(4242)


@pytest.mark.parametrize("seed", [0, 7])
def test_ping_on_deterministic_link_matches_jax(seed):
    """p0-p1 (uid 1) carries props 0 (10 ms, no jitter) both ways."""
    res = {}
    for pkg in ("jax", "torch"):
        s = Side(pkg)
        s.create(FABRIC)
        res[pkg] = s.engine.ping("p0", "p1", 1, seed=seed)
    for k in ("reachable", "fwd_us", "rev_us", "rtt_us"):
        assert res["torch"][k] == res["jax"][k], k
    assert res["torch"]["fwd_us"] == 10_000.0


def test_ping_unknown_link(sequence):
    r = sequence["torch"][0].engine.ping("p0", "p9", 1)
    assert r == {"reachable": False, "rtt_us": float("inf")}


@pytest.mark.parametrize("a,b", [("p0", "p1"), ("p4", "p5"), ("p0", "p5"),
                                 ("p1", "p2")])
def test_trace_matches_jax(sequence, a, b):
    res = {pkg: sequence[pkg][0].engine.trace(a, b)
           for pkg in ("jax", "torch")}
    assert res["torch"] == res["jax"]
    assert res["torch"]["reachable"]


def test_link_row_readout_matches_jax(sequence):
    for key in (("default/p0", 1), ("default/p5", 12)):
        assert sequence["torch"][0].engine.link_row(*key) == \
            sequence["jax"][0].engine.link_row(*key)


def test_reconcile_results_match_jax():
    res = {}
    for pkg in ("jax", "torch"):
        s = Side(pkg)
        s.create(FABRIC)
        t = s.store.get("default", "p2")
        t.spec.links = swap_props(0)(t.spec.links[:2])
        s.store.update(t)
        r = s.rec.reconcile("default", "p2")
        res[pkg] = (r.action, r.added, r.deleted, r.updated, r.ok)
    assert res["torch"] == res["jax"] == ("changed", 0, 1, 2, True)


@pytest.mark.parametrize("ops", [
    [("pop",)] * 5,
    [("pop",), ("push", 3), ("pop",), ("pop_at", 2), ("pop",)],
    [("prepend", 20, 24), ("pop",), ("push", 1), ("pop_at", 0)],
])
def test_freelist_matches_jax(ops):
    fj, ft = jfree.FreeStack.from_range(0, 20), tfree.FreeStack.from_range(
        0, 20)
    for op in ops:
        outs = []
        for f in (fj, ft):
            if op[0] == "prepend":
                f.prepend_range(*op[1:])
                outs.append(None)
            else:
                outs.append(getattr(f, op[0])(*op[1:]))
        assert outs[0] == outs[1]
        assert len(fj) == len(ft)
        np.testing.assert_array_equal(fj.top_view(8), ft.top_view(8))


def test_store_watch_and_conflicts_match_jax():
    out = {}
    for pkg in ("jax", "torch"):
        _eng, st, _rec, ty = PKG[pkg]
        store = st.TopologyStore()
        w = store.watch()
        t = ty.Topology(name="a", spec=ty.TopologySpec(links=[]))
        store.create(t)
        stale = store.get("default", "a")
        fresh = store.get("default", "a")
        fresh.spec.links = links_of(ty, "a", [("b", 1, 0)])
        store.update(fresh)
        try:
            stale.spec.links = []
            store.update(stale)
            conflict = False
        except st.ConflictError:
            conflict = True
        store.delete("default", "a")
        out[pkg] = (conflict, [e.type for e in w.poll()])
    assert out["torch"] == out["jax"]
    assert out["torch"][0]


def test_warm_kernels_leaves_the_state_alone():
    """warm_kernels flushes, then runs one all-idle shaping step (K1 on
    the card, the plain step here) whose result it drops."""
    s = Side("torch")
    s.create(FABRIC)
    before = s.snapshot()
    s.engine.warm_kernels()
    assert_same(before, s.snapshot())


def test_props_gen_counts_every_props_change():
    """The plane's host props mirror is keyed on props_gen: a flush that
    applies an op, growth, compact() and a replaced state bump it; an
    idle flush does not."""
    s = Side("torch")
    s.create(FABRIC)
    e = s.engine
    e.flush()            # the adds of create()
    g = e.props_gen
    e.flush()
    assert e.props_gen == g
    s.edit("p0", swap_props(2))
    assert e.props_gen == g  # queued, not applied yet
    e.flush()
    assert e.props_gen == g + 1
    e.compact()
    assert e.props_gen == g + 2
    s.create(GROWTH)   # grows past 16
    e.flush()
    assert e.props_gen == g + 4
    g = e.props_gen
    e.state = e.state
    assert e.props_gen == g + 1
