"""The port's tenancy (kubedtn_tpu_torch.tenancy, the engine's tenant
hooks, the Tenant* RPCs, the tenant collector) against the JAX package's
on the same inputs, on the CPU.

Everything compared here is exact: token-bucket fills and verdicts on a
fixed clock, carved blocks and free lists, the registry's state after
every step of a random sequence of creates, allocations, frees,
compactions, growths, quota changes and deletes, the drain policy's
budgets and typed verdicts, the per-tenant counter and telemetry slices
of a plane on deterministic links (latency, TBF rate with queue
overflow, latency_corr without jitter: the two packages' draws differ,
so only links whose results no draw decides are compared), the Tenant*
RPC responses field by field, Health's tenant count and the
`kubedtn_tenant_*` exposition lines.

No test reads a wall clock: planes tick on an explicit clock.
"""

import dataclasses

import numpy as np
import pytest

import kubedtn_tpu.parallel.partition as jpart
import kubedtn_tpu.tenancy as jten
import kubedtn_tpu_torch.parallel.partition as tpart
import kubedtn_tpu_torch.tenancy as tten
from kubedtn_tpu.topology.freelist import FreeStack as JFree
from kubedtn_tpu_torch.topology.freelist import FreeStack as TFree

from _torch_tenant_harness import mods, run_schedule, tenant_plane

PKGS = ("jax", "torch")

# one tenant per kernel class, on links no draw decides (exact across
# the packages): slot-independent, TBF overflowing its 50 ms queue (the
# fallback re-shape), sequential with latency_corr and no jitter
DET_TENANT_PROPS = {
    "t0": dict(latency="10ms"),
    "t1": dict(rate="1Mbit"),
    "t2": dict(latency="5ms", latency_corr="30"),
}


# -- token buckets ------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_token_bucket_matches_jax_on_a_fixed_clock(seed):
    """A random sequence of ok / charge / reconfigure on a clock that
    also steps backwards: every verdict and every fill equal."""
    rng = np.random.default_rng(seed)
    rate = float(rng.choice([0.0, 10.0, 250.0, 1e4]))
    burst = float(rng.choice([0.0, 5.0, 800.0]))
    jb = jten.HostTokenBucket(rate, burst or None)
    tb = tten.HostTokenBucket(rate, burst or None)
    now = 0.0
    for _ in range(200):
        now = max(0.0, now + float(rng.normal(0.01, 0.02)))
        op = rng.integers(0, 3)
        if op == 0:
            assert tb.ok(now) == jb.ok(now)
        elif op == 1:
            n = float(rng.integers(0, 400))
            jb.charge(n, now)
            tb.charge(n, now)
        else:
            r = float(rng.choice([0.0, 50.0, 2e3]))
            jb.reconfigure(r)
            tb.reconfigure(r)
        assert (tb.fill, tb.burst, tb.rate_per_s) \
            == (jb.fill, jb.burst, jb.rate_per_s)


# -- tenant_blocks ------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_tenant_blocks_match_jax(seed):
    """Random free lists (holes, any order), shard counts and request
    sizes: the same blocks, and the same free stack after the carve, on
    FreeStack and on plain-list inputs."""
    rng = np.random.default_rng(seed)
    cap = int(rng.choice([64, 256, 1024]))
    S = int(rng.choice([1, 2, 4, 8]))
    rows = rng.permutation(cap)[:int(rng.integers(cap // 4, cap))]
    reqs = [int(x) for x in rng.integers(-1, cap // 3, 5)]
    j_free, t_free = JFree(rows.tolist()), TFree(rows.tolist())
    got = tpart.tenant_blocks(t_free, cap, S, reqs)
    assert got == jpart.tenant_blocks(j_free, cap, S, reqs)
    assert t_free.tolist() == j_free.tolist()
    j_list, t_list = rows.tolist(), rows.tolist()
    assert (tpart.tenant_block(t_list, cap, S, reqs[0])
            == jpart.tenant_block(j_list, cap, S, reqs[0]))
    assert t_list == j_list


def test_tenant_block_prefers_one_shard_block():
    """On a fresh free list a block that fits one shard block lies in
    one, and a second block is disjoint from the first."""
    free = TFree.from_range(0, 64)
    lo, hi = tpart.tenant_block(free, 64, 4, 10)   # shard blocks of 16
    assert hi - lo == 10 and lo // 16 == (hi - 1) // 16
    assert not any(lo <= r < hi for r in free)
    lo2, hi2 = tpart.tenant_block(free, 64, 4, 14)
    assert hi2 <= lo or lo2 >= hi
    assert lo2 // 16 == (hi2 - 1) // 16


# -- the registry under a random op sequence ----------------------------

def _registry_state(engine, reg, names):
    ts = {t.name: (t.qos, t.frame_budget_per_s, t.byte_budget_per_s,
                   sorted(t.namespaces), t.block, list(t.block_free),
                   t.block_rows) for t in reg.list()}
    return {
        "tenants": ts,
        "free": engine._free.tolist(),
        "reserved_free": reg.reserved_free(),
        "reserved_rows": sorted(reg.reserved_free_rows()),
        "rows_of": {n: reg.rows_of(n).tolist() for n in names},
        "block_owner": reg._block_owner.tolist(),
        "rows": dict(engine._rows),
        "capacity": int(engine._state.capacity),
        "config": reg.export_config(),
    }


class _Cluster:
    """One package's store + engine + registry, driven op by op."""

    def __init__(self, pkg, capacity):
        self.m = mods(pkg)
        self.store = self.m.st.TopologyStore()
        kw = {"device": "cpu"} if pkg == "torch" else {}
        self.engine = self.m.eng.SimEngine(self.store, capacity=capacity,
                                           **kw)
        self.reg = self.m.ten.TenantRegistry(self.engine)

    def add_pair(self, ns, i, uid):
        ty = self.m.ty
        a, b = f"p{i}a", f"p{i}b"
        for x, y in ((a, b), (b, a)):
            self.store.create(ty.Topology(
                name=x, namespace=ns, spec=ty.TopologySpec(links=[
                    ty.Link(local_intf="eth1", peer_intf="eth1",
                            peer_pod=y, uid=uid,
                            properties=ty.LinkProperties(
                                latency="1ms"))])))
        self.engine.setup_pod(a, ns)
        self.engine.setup_pod(b, ns)

    def destroy(self, ns, i):
        self.engine.destroy_pod(f"p{i}a", ns)


def _apply(cluster, op):
    kind, *args = op
    reg = cluster.reg
    try:
        if kind == "create":
            name, blk, nss, budget = args
            reg.create(name, block_edges=blk, namespaces=nss,
                       frame_budget_per_s=budget)
        elif kind == "add":
            cluster.add_pair(*args)
        elif kind == "destroy":
            cluster.destroy(*args)
        elif kind == "compact":
            cluster.engine.compact()
        elif kind == "quota":
            reg.set_quota(args[0], qos=args[1], frame_budget_per_s=args[2])
        elif kind == "bind":
            reg.bind_namespace(args[0], args[1])
        elif kind == "delete":
            return reg.delete(args[0])
    except (ValueError, KeyError) as e:
        return type(e).__name__
    return None


@pytest.mark.parametrize("seed", range(4))
def test_registry_random_ops_match_jax(seed):
    """Creates (with and without blocks), link-pair allocations in
    tenanted and untenanted namespaces, pod destroys, compactions,
    capacity growth, quota changes, namespace binds and deletes, drawn
    at random: after every step the two registries and engines hold the
    same blocks, block free lists, global free list, reserved-row count,
    rows_of per tenant, block-owner column and row bindings."""
    rng = np.random.default_rng(seed)
    cl = {p: _Cluster(p, capacity=16) for p in PKGS}
    names = ["ta", "tb", "tc"]
    spaces = ["ta", "tb", "tc", "nx", "ny"]
    alive: list[tuple[str, int]] = []
    n_pairs = 0
    for step in range(70):
        kind = rng.choice(["create", "add", "add", "add", "destroy",
                           "compact", "quota", "bind", "delete"])
        if kind == "create":
            op = ("create", str(rng.choice(names)),
                  int(rng.choice([0, 0, 4, 9, 16])),
                  [str(rng.choice(spaces))] if rng.random() < 0.5
                  else None,
                  float(rng.choice([0.0, 100.0])))
        elif kind == "add":
            ns = str(rng.choice(spaces))
            op = ("add", ns, n_pairs, n_pairs + 1)
            alive.append((ns, n_pairs))
            n_pairs += 1
        elif kind == "destroy":
            if not alive:
                continue
            op = ("destroy", *alive.pop(int(rng.integers(len(alive)))))
        elif kind == "quota":
            op = ("quota", str(rng.choice(names)),
                  str(rng.choice(["gold", "silver", "bronze"])),
                  float(rng.integers(0, 500)))
        elif kind == "bind":
            op = ("bind", str(rng.choice(spaces)), str(rng.choice(names)))
        elif kind == "delete":
            op = ("delete", str(rng.choice(names)))
        else:
            op = ("compact",)
        res = {p: _apply(cl[p], op) for p in PKGS}
        assert res["torch"] == res["jax"], (step, op)
        want = _registry_state(cl["jax"].engine, cl["jax"].reg, names)
        got = _registry_state(cl["torch"].engine, cl["torch"].reg, names)
        for k in want:
            assert got[k] == want[k], (step, op, k)
    assert n_pairs > 10
    assert cl["torch"].engine._state.capacity > 16   # grew at least once


# -- reconciler mapping, QoS weights, drain policy ----------------------

class _Wire:
    def __init__(self, pod_key, wire_id, queued):
        self.pod_key = pod_key
        self.wire_id = wire_id
        self.ingress = [b"x"] * queued


@pytest.mark.parametrize("seed", range(3))
def test_namespace_mapping_qos_and_drain_policy_match_jax(seed):
    """The reconciler registers one tenant per namespace; quotas and
    QoS classes set at random; the drain policy on a fixed clock gives
    the same per-wire budgets, and admission records the same typed
    verdicts and meters, in both packages."""
    rng = np.random.default_rng(seed)
    out = {}
    for p in PKGS:
        m = mods(p)
        store = m.st.TopologyStore()
        kw = {"device": "cpu"} if p == "torch" else {}
        engine = m.eng.SimEngine(store, capacity=16, **kw)
        reg = m.ten.TenantRegistry(engine)
        for ns in ("red", "green", "blue", ""):
            store.create(m.ty.Topology(name="pod", namespace=ns,
                                       spec=m.ty.TopologySpec()))
        m.rec.Reconciler(store, engine).drain()
        out[p] = reg
    assert (sorted(t.name for t in out["torch"].list())
            == sorted(t.name for t in out["jax"].list())
            == ["blue", "default", "green", "red"])
    for reg in out.values():
        rng = np.random.default_rng(seed)
        for name in ("red", "green", "blue"):
            reg.set_quota(name, qos=str(rng.choice(["gold", "silver",
                                                    "bronze"])),
                          frame_budget_per_s=float(rng.choice([0, 30, 90])),
                          byte_budget_per_s=float(rng.choice([0, 4000])))
    rng = np.random.default_rng(seed + 100)
    wires = [_Wire(f"{ns}/pod", i, int(rng.integers(0, 9)))
             for i, ns in enumerate(("red", "green", "blue", "default",
                                     "none"))]
    now = 10.0
    for _ in range(25):
        now += float(rng.choice([0.0, 0.01, 0.1]))
        base = int(rng.choice([4, 64, 4096]))
        budgets = {p: [reg.drain_policy(base, now)(w) for w in wires]
                   for p, reg in out.items()}
        assert budgets["torch"] == budgets["jax"]
        # what a drain took: up to 12 frames of 60-199 bytes per wire
        drained = [(w, 0, rng.integers(60, 200, min(b, 12)).tolist(), [])
                   for w, b in zip(wires, budgets["jax"]) if b > 0]
        for reg in out.values():
            reg.charge_drained(drained, now)
    for name in ("red", "green", "blue", "default"):
        jt, tt = out["jax"].get(name), out["torch"].get(name)
        assert (tt.admitted_frames, tt.admitted_bytes) \
            == (jt.admitted_frames, jt.admitted_bytes)
        assert (tt.bucket_frames.fill, tt.bucket_bytes.fill) \
            == (jt.bucket_frames.fill, jt.bucket_bytes.fill)
        assert (out["torch"].admission.stats_for(name)
                == out["jax"].admission.stats_for(name))
    verdicts = {p: [dataclasses.astuple(v)
                    for v in reg.admission.recent(1024)]
                for p, reg in out.items()}
    assert verdicts["torch"] == verdicts["jax"]
    assert {v[3] for v in verdicts["torch"]} <= {"frame-budget",
                                                 "byte-budget"}


# -- per-tenant slices of a plane on deterministic links ----------------

@pytest.fixture(scope="module")
def det_runs():
    """The three DET tenants cohabiting one plane at depth 1, in each
    package: (delivered, telemetry totals, counters, plane, registry)."""
    return {p: run_schedule(mods(p), sorted(DET_TENANT_PROPS),
                            DET_TENANT_PROPS, depth=1, ticks=20,
                            frames_per_tick={"t0": 4, "t1": 30, "t2": 6},
                            drain_ticks=80)
            for p in PKGS}


def test_tenant_counters_and_window_match_jax(det_runs):
    """Per-wire egress, tenant_counters and tenant_window of every
    tenant equal JAX's exactly; the tenants' counters partition the
    plane's."""
    j, t = det_runs["jax"], det_runs["torch"]
    assert t[0] == j[0]
    for ns in DET_TENANT_PROPS:
        assert t[2][ns] == j[2][ns], ns
        np.testing.assert_array_equal(t[1][ns], j[1][ns])
        assert t[4].tenant_window(t[3], ns) == j[4].tenant_window(j[3], ns)
        assert t[4].rows_of(ns).tolist() == j[4].rows_of(ns).tolist()
    c = t[3].counters
    for key, col in (("tx_packets", c.tx_packets),
                     ("delivered_packets", c.rx_packets),
                     ("dropped_queue", c.dropped_queue)):
        assert sum(t[2][ns][key] for ns in DET_TENANT_PROPS) \
            == float(col.sum()), key
    assert t[2]["t1"]["dropped_queue"] > 0   # the TBF queue overflowed


def test_tenant_exposition_matches_jax(det_runs):
    """The tenant collector's lines (the telemetry-derived ones too, on
    the explicit clock) equal JAX's; the cardinality guard alike."""
    from prometheus_client import CollectorRegistry, generate_latest

    from kubedtn_tpu.metrics.metrics import TenantStatsCollector as JC
    from kubedtn_tpu_torch.metrics.metrics import TenantStatsCollector as TC

    for cap in (256, 2):
        text = {}
        for p, cls in (("jax", JC), ("torch", TC)):
            _d, _tel, _c, plane, reg = det_runs[p]
            r = CollectorRegistry()
            r.register(cls(reg, plane, max_tenants=cap))
            text[p] = sorted(generate_latest(r).decode().splitlines())
        assert text["torch"] == text["jax"]
        assert any(line.startswith("kubedtn_tenant_delivered_packets_total")
                   for line in text["torch"])


def test_tenant_rpcs_and_health_match_jax(det_runs):
    """TenantCreate / List / Quota / Stats / Delete and Health's tenant
    count, field by field, on the two packages' planes; a daemon
    without a registry answers ok=False alike."""
    import kubedtn_tpu.wire.proto as jpb
    import kubedtn_tpu_torch.wire.proto as tpb

    calls = [
        ("TenantCreate", "TenantSpec", dict(
            name="newt", qos="silver", frame_budget_per_s=123.0,
            byte_budget_per_s=-1.0, block_edges=4, namespaces=["nw"])),
        ("TenantCreate", "TenantSpec", dict(name="bad", qos="platinum")),
        ("TenantList", "TenantQuery", {}),
        ("TenantList", "TenantQuery", dict(name="t1")),
        ("TenantQuota", "TenantSpec", dict(name="t0", qos="bronze",
                                           frame_budget_per_s=50.0,
                                           byte_budget_per_s=-1.0)),
        ("TenantQuota", "TenantSpec", dict(name="ghost")),
        ("TenantStats", "TenantQuery", dict(name="t1")),
        ("TenantStats", "TenantQuery", dict(name="t2")),
        ("TenantStats", "TenantQuery", dict(name="ghost")),
        ("TenantDelete", "TenantQuery", dict(name="newt")),
        ("TenantDelete", "TenantQuery", dict(name="newt")),
    ]
    for name, req, kw in calls:
        got = {}
        for p, pb in (("jax", jpb), ("torch", tpb)):
            daemon = det_runs[p][3].daemon
            got[p] = getattr(daemon, name)(getattr(pb, req)(**kw), None)
        assert str(got["torch"]) == str(got["jax"]), (name, kw)
    ht = det_runs["torch"][3].daemon.health_snapshot()
    hj = det_runs["jax"][3].daemon.health_snapshot()
    assert ht["tenants"] == hj["tenants"] == 3
    assert (det_runs["torch"][3].daemon.Health(tpb.HealthRequest(),
                                               None).tenants
            == det_runs["jax"][3].daemon.Health(jpb.HealthRequest(),
                                                None).tenants)
    bare = {}
    for p, pb in (("jax", jpb), ("torch", tpb)):
        m = mods(p)
        kw = {"device": "cpu"} if p == "torch" else {}
        daemon = m.srv.Daemon(m.eng.SimEngine(m.st.TopologyStore(),
                                              capacity=8, **kw))
        bare[p] = (str(daemon.TenantCreate(pb.TenantSpec(name="x"), None)),
                   daemon.health_snapshot()["tenants"])
    assert bare["torch"] == bare["jax"]
    assert "not enabled" in bare["torch"][0]


def test_block_steers_the_port_engine_like_jax():
    """A tenant with a block: its links pack inside the block, both
    directions of a link included; a freed row returns to the block
    and never to the global list — the same rows in both packages."""
    got = {}
    for p in PKGS:
        cl = _Cluster(p, capacity=64)
        t = cl.reg.create("acme", block_edges=8)
        cl.add_pair("acme", 0, 1)
        cl.add_pair("other", 1, 2)
        lo, hi = t.block
        rows = cl.reg.rows_of("acme")
        assert ((rows >= lo) & (rows < hi)).all() and rows.size == 2
        cl.destroy("acme", 0)
        got[p] = (t.block, list(t.block_free), cl.engine._free.tolist(),
                  dict(cl.engine._rows))
        assert rows[0] in t.block_free
    assert got["torch"] == got["jax"]


def test_tenant_plane_builds_on_the_port():
    """The harness plane of the port: three tenants, rows_of partitions
    the realized rows and equals a walk of the engine's rows."""
    plane, reg, _wires = tenant_plane(mods("torch"), sorted(DET_TENANT_PROPS),
                                      DET_TENANT_PROPS)
    eng = plane.engine
    walk = {}
    for (pod_key, _uid), row in eng._rows.items():
        walk.setdefault(pod_key.partition("/")[0], []).append(row)
    for ns in DET_TENANT_PROPS:
        assert reg.rows_of(ns).tolist() == sorted(walk[ns])
    assert sum(reg.rows_of(ns).size for ns in DET_TENANT_PROPS) \
        == eng.num_active
