"""Port parity: the planned-update path (kubedtn_tpu_torch.updates, the
reconciler's planned branch, the plane's staging barrier) and the
daemon's WhatIf / PlanUpdate / ApplyPlan, against the JAX package on the
CPU.

- planner: the same rounds and the same static-check reports (or the
  same PlanError) for the same link sets;
- gate: the same verdicts, per-round ratios and p99s, the port's sweep
  fed the JAX gate's own draws (its seed, its horizon);
- stager: staged ≡ direct within the port at depth 1 and 2 (per-wire
  egress bytes, configuration columns, telemetry totals), and the staged
  configuration columns equal JAX's; rollback restores bit-exactly;
- the three RPCs answer like JAX's, through `make_server` over gRPC; a
  WhatIf is served while the plane keeps ticking with zero frame loss.

The cross-package comparisons of shaped traffic use deterministic links
(latency only, CBR offered load), where the two packages' different
random bits cannot show. No test reads a wall clock: planes tick on an
explicit clock, and every wait has a bound.
"""

import threading
import types

import numpy as np
import pytest

import kubedtn_tpu.api.types as jty
import kubedtn_tpu.runtime as jrt
import kubedtn_tpu.topology.engine as jeng
import kubedtn_tpu.topology.reconciler as jrec
import kubedtn_tpu.topology.store as jst
import kubedtn_tpu.twin.query as jq
import kubedtn_tpu.updates as jup
import kubedtn_tpu.wire.client as jcl
import kubedtn_tpu.wire.proto as jpb
import kubedtn_tpu.wire.server as jsrv
import kubedtn_tpu_torch.api.types as tty
import kubedtn_tpu_torch.runtime as trt
import kubedtn_tpu_torch.topology.engine as teng
import kubedtn_tpu_torch.topology.reconciler as trec
import kubedtn_tpu_torch.topology.store as tst
import kubedtn_tpu_torch.twin.query as tq
import kubedtn_tpu_torch.updates as tup
import kubedtn_tpu_torch.wire.client as tcl
import kubedtn_tpu_torch.wire.proto as tpb
import kubedtn_tpu_torch.wire.server as tsrv
from kubedtn_tpu.twin.snapshot import snapshot_from_engine as j_snap_engine
from kubedtn_tpu_torch import contracts
from kubedtn_tpu_torch.parallel.mesh import make_mesh
from kubedtn_tpu_torch.twin.snapshot import \
    snapshot_from_engine as t_snap_engine

from _torch_native_guard import assert_jax_wheel, ensure_jax_native
from test_torch_sim import run_draws

PKG = {"jax": types.SimpleNamespace(ty=jty, eng=jeng, st=jst, rec=jrec,
                                    srv=jsrv, rt=jrt, up=jup, pb=jpb,
                                    cl=jcl, q=jq),
       "torch": types.SimpleNamespace(ty=tty, eng=teng, st=tst, rec=trec,
                                      srv=tsrv, rt=trt, up=tup, pb=tpb,
                                      cl=tcl, q=tq)}

PROPS = dict(latency="3ms", jitter="1ms", loss="5")
NEW_PROPS = dict(latency="5ms", jitter="1ms", loss="2")
DET = dict(latency="2ms")
CFG_COLS = ("uid", "src", "dst", "active", "props")


def host(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def link(pkg, uid, peer="b0", intf="eth1", props=None):
    ty = PKG[pkg].ty
    return ty.Link(local_intf=intf, peer_intf=intf, peer_pod=peer, uid=uid,
                   properties=ty.LinkProperties(**(props or {})))


def pairs(pkg, n, props, capacity=None):
    """tests/test_pipeline_determinism.py's `_daemon_with_pairs` in
    `pkg`: pods a_i, b_i joined by link uid i+1, realized, with a wire
    on each end. Returns (daemon, engine, win, wout)."""
    m = PKG[pkg]
    store = m.st.TopologyStore()
    kw = {"device": "cpu"} if pkg == "torch" else {}
    engine = m.eng.SimEngine(store, capacity=capacity or 4 * n + 8, **kw)
    lp = m.ty.LinkProperties(**props)
    for i in range(n):
        for a, b in ((f"a{i}", f"b{i}"), (f"b{i}", f"a{i}")):
            store.create(m.ty.Topology(name=a, spec=m.ty.TopologySpec(
                links=[m.ty.Link(local_intf="eth1", peer_intf="eth1",
                                 peer_pod=b, uid=i + 1, properties=lp)])))
        engine.setup_pod(f"a{i}")
        engine.setup_pod(f"b{i}")
    m.rec.Reconciler(store, engine).drain()
    daemon = m.srv.Daemon(engine)
    win, wout = [], []
    for i in range(n):
        for pod, lst in ((f"a{i}", win), (f"b{i}", wout)):
            lst.append(daemon._add_wire(m.pb.WireDef(
                local_pod_name=pod, kube_ns="default", link_uid=i + 1,
                intf_name_in_pod="eth1")))
    return daemon, engine, win, wout


def plane_of(pkg, daemon, depth=1, telemetry=False):
    if pkg == "jax":
        ensure_jax_native()
    plane = PKG[pkg].rt.WireDataPlane(daemon, dt_us=2000.0,
                                      pipeline_depth=depth)
    if pkg == "jax":
        assert_jax_wheel(plane)
    plane.pipeline_explicit_clock = True
    if telemetry:
        plane.enable_telemetry(window_s=0.01, sample_period=4)
    return plane


def ticker(plane, t0=100.0, dt=0.002):
    t = [t0]

    def ticks(n):
        for _ in range(n):
            t[0] += dt
            plane.tick(now_s=t[0])

    ticks.t = t
    return ticks


def tagged(wire_i, n, size=64):
    return [bytes([wire_i]) + i.to_bytes(4, "big") + b"\x00" * (size - 5)
            for i in range(n)]


def cfg_cols(engine):
    st = engine.state
    return {n: host(getattr(st, n)).copy() for n in CFG_COLS}


# -- planner ------------------------------------------------------------

def plan_cases(pkg):
    L = lambda *a, **k: link(pkg, *a, **k)  # noqa: E731
    return {
        "make_before_break": ([L(1), L(2, props=dict(latency="1ms"))],
                              [L(2, props=dict(latency="9ms")), L(3)],
                              {}),
        "chunking": ([], [L(i, peer=f"b{i}") for i in range(5)],
                     dict(max_round_edits=2)),
        "empty": ([L(1), L(2)], [L(1), L(2)], {}),
        "changes_old": ([L(1, props=dict(latency="1ms"))],
                        [L(1, props=dict(latency="9ms"))], {}),
        "identity_move": ([L(1, intf="eth1")], [L(2, intf="eth2")], {}),
        "teardown": ([L(1), L(4, peer="b4")], [], {}),
        "mixed": ([L(i, peer=f"b{i % 3}", props=dict(latency=f"{i}ms"))
                   for i in range(1, 8)],
                  [L(i, peer=f"b{i % 3}", props=dict(latency=f"{i + 1}ms"))
                   for i in range(3, 11)], dict(max_round_edits=3)),
    }


def round_summary(plan):
    return [(r.index, [l.uid for l in r.adds], [l.uid for l in r.changes],
             [l.uid for l in r.dels], [l.uid for l in r.changes_old],
             [l.properties.latency for l in r.changes_old])
            for r in plan.rounds]


@pytest.mark.parametrize("case", sorted(plan_cases("jax")))
def test_plan_rounds_equal_jax(case):
    out = []
    for pkg in ("jax", "torch"):
        old, new, kw = plan_cases(pkg)[case]
        plan = PKG[pkg].up.plan_update(old, new, name="a", **kw)
        inv = [PKG[pkg].up.inverse_round(r) for r in plan.rounds]
        out.append((plan.summary(), plan.key, plan.n_edits,
                    round_summary(plan),
                    [([l.uid for l in r.adds], [l.uid for l in r.dels])
                     for r in inv]))
    assert out[1] == out[0]


def check_cases(pkg):
    up = PKG[pkg].up
    L = lambda *a, **k: link(pkg, *a, **k)  # noqa: E731
    old, new = [L(1, intf="eth1")], [L(2, intf="eth2")]
    swap = (up.UpdateRound(index=0, dels=tuple(old)),
            up.UpdateRound(index=1, adds=tuple(new)))
    base = up.plan_update(old, new, name="a")
    loop = up.plan_update([], [L(1, peer="v")], name="x", check=False)
    return {
        "delete_before_add": (base, dict(rounds=swap)),
        "fabric_detour": (base, dict(
            rounds=swap, fabric_edges=[("default/a", "default/b0")])),
        "mixed_state_loop": (loop, dict(fabric_edges=[
            ("default/x", "default/y", 10), ("default/y", "default/w", 5),
            ("default/w", "default/v", 6)])),
        "own_order": (base, {}),
        "disconnected_end": (up.plan_update([L(1)], [], name="a",
                                            check=False), {}),
    }


@pytest.mark.parametrize("case", sorted(check_cases("jax")))
def test_check_plan_equal_jax(case):
    out = []
    for pkg in ("jax", "torch"):
        plan, kw = check_cases(pkg)[case]
        try:
            out.append(("ok", PKG[pkg].up.check_plan(plan, **kw)))
        except PKG[pkg].up.PlanError as e:
            out.append(("PlanError", str(e)))
    assert out[1] == out[0]
    want = {"delete_before_add": "blackhole",
            "mixed_state_loop": "transient loop"}.get(case)
    if want:
        assert out[1][0] == "PlanError" and want in out[1][1]


# -- gate ---------------------------------------------------------------

GATE_CASES = {
    # name: (pair props, guardrail overrides, how the plan is built)
    "clean": (DET, dict(max_p99_factor=4.0), "latency3"),
    "regressing": (DET, {}, "loss80"),
    "delete": (DET, {}, "delete"),
    "adds_only": (DET, {}, "adds"),
    "cumulative": (DET, dict(max_p99_factor=4.0), "cumulative"),
    "lossy_local_row": (PROPS, dict(max_p99_factor=8.0), "peer_loss"),
}


def gate_run(pkg, case):
    props, over, how = GATE_CASES[case]
    m = PKG[pkg]
    _d, engine, _wi, _wo = pairs(pkg, 2 if how != "peer_loss" else 1,
                                 props)
    LP = m.ty.LinkProperties
    topo = engine.store.get("default", "a0")
    old = list(topo.status.links)
    if how == "peer_loss":
        peer = engine.store.get("default", "b0")
        assert engine.update_links(peer, [l.with_properties(LP(loss="50"))
                                          for l in peer.spec.links])
    if how in ("latency3", "peer_loss"):
        new = [l.with_properties(LP(latency="3ms")) for l in old]
    elif how == "loss80":
        new = [l.with_properties(LP(loss="80")) for l in old]
    elif how == "delete":
        new = []
    elif how == "adds":
        old, new = [], [link(pkg, 9, peer="b0")]
    else:  # cumulative: a benign change, then a killer delete
        old = old + list(engine.store.get("default", "a1").status.links)
        new = [old[0].with_properties(LP(latency="3ms"))]
    plan = m.up.plan_update(old, new, name="a0")
    with engine._lock:
        pod_ids = dict(engine._pod_ids)
    g = m.up.Guardrails(ticks=60, dt_us=1000.0, **over)
    if pkg == "jax":
        snap = j_snap_engine(engine)
        v = m.up.verify_plan(plan, snap, guardrails=g, pod_ids=pod_ids)
        return v, snap
    snap = t_snap_engine(engine)
    jspec = jq.build_cbr_spec(_jax_edges_of(snap))
    d = run_draws(g.seed, g.ticks, jspec, g.dt_us, g.k_slots,
                  snap.sim.edges.capacity)
    return m.up.verify_plan(plan, snap, guardrails=g, pod_ids=pod_ids,
                            draws=d), snap


def _jax_edges_of(snap_t):
    """The port snapshot's edge state as a JAX EdgeState (for the JAX
    gate's default offered load and its draws)."""
    from kubedtn_tpu.ops import edge_state as jes
    from kubedtn_tpu_torch import convert

    return jes.EdgeState(**{k: np.asarray(v) for k, v in
                            convert.edge_state_to_numpy(
                                snap_t.sim.edges).items()})


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_verdicts_equal_jax(case):
    vj, _ = gate_run("jax", case)
    vt, _ = gate_run("torch", case)
    assert (vt.ok, vt.reason, vt.skipped_adds, vt.skipped_edits,
            vt.replicas, vt.ticks) == (vj.ok, vj.reason, vj.skipped_adds,
                                       vj.skipped_edits, vj.replicas,
                                       vj.ticks)
    assert len(vt.rounds) == len(vj.rounds)
    for rj, rt_ in zip([vj.baseline, *vj.rounds], [vt.baseline,
                                                   *vt.rounds]):
        assert rj.keys() == rt_.keys()
        for k, w in rj.items():
            if isinstance(w, float):
                np.testing.assert_allclose(rt_[k], w, rtol=1e-6, err_msg=k)
            else:
                assert rt_[k] == w, k
    expect = {"clean": True, "regressing": False, "delete": False,
              "adds_only": True, "cumulative": False,
              "lossy_local_row": True}[case]
    assert vt.ok is expect
    if case == "cumulative":
        assert vt.rounds[0]["ok"] and not vt.rounds[-1]["ok"]
    if case == "lossy_local_row":
        # the peer row's loss still shapes in the round replica
        assert vt.baseline["delivery_ratio"] < 0.9


# -- stager: staged ≡ direct --------------------------------------------

def staged_or_direct(pkg, depth, staged, props=PROPS, new_props=NEW_PROPS,
                     mesh=None, observe_ticks=2, n_per_wire=120,
                     ticks_before=25, ticks_after=25):
    """tests/test_updates.py's schedule in `pkg`: the same delta applied
    staged (plan → rounds → barriers) or direct (one update_links).
    Returns (egress per wire, configuration columns, telemetry totals,
    plane)."""
    m = PKG[pkg]
    daemon, engine, win, wout = pairs(pkg, 2, props)
    plane = plane_of(pkg, daemon, depth, telemetry=True)
    if mesh is not None:
        plane.enable_sharding(mesh)
    ticks = ticker(plane)
    for k, wa in enumerate(win):
        wa.ingress.extend(tagged(k, n_per_wire))
    ticks(ticks_before)
    topo = engine.store.get("default", "a0")
    old = list(topo.status.links)
    new = [l.with_properties(m.ty.LinkProperties(**new_props)) for l in old]
    if staged:
        plan = m.up.plan_update(old, new, namespace="default", name="a0",
                                max_round_edits=1)
        res = plane.update_stager().stage(
            plan, topo, observe_ticks=observe_ticks, tick_driver=ticks,
            guardrails=m.up.Guardrails(max_p99_factor=8.0))
        assert res.ok, res
        assert res.rounds_applied == plan.n_rounds
    else:
        assert engine.update_links(topo, new)
        ticks(observe_ticks * len(old))
    for k, wa in enumerate(win):
        wa.ingress.extend(tagged(k, n_per_wire))
    ticks(ticks_after)
    plane.flush()
    plane.tick(now_s=ticks.t[0] + 10.0)
    assert plane.tick_errors == 0
    tel, _secs = plane.telemetry.window_sum()
    return [list(w.egress) for w in wout], cfg_cols(engine), tel, plane


@pytest.mark.parametrize("depth,shards", [(1, None), (2, None), (1, 2)],
                         ids=["d1", "d2", "virtual2-d1"])
def test_staged_end_state_byte_identical_to_direct(depth, shards):
    """The north star's staged ≡ direct: per-wire egress bytes, the
    configuration columns and the telemetry window totals, at depth 1
    and 2 and on two virtual shards."""
    mesh = None if shards is None else make_mesh(["cpu"] * shards)
    d_out, d_cols, d_tel, dp = staged_or_direct("torch", depth, False,
                                                mesh=mesh)
    s_out, s_cols, s_tel, sp = staged_or_direct("torch", depth, True,
                                                mesh=mesh)
    assert s_out == d_out
    assert (sp.shaped, sp.dropped) == (dp.shaped, dp.dropped)
    for name in d_cols:
        np.testing.assert_array_equal(s_cols[name], d_cols[name],
                                      err_msg=name)
    np.testing.assert_array_equal(s_tel, d_tel)
    assert sum(len(w) for w in d_out) > 0
    assert sp.pauses.causes()["staged_update"]["count"] == 1


@pytest.mark.parametrize("depth", [1, 2])
def test_staged_equals_jax_staged_on_deterministic_links(depth):
    """Staged on both packages, deterministic links: the same egress
    bytes, release order and configuration columns."""
    j_out, j_cols, _jt, jp = staged_or_direct(
        "jax", depth, True, props=DET, new_props=dict(latency="5ms"))
    t_out, t_cols, _tt, tp = staged_or_direct(
        "torch", depth, True, props=DET, new_props=dict(latency="5ms"))
    assert t_out == j_out
    assert (tp.shaped, tp.dropped) == (jp.shaped, jp.dropped)
    for name in j_cols:
        np.testing.assert_array_equal(t_cols[name], j_cols[name],
                                      err_msg=name)


# -- stager: rollback -------------------------------------------------------

def registry_state(engine):
    return (dict(engine._rows), dict(engine._peer), dict(engine._row_owner),
            set(engine._shaped_rows))


def fail_after(n):
    calls = [0]

    def health(_plane, _base):
        calls[0] += 1
        if calls[0] >= n:
            return False, "injected regression", {}
        return True, "", {}

    return health


def rollback_run(pkg, kind):
    m = PKG[pkg]
    daemon, engine, win, wout = pairs(pkg, 2, PROPS)
    plane = plane_of(pkg, daemon, telemetry=True)
    ticks = ticker(plane)
    for k, wa in enumerate(win):
        wa.ingress.extend(tagged(k, 80))
    ticks(25)
    topo = engine.store.get("default", "a0")
    old = list(topo.status.links)
    LP = m.ty.LinkProperties
    if kind == "changes":
        new = [l.with_properties(LP(**NEW_PROPS)) for l in old]
    else:
        new = ([old[0].with_properties(LP(**NEW_PROPS))]
               + [link(pkg, 9, peer="b0", intf="eth7",
                       props=dict(latency="1ms"))])
    plan = m.up.plan_update(old, new, name="a0", max_round_edits=1)
    pre, pre_reg = cfg_cols(engine), registry_state(engine)
    res = plane.update_stager().stage(
        plan, topo, observe_ticks=1, tick_driver=ticks,
        health_check=fail_after(1 if kind == "changes" else plan.n_rounds),
        guardrails=m.up.Guardrails())
    assert not res.ok and res.rolled_back and res.rounds_applied == 0
    post = cfg_cols(engine)
    assert registry_state(engine) == pre_reg
    assert engine.store.get("default", "a0").status.links == old
    return pre, post, res


@pytest.mark.parametrize("kind", ["changes", "add_del"])
def test_rollback_restores_config_like_jax(kind):
    """A regression mid-staging rolls the applied rounds back: uid,
    active and props bit-exact on every row, src/dst on every row active
    in either state, the host registries restored; the post-rollback
    columns equal JAX's."""
    pre, post, res = rollback_run("torch", kind)
    for name in ("uid", "active", "props"):
        np.testing.assert_array_equal(post[name], pre[name], err_msg=name)
    live = pre["active"] | post["active"]
    for name in ("src", "dst"):
        np.testing.assert_array_equal(post[name][live], pre[name][live])
    _jpre, jpost, jres = rollback_run("jax", kind)
    for name in CFG_COLS:
        np.testing.assert_array_equal(post[name], jpost[name],
                                      err_msg=name)
    assert res.reason == jres.reason


def test_rollback_then_traffic_matches_untouched_plane():
    def run(staged):
        m = PKG["torch"]
        daemon, engine, win, wout = pairs("torch", 2, PROPS)
        plane = plane_of("torch", daemon, telemetry=True)
        ticks = ticker(plane)
        for k, wa in enumerate(win):
            wa.ingress.extend(tagged(k, 60))
        ticks(20)
        if staged:
            topo = engine.store.get("default", "a0")
            old = list(topo.status.links)
            new = [l.with_properties(m.ty.LinkProperties(**NEW_PROPS))
                   for l in old]
            res = plane.update_stager().stage(
                m.up.plan_update(old, new, name="a0"), topo,
                observe_ticks=2, tick_driver=ticks,
                health_check=fail_after(1), guardrails=m.up.Guardrails())
            assert res.rolled_back
        else:
            ticks(2)
        for k, wa in enumerate(win):
            wa.ingress.extend(tagged(k, 60))
        ticks(25)
        plane.flush()
        plane.tick(now_s=1000.0)
        return [list(w.egress) for w in wout]

    assert run(True) == run(False)


@pytest.mark.parametrize("fault", ["engine_op", "tick_errors"])
def test_failures_roll_back_like_jax(fault):
    """A mid-round engine failure, or a tick_errors rise in the watch
    window, rolls the round back, with JAX's reason."""
    out = []
    for pkg in ("jax", "torch"):
        m = PKG[pkg]
        daemon, engine, _win, _wout = pairs(pkg, 2, PROPS)
        plane = plane_of(pkg, daemon, telemetry=True)
        ticks = ticker(plane)
        ticks(3)
        topo = engine.store.get("default", "a0")
        old = list(topo.status.links)
        plan = m.up.plan_update(old, [l.with_properties(
            m.ty.LinkProperties(**NEW_PROPS)) for l in old], name="a0")
        pre = cfg_cols(engine)["props"]
        if fault == "engine_op":
            real = engine.update_links
            engine.update_links = lambda *_a, **_k: False
            try:
                res = plane.update_stager().stage(
                    plan, topo, observe_ticks=0,
                    guardrails=m.up.Guardrails())
            finally:
                engine.update_links = real
        else:
            def failing(n):
                plane.tick_errors += 1
                ticks(n)

            res = plane.update_stager().stage(
                plan, topo, observe_ticks=1, tick_driver=failing,
                guardrails=m.up.Guardrails())
        assert not res.ok and res.rolled_back
        np.testing.assert_array_equal(cfg_cols(engine)["props"], pre)
        out.append(res.reason)
    assert out[1] == out[0]
    assert ("dispatch failure" if fault == "engine_op"
            else "tick_errors") in out[1]


def test_one_staging_at_a_time():
    daemon, engine, _win, _wout = pairs("torch", 2, PROPS)
    plane = plane_of("torch", daemon)
    topo = engine.store.get("default", "a0")
    old = list(topo.status.links)
    plan = tup.plan_update(old, [l.with_properties(
        tty.LinkProperties(**NEW_PROPS)) for l in old], name="a0")
    stager = plane.update_stager()
    assert plane.update_stager() is stager
    with stager._tick_lock:
        stager._staging_key = "default/other"
    try:
        with pytest.raises(tup.StagingBusyError, match="in progress"):
            stager.stage(plan, topo, observe_ticks=0)
    finally:
        with stager._tick_lock:
            stager._staging_key = None


def test_guarded_by_registry_covers_stager_and_plane():
    import kubedtn_tpu_torch.updates.stager  # noqa: F401

    reg = contracts.registry()
    stager = reg["kubedtn_tpu_torch.updates.stager.UpdateStager"]
    for attr in ("_journal", "_staging_key", "_staging_rolled"):
        assert stager[attr] == "_tick_lock"
    plane = reg["kubedtn_tpu_torch.runtime.WireDataPlane"]
    assert plane["_update_stager"] == "_tick_lock"


# -- the reconciler's planned branch ---------------------------------------

def planned_cluster(pkg):
    m = PKG[pkg]
    daemon, engine, _win, _wout = pairs(pkg, 2, DET)
    plane = plane_of(pkg, daemon)
    stats = m.up.UpdateStats()
    rec = m.rec.Reconciler(
        engine.store, engine, plane=plane, planned=True,
        guardrails=m.up.Guardrails(ticks=60, dt_us=1000.0,
                                   max_p99_factor=8.0),
        observe_ticks=0, update_stats=stats)
    return engine, plane, rec, stats


@pytest.mark.parametrize("delta,action", [
    (dict(latency="5ms"), "planned"), (dict(loss="80"), "plan-rejected")])
def test_planned_reconcile_like_jax(delta, action):
    """A clean delta routes through plan → gate → stage; a regressing
    one is rejected before it touches the live plane (props unchanged,
    status stale, no requeue). Both as in JAX; the regressing verdict
    holds whatever the draws (80 % loss)."""
    out = []
    for pkg in ("jax", "torch"):
        engine, _plane, rec, stats = planned_cluster(pkg)
        pre = cfg_cols(engine)
        topo = engine.store.get("default", "a0")
        old_status = list(topo.status.links)
        topo.spec.links = [l.with_properties(
            PKG[pkg].ty.LinkProperties(**delta)) for l in topo.spec.links]
        engine.store.update(topo)
        results = [r for r in rec.drain() if r.action != "noop"]
        fresh = engine.store.get("default", "a0")
        snap = stats.snapshot()
        out.append(([(r.action, r.ok, r.retryable) for r in results],
                    fresh.status.links == fresh.spec.links,
                    {k: v for k, v in snap.items() if not k.endswith(
                        "seconds")}, sorted(rec._requeue),
                    {k: v for k, v in cfg_cols(engine).items()}))
        if action == "plan-rejected":
            for k in CFG_COLS:
                np.testing.assert_array_equal(cfg_cols(engine)[k], pre[k])
            assert fresh.status.links == old_status
    (aj, sj, stj, qj, cj), (at, s_t, stt, qt, ct) = out
    assert (at, s_t, stt, qt) == (aj, sj, stj, qj)
    assert [a for a, _ok, _r in at] == [action]
    for k in CFG_COLS:
        np.testing.assert_array_equal(ct[k], cj[k], err_msg=k)


def test_direct_path_still_default():
    daemon, engine, _wi, _wo = pairs("torch", 1, PROPS)
    rec = trec.Reconciler(engine.store, engine)
    assert rec.planned is False
    topo = engine.store.get("default", "a0")
    topo.spec.links = [l.with_properties(tty.LinkProperties(**NEW_PROPS))
                       for l in topo.spec.links]
    engine.store.update(topo)
    assert [r.action for r in rec.drain() if r.action != "noop"] == [
        "changed"]


# -- the wire surface ---------------------------------------------------------

@pytest.fixture
def served():
    """A port Daemon and a JAX Daemon on the same deterministic pairs,
    each behind make_server on 127.0.0.1 with an explicit-clock plane,
    and a client of each."""
    nodes = {}
    for pkg in ("jax", "torch"):
        m = PKG[pkg]
        daemon, engine, win, wout = pairs(pkg, 2, DET)
        plane = plane_of(pkg, daemon)
        server, port = m.srv.make_server(daemon, port=0, host="127.0.0.1",
                                         log_rpcs=False)
        server.start()
        nodes[pkg] = types.SimpleNamespace(
            daemon=daemon, engine=engine, plane=plane, server=server,
            client=m.cl.DaemonClient(f"127.0.0.1:{port}"), win=win,
            wout=wout, m=m)
    yield nodes
    for n in nodes.values():
        n.client.close()
        n.plane.stop()
        n.server.stop(0)


def plan_request(node, name, props, **kw):
    pb, ty = node.m.pb, node.m.ty
    topo = node.engine.store.get("default", name)
    desired = [l.with_properties(ty.LinkProperties(**props))
               for l in topo.spec.links]
    return pb.PlanUpdateRequest(
        name=name, kube_ns="default",
        links=[pb.link_to_proto(l) for l in desired], ticks=60,
        max_p99_factor=8.0, **kw)


TIMING_FIELDS = ("gate_s", "stage_s", "compile_s", "run_s",
                 "replicas_steps_per_s")


def fields_of(msg):
    """A response's fields as plain values (nested messages as dicts, so
    the two packages' message classes compare), timings left out."""
    out = {}
    for f, v in msg.ListFields():
        if f.name in TIMING_FIELDS:
            continue
        if f.message_type is not None:
            v = ([fields_of(x) for x in v] if f.is_repeated
                 else fields_of(v))
        elif f.is_repeated:
            v = list(v)
        out[f.name] = v
    return out


def test_plan_then_apply_over_grpc_like_jax(served):
    out = {}
    for pkg, node in served.items():
        c, pb = node.client, node.m.pb
        resp = c.PlanUpdate(plan_request(node, "a0", dict(latency="5ms")),
                            timeout=120)
        assert resp.ok and resp.verified and resp.plan_id > 0, resp
        applied = c.ApplyPlan(pb.ApplyPlanRequest(plan_id=resp.plan_id),
                              timeout=120)
        again = c.ApplyPlan(pb.ApplyPlanRequest(plan_id=resp.plan_id),
                            timeout=60)
        fresh = node.engine.store.get("default", "a0")
        out[pkg] = (fields_of(resp) | {"plan_id": None},
                    fields_of(applied), fields_of(again),
                    fresh.spec.links[0].properties.latency,
                    fresh.status.links == fresh.spec.links,
                    cfg_cols(node.engine))
    j, t = out["jax"], out["torch"]
    assert t[:5] == j[:5]
    assert t[1]["rounds_applied"] == 1 and "unknown or expired" in t[2][
        "error"]
    for k in CFG_COLS:
        np.testing.assert_array_equal(t[5][k], j[5][k], err_msg=k)


@pytest.mark.parametrize("case", ["regressing", "conflict", "newer_spec",
                                  "unrealized", "empty", "unknown_id"])
def test_plan_and_apply_refusals_like_jax(served, case):
    out = {}
    for pkg, node in served.items():
        c, pb, ty, eng = node.client, node.m.pb, node.m.ty, node.engine
        if case == "unrealized":
            eng.store.create(ty.Topology(name="fresh", spec=ty.TopologySpec(
                links=[link(pkg, 1)])))
            r = c.PlanUpdate(pb.PlanUpdateRequest(
                name="fresh", kube_ns="default",
                links=[pb.link_to_proto(link(pkg, 1))]), timeout=60)
            out[pkg] = fields_of(r)
            continue
        if case == "empty":
            topo = eng.store.get("default", "a0")
            r = c.PlanUpdate(pb.PlanUpdateRequest(
                name="a0", kube_ns="default",
                links=[pb.link_to_proto(l) for l in topo.status.links]),
                timeout=60)
            out[pkg] = fields_of(r)
            continue
        if case == "unknown_id":
            out[pkg] = fields_of(c.ApplyPlan(pb.ApplyPlanRequest(
                plan_id=987654), timeout=60))
            continue
        props = dict(loss="80") if case == "regressing" else dict(
            latency="5ms")
        resp = c.PlanUpdate(plan_request(node, "a0", props), timeout=120)
        if case == "regressing":
            out[pkg] = fields_of(resp)
            continue
        topo = eng.store.get("default", "a0")
        if case == "conflict":
            topo.status.links = [l.with_properties(
                ty.LinkProperties(latency="7ms")) for l in topo.status.links]
            eng.store.update_status(topo)
        else:
            topo.spec.links = [l.with_properties(
                ty.LinkProperties(latency="8ms")) for l in topo.spec.links]
            eng.store.update(topo)
        applied = c.ApplyPlan(pb.ApplyPlanRequest(plan_id=resp.plan_id),
                              timeout=120)
        fresh = eng.store.get("default", "a0")
        out[pkg] = (fields_of(applied),
                    fresh.spec.links[0].properties.latency,
                    fresh.status.links[0].properties.latency)
    assert out["torch"] == out["jax"]


def test_whatif_over_grpc_like_jax(served):
    """The same WhatIf on both daemons (deterministic links, CBR load):
    the same ranked per-scenario metrics."""
    out = {}
    for pkg, node in served.items():
        pb, ty = node.m.pb, node.m.ty
        req = pb.WhatIfRequest(ticks=40, dt_us=1000.0, seed=5,
                               traffic_rate_bps=2e6, include_baseline=True)
        sc = req.scenarios.add()
        sc.name = "uid1-slow"
        p = sc.perturbations.add()
        p.kind = "degrade"
        p.uid = 1
        p.properties.CopyFrom(pb.props_to_proto(ty.LinkProperties(
            latency="30ms")))
        sc2 = req.scenarios.add()
        sc2.name = "b0-dead"
        p2 = sc2.perturbations.add()
        p2.kind = "blackhole"
        p2.node = "b0"
        sc3 = req.scenarios.add()
        sc3.name = "fail2"
        p3 = sc3.perturbations.add()
        p3.kind = "fail"
        p3.uid = 2
        resp = node.client.WhatIf(req, timeout=120)
        assert resp.ok, resp.error
        out[pkg] = fields_of(resp)
    assert out["torch"] == out["jax"]
    by = {m["name"]: m for m in out["torch"]["results"]}
    assert by["uid1-slow"]["p99_us"] > by["baseline"]["p99_us"]
    assert by["b0-dead"]["tx_packets"] < by["baseline"]["tx_packets"]


def test_whatif_refusals_like_jax():
    """The request budgets and a named tenant refuse as in JAX; with the
    single sweep slot held, an in-budget request is refused after a
    bounded wait."""
    out = []
    for pkg in ("jax", "torch"):
        m = PKG[pkg]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        daemon = m.srv.Daemon(m.eng.SimEngine(m.st.TopologyStore(),
                                              capacity=16, **kw))
        req = m.pb.WhatIfRequest(ticks=200_000, include_baseline=True)
        for i in range(64):
            req.scenarios.add().name = f"s{i}"
        r1 = m.q.serve_whatif(daemon, req)
        big = m.pb.WhatIfRequest(ticks=10, include_baseline=True)
        r2 = m.q.serve_whatif(daemon, m.pb.WhatIfRequest(
            ticks=10, k_slots=65))
        r3 = m.q.serve_whatif(daemon, m.pb.WhatIfRequest(
            ticks=10, tenant="t1"))
        slots = m.q._sweep_slots(daemon)
        assert slots.acquire(blocking=False)
        old = m.q.SWEEP_WAIT_S
        m.q.SWEEP_WAIT_S = 0.05
        try:
            r4 = m.q.serve_whatif(daemon, big)
        finally:
            m.q.SWEEP_WAIT_S = old
            slots.release()
        out.append(([(r.ok, r.error) for r in (r1, r2, r3, r4)],
                    m.q.stats_for(daemon).snapshot()["errors"]))
    assert out[1] == out[0]
    assert "budget" in out[1][0][0][1] and "in progress" in out[1][0][3][1]
    assert out[1][1] == 4


def test_whatif_served_while_the_plane_ticks_loses_no_frame(served):
    """A WhatIf served from another thread while this one keeps ticking
    the plane (explicit clock): the snapshot barrier takes the tick lock
    between two ticks, and every frame fed before, during and after the
    sweep is delivered."""
    node = served["torch"]
    plane, pb = node.plane, node.m.pb
    ticks = ticker(plane, dt=0.002)
    fed = delivered = 0

    def feed_and_drain():
        nonlocal fed, delivered
        for k, w in enumerate(node.win):
            w.ingress.extend(tagged(k, 20))
            fed += 20
        ticks(1)
        for w in node.wout:
            while w.egress:
                w.egress.popleft()
                delivered += 1

    for _ in range(5):
        feed_and_drain()
    assert delivered > 0
    box = {}

    def ask():
        req = pb.WhatIfRequest(ticks=30, dt_us=1000.0,
                               include_baseline=True)
        sc = req.scenarios.add()
        sc.name = "fail1"
        p = sc.perturbations.add()
        p.kind = "fail"
        p.uid = 1
        box["resp"] = node.client.WhatIf(req, timeout=120)

    th = threading.Thread(target=ask)
    th.start()
    for _ in range(20_000):  # bounded: the sweep ends long before
        if not th.is_alive():
            break
        feed_and_drain()
    th.join(timeout=120)
    assert not th.is_alive()
    assert box["resp"].ok, box["resp"].error
    assert [m.name for m in box["resp"].results] == ["baseline", "fail1"]
    for _ in range(5):
        feed_and_drain()
    for _ in range(40):  # drain ticks: 2 ms latency < 80 ms
        ticks(1)
        for w in node.wout:
            while w.egress:
                w.egress.popleft()
                delivered += 1
    assert delivered == fed
    assert plane.tick_errors == 0 and plane.dropped == 0
    assert tq.stats_for(node.daemon).sweeps == 1
