"""The port's SLO autopilot (kubedtn_tpu_torch.autopilot, the Autopilot*
RPCs, the `kubedtn_autopilot_*` collector, scenarios.burn_recovery)
against the JAX package's, and its own contracts, on the CPU.

Against JAX, exactly: the candidate grid for the same seed, verdict and
edge properties (names, edits, order, with and without a parked
backlog, across widths); the search on equal tenant snapshots with the
sweep on JAX's own draws (`run_draws`, as tests/test_torch_twin.py
hands them over): the replica metrics, the ranked names, the projected
burns and the winner; burn_recovery's outcomes that no draw decides
(the two packages' loss draws differ, so the candidate it stages is
recorded, not compared); the poll records of the escalation tier and
of a disabled autopilot; AutopilotCtl / AutopilotStatus over real gRPC
servers, byte for byte; the `kubedtn_autopilot_*` exposition with its
series cap.

Within the port: the same seed stages the identical delta on two
independent planes; a gate-rejected actuation leaves the engine's SoA
columns and registries byte-identical; a dry run gates and stages
nothing.

No test reads a wall clock for a result: planes tick on an explicit
clock and the controllers' clocks are fixed.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import kubedtn_tpu.autopilot as jap
import kubedtn_tpu.slo as jslo
import kubedtn_tpu_torch.autopilot as tap
import kubedtn_tpu_torch.slo as tslo
from kubedtn_tpu import telemetry as jtele
from kubedtn_tpu.twin.query import build_cbr_spec as jbuild_cbr_spec
from kubedtn_tpu_torch import telemetry as ttele
from kubedtn_tpu_torch.autopilot.actuator import actuate
from kubedtn_tpu_torch.autopilot.candidates import candidate_grid
from kubedtn_tpu_torch.updates.gate import Guardrails

from _torch_native_guard import ensure_jax_native
from _torch_tenant_harness import mods, tenant_plane
from test_torch_sim import run_draws

AP = {"jax": jap, "torch": tap}
SLO = {"jax": jslo, "torch": tslo}
TELE = {"jax": jtele, "torch": ttele}
FRAME = b"\xab" * 200


def _props(pkg, **kw):
    return mods(pkg).ty.LinkProperties(**kw)


def _cand_key(c) -> tuple:
    """A candidate as plain values (the packages' classes differ)."""
    sc = c.scenario()
    return (c.name, c.kind,
            tuple((u, dataclasses.asdict(p)) for u, p in c.props_by_uid),
            c.fail_uids, c.factor, c.parked_mode, c.cost, sc.name,
            tuple((p.kind, p.uid, p.factor,
                   None if p.props is None else dataclasses.asdict(p.props))
                  for p in sc.perturbations))


# -- the candidate grid -------------------------------------------------

EDGE_PROPS = {
    "two": {1: dict(latency="2ms", loss="25"),
            2: dict(latency="4ms", loss="10", rate="10Mbit")},
    "one": {7: dict(latency="2ms", loss="25")},
    "rated": {3: dict(latency="1ms", rate="1Gbit", jitter="100us"),
              4: dict(latency="3ms", loss="1", loss_corr="25"),
              9: dict(rate="5Mbit")},
    "lossless": {5: dict(latency="10ms"), 6: dict(latency="10ms")},
}


@pytest.mark.parametrize("props", sorted(EDGE_PROPS))
@pytest.mark.parametrize("seed,width,backlog", [
    (0, 0, 0.0), (3, 4, 0.0), (7, 2, 7.0), (11, 15, 0.5), (5, 20, 0.0)])
def test_candidate_grid_equals_jax(props, seed, width, backlog):
    grids = {}
    for pkg in ("jax", "torch"):
        ep = {u: _props(pkg, **p) for u, p in EDGE_PROPS[props].items()}
        v = types.SimpleNamespace(throttle_backlog=backlog)
        grids[pkg] = [_cand_key(c) for c in AP[pkg].candidate_grid(
            v, ep, seed=seed, width=width)]
    assert grids["torch"] == grids["jax"]
    names = [k[0] for k in grids["torch"]]
    assert len(names) == len(set(names))
    assert ("drain:boost" in names) == (backlog > 0.0)


# -- the search on JAX's draws -------------------------------------------

SEARCH_PROPS = {"t0": dict(latency="2ms", loss="25"),
                "t1": dict(latency="1ms", rate="2Mbit")}
SEARCH_STEPS = 40
SEARCH_SEED = 4


def _row(tele, tx, delivered, hist):
    r = np.zeros(tele.KCOLS)
    r[tele.T_TX] = tx
    r[tele.T_DELIVERED] = delivered
    r[tele.T_HIST0:] = hist
    return r


def _paging_verdict(pkg, backlog: float):
    hist = np.zeros(ttele.N_BINS)
    hist[1] = 750.0
    row = _row(TELE[pkg], 1000.0, 750.0, hist)
    s = SLO[pkg]
    return s.evaluate_tenant("t0", "gold", s.SloSpec.for_qos("gold"),
                             row, 5.0, row, parked=backlog)


@pytest.fixture(scope="module")
def searched():
    """Both packages' tenant snapshots of t0 (two pairs at 25 % loss
    beside t1), their edge properties, grids and searches: JAX's sweep
    on its seed, the port's on JAX's draws of that seed."""
    out = {}
    for pkg in ("jax", "torch"):
        plane, reg, _w = tenant_plane(mods(pkg), sorted(SEARCH_PROPS),
                                      SEARCH_PROPS, telemetry=False)
        snap = reg.tenant_snapshot(plane.engine, "t0")
        ap = AP[pkg].Autopilot(reg, plane, None)
        out[pkg] = dict(plane=plane, snap=snap,
                        edge_props=ap._edge_props(snap, "t0"))
    spec_j = jbuild_cbr_spec(out["jax"]["snap"].sim.edges)
    E = out["jax"]["snap"].sim.edges.capacity
    draws = run_draws(SEARCH_SEED, SEARCH_STEPS, spec_j, 1000.0, 4, E)
    for backlog in (0.0, 3.0):
        for pkg in ("jax", "torch"):
            o = out[pkg]
            v = _paging_verdict(pkg, backlog)
            grid = AP[pkg].candidate_grid(v, o["edge_props"], seed=1,
                                          width=3)
            kw = {} if pkg == "jax" else {"draws": draws}
            o[backlog] = (grid, AP[pkg].score_candidates(
                o["snap"], "t0", "gold", v.spec, grid, verdict=v,
                steps=SEARCH_STEPS, seed=SEARCH_SEED, **kw))
    out["draws"] = draws
    yield out
    for pkg in ("jax", "torch"):
        out[pkg]["plane"].stop()


def test_search_inputs_equal_jax(searched):
    """The forks' edge properties are the same links, and the grids the
    same candidates."""
    ep = {p: {u: dataclasses.asdict(x) for u, x in
              searched[p]["edge_props"].items()} for p in ("jax", "torch")}
    assert ep["torch"] == ep["jax"] and len(ep["torch"]) == 2
    for backlog in (0.0, 3.0):
        assert [_cand_key(c) for c in searched["torch"][backlog][0]] == \
            [_cand_key(c) for c in searched["jax"][backlog][0]]


def test_search_replica_metrics_equal_jax(searched):
    """The replica metrics under the ranking, first: the baseline and
    every candidate's lane of one sweep, on JAX's draws, count for
    count and bucket for bucket."""
    import kubedtn_tpu.twin as jtw
    import kubedtn_tpu_torch.twin as ttw

    res = {}
    for pkg, tw in (("jax", jtw), ("torch", ttw)):
        grid = searched[pkg][3.0][0]
        scen = [tw.Scenario("baseline", ())] + [c.scenario() for c in grid]
        kw = {} if pkg == "jax" else {"draws": searched["draws"]}
        res[pkg] = tw.run_sweep(searched[pkg]["snap"], scen,
                                steps=SEARCH_STEPS, dt_us=1000.0,
                                k_slots=4, seed=SEARCH_SEED, **kw)
    assert res["torch"].names == res["jax"].names
    for name, mt, mj in zip(res["torch"].names, res["torch"].metrics,
                            res["jax"].metrics):
        for k in ("tx_packets", "delivered_packets", "dropped_loss",
                  "dropped_queue", "latency_hist"):
            assert mt[k] == mj[k], (name, k)
    assert res["torch"].metrics[0]["dropped_loss"] > 0


@pytest.mark.parametrize("backlog", [0.0, 3.0])
def test_score_candidates_equals_jax_on_its_draws(searched, backlog):
    """The ranked names, projected burns, ratios, p99s and parked
    charges, the baseline burn and the winner: equal. The grid is one
    sweep (baseline + one replica per candidate)."""
    st = searched["torch"][backlog][1]
    sj = searched["jax"][backlog][1]

    def ranked(sr):
        return [(s.candidate.name, s.projected_burn, s.delivery_ratio,
                 s.p99_us, s.parked) for s in sr.ranked]

    assert ranked(st) == ranked(sj)
    assert (st.baseline_burn, st.candidates, st.replicas, st.ticks,
            st.sim_seconds, st.seed) == (sj.baseline_burn, sj.candidates,
                                         sj.replicas, sj.ticks,
                                         sj.sim_seconds, sj.seed)
    assert st.winner is not None and st.winner.name == sj.winner.name
    assert st.replicas == st.candidates + 1
    assert st.ranked[0].projected_burn < st.baseline_burn


def test_score_candidates_repeats_on_one_seed(searched):
    """Within the port, the same snapshot, seed and verdict (its own
    Philox draws) give the same ranking, winner and burns, bit for
    bit."""
    o = searched["torch"]
    v = _paging_verdict("torch", 0.0)
    grid = o[0.0][0]
    a, b = (tap.score_candidates(o["snap"], "t0", "gold", v.spec, grid,
                                 verdict=v, steps=SEARCH_STEPS, seed=9)
            for _ in range(2))
    assert [(s.candidate.name, s.projected_burn) for s in a.ranked] == \
        [(s.candidate.name, s.projected_burn) for s in b.ranked]
    assert (a.winner and a.winner.name) == (b.winner and b.winner.name)


# -- burn_recovery in both packages ---------------------------------------

def test_burn_recovery_equals_jax_where_no_draw_decides():
    """The whole loop in both packages: the page fires, one search, a
    shape delta staged, the burn clears, no frame lost after the
    cutover, no tick error, in guardrails. The staged candidate (a draw
    decides it) is recorded, not compared."""
    import kubedtn_tpu.scenarios as jsc
    import kubedtn_tpu_torch.scenarios as tsc

    ensure_jax_native()
    kw = dict(pairs=1, feed_per_tick=30, width=2, steps=120, max_polls=50)
    r = {"jax": jsc.burn_recovery(**kw),
         "torch": tsc.burn_recovery(device="cpu", **kw)}
    keys = ("paged", "staged", "staged_kind", "post_frames_lost",
            "tick_errors", "in_guardrails", "searches_run",
            "candidates_evaluated", "warm_severity", "recovered_severity",
            "post_frames_fed")
    assert {k: r["torch"][k] for k in keys} == \
        {k: r["jax"][k] for k in keys}
    t = r["torch"]
    assert t["in_guardrails"] and t["paged"] and t["staged"]
    assert t["post_frames_lost"] == 0 and t["tick_errors"] == 0
    assert t["post_frames_delivered"] == t["post_frames_fed"] > 0
    assert t["staged_kind"] == "shape" and t["staged_candidate"]


# -- the controller against fixed verdict streams ----------------------------

class _FakeFleet:
    def __init__(self):
        self.calls = 0

    def rebalance(self):
        self.calls += 1
        return ["move-a", "move-b"]


class _FakeEvaluator:
    def __init__(self, names):
        self.names = names

    def verdicts(self):
        return {n: types.SimpleNamespace(severity="page", qos="gold",
                                         spec=None, throttle_backlog=0.0)
                for n in self.names}


def _escalation_script(pkg, dry: bool, enabled: bool = True):
    now = [100.0]
    fleet = _FakeFleet()
    ap = AP[pkg].Autopilot(
        None, None, _FakeEvaluator(["a", "b", "c"]), fleet=fleet,
        config=AP[pkg].AutopilotConfig(page_polls=99, cooldown_s=30.0,
                                       fleet_page_tenants=3),
        clock=lambda: now[0])
    if enabled:
        ap.enable()
    ap.set_dry_run(dry)
    polls = []
    for t in (100.0, 110.0, 140.0, 141.0):
        now[0] = t
        polls.append(ap.poll())
    return polls, fleet.calls, ap.status(), ap.history()


@pytest.mark.parametrize("dry,enabled", [(False, True), (True, True),
                                         (False, False)])
def test_escalation_and_disabled_polls_equal_jax(dry, enabled):
    """A fleet-wide burn: escalations rate-limited by the cooldown (two
    rebalances in four polls), none in dry run, nothing at all while
    disabled, where the pages are still counted. Every poll's records,
    the status and the history equal JAX's."""
    t = _escalation_script("torch", dry, enabled)
    assert t == _escalation_script("jax", dry, enabled)
    polls, calls, status, _h = t
    want = {(False, True): (["escalated"], 2),
            (True, True): (["dry-run"], 0), (False, False): ([], 0)}
    verdicts, n_calls = want[(dry, enabled)]
    assert [a["verdict"] for a in polls[0]] == verdicts
    assert polls[1] == [] and calls == n_calls
    assert status["stats"]["pages_seen"] == 12


# -- the wire surface and the collector ------------------------------------

def _seeded_autopilot(pkg):
    """An autopilot on a fixed clock with two tenants observed and one
    staged action in its history."""
    ap = AP[pkg].Autopilot(None, None, _FakeEvaluator(["a", "t0"]),
                           config=AP[pkg].AutopilotConfig(page_polls=99),
                           clock=lambda: 100.0)
    ap.enable()
    ap.poll()
    rec = ap._new_record("t0", None, 1.0)
    rec.update(kind="shape", candidate="shape:loss0", verdict="staged",
               staged=True, plans=2, projected_burn=0.25,
               baseline_burn=30.5, gate_s=1.5, run_s=0.75)
    ap._record("t0", rec, 1.0, hold=True)
    return ap


def _serve(pkg):
    m = mods(pkg)
    daemon = m.srv.Daemon(m.eng.SimEngine(
        m.st.TopologyStore(), capacity=16,
        **({"device": "cpu"} if pkg == "torch" else {})))
    server, port = m.srv.make_server(daemon, port=0, host="127.0.0.1",
                                     log_rpcs=False)
    server.start()
    return daemon, server, port


def _client(pkg, port):
    import importlib

    root = "kubedtn_tpu_torch" if pkg == "torch" else "kubedtn_tpu"
    client = importlib.import_module(f"{root}.wire.client")
    proto = importlib.import_module(f"{root}.wire.proto")
    return client.DaemonClient(f"127.0.0.1:{port}"), proto


CALLS = [
    ("AutopilotCtl", "AutopilotCtlRequest", dict(action="enable")),
    ("AutopilotCtl", "AutopilotCtlRequest", dict(action="dry-run-on")),
    ("AutopilotCtl", "AutopilotCtlRequest", dict(action="sideways")),
    ("AutopilotCtl", "AutopilotCtlRequest", dict(action="")),
    ("AutopilotStatus", "AutopilotStatusRequest", dict(history=10)),
    ("AutopilotStatus", "AutopilotStatusRequest",
     dict(tenant="t0", history=1)),
    ("AutopilotStatus", "AutopilotStatusRequest", dict(tenant="nope")),
    ("AutopilotCtl", "AutopilotCtlRequest", dict(action="dry-run-off")),
    ("AutopilotCtl", "AutopilotCtlRequest", dict(action="disable")),
    ("AutopilotStatus", "AutopilotStatusRequest", dict()),
]


def test_autopilot_rpcs_over_grpc_equal_jax():
    """Before an autopilot is attached, both refuse; then every
    AutopilotCtl action and AutopilotStatus query in turn answers the
    same bytes, and the status fields are status() / history()."""
    got = {}
    for pkg in ("jax", "torch"):
        daemon, server, port = _serve(pkg)
        c, pb = _client(pkg, port)
        try:
            answers = [c.AutopilotCtl(pb.AutopilotCtlRequest(
                action="enable")).SerializeToString(deterministic=True)]
            ap = _seeded_autopilot(pkg).attach(daemon)
            for method, req, kw in CALLS:
                answers.append(getattr(c, method)(getattr(pb, req)(**kw)))
            got[pkg] = (answers, ap.status(), ap.history())
        finally:
            c.close()
            server.stop(0)
    t, j = got["torch"], got["jax"]
    assert t[0][0] == j[0][0]
    for a, b in zip(t[0][1:], j[0][1:]):
        assert a.SerializeToString(deterministic=True) == \
            b.SerializeToString(deterministic=True)
    assert t[1:] == j[1:]
    full = t[0][5]
    hist = t[2]
    assert full.ok and len(full.actions) == len(hist) == 1
    assert full.actions[0].candidate == hist[0]["candidate"]
    assert [s.tenant for s in full.states] == sorted(t[1]["tenants"])
    assert not t[0][3].ok and "unknown action" in t[0][3].error


@pytest.mark.parametrize("cap", [256, 1, 0])
def test_autopilot_collector_exposition_equals_jax(cap):
    from prometheus_client import generate_latest

    import kubedtn_tpu.metrics.metrics as jm
    import kubedtn_tpu_torch.metrics.metrics as tm

    lines = {}
    for pkg, m in (("jax", jm), ("torch", tm)):
        reg, _h = m.make_registry(autopilot=_seeded_autopilot(pkg),
                                  max_tenants=cap)
        lines[pkg] = sorted(generate_latest(reg).decode().splitlines())
    assert lines["torch"] == lines["jax"]
    text = "\n".join(lines["torch"])
    assert f"kubedtn_autopilot_series_truncated {float(max(0, 2 - cap))}" \
        in text
    assert ('kubedtn_autopilot_state{tenant="a"}' in text) == (cap >= 1)
    assert ('kubedtn_autopilot_state{tenant="t0"}' in text) == (cap >= 2)
    assert "kubedtn_autopilot_pages_seen_total 2.0" in text


# -- the port's own contracts on a live plane --------------------------------

def _harness(prefix, pairs=1):
    """One live gold tenant on the explicit tick clock, as burn_recovery
    builds it, with a `ticks(n, feed)` driver and canonical-path loss
    injection."""
    from kubedtn_tpu_torch.scenarios import _tenant_plane_setup
    from kubedtn_tpu_torch.topology.reconciler import Reconciler

    daemon, _s, _p, plane, registry, wires = _tenant_plane_setup(
        {"t0": {"pairs": pairs, "qos": "gold"}}, "2ms", 1000.0, prefix,
        device="cpu")
    engine = plane.engine
    rec = Reconciler(engine.store, engine)
    win, wout = wires["t0"]
    clock = [100.0]

    def ticks(n, feed=0):
        for _ in range(n):
            for w in win:
                w.ingress.extend([FRAME] * feed)
            clock[0] += 0.05
            plane.tick(now_s=clock[0])
            for w in wout:
                w.egress.clear()

    def inject_loss(loss="25"):
        store = engine.store
        for topo in store.list("t0"):
            if "-a" not in topo.name:
                continue
            fresh = store.get(topo.namespace, topo.name)
            fresh.spec.links = [
                l.with_properties(dataclasses.replace(l.properties,
                                                      loss=loss))
                for l in fresh.spec.links]
            store.update(fresh)
        rec.drain()

    return types.SimpleNamespace(daemon=daemon, plane=plane,
                                 registry=registry, engine=engine,
                                 ticks=ticks, inject_loss=inject_loss)


def _page(h, ev):
    h.ticks(10, feed=40)
    ev.maybe_evaluate()
    h.inject_loss()
    for _ in range(40):
        h.ticks(5, feed=40)
        ev.maybe_evaluate()
        v = ev.verdicts().get("t0")
        if v is not None and v.severity == "page":
            return v
    raise AssertionError("tenant never paged")


def _engine_bits(engine):
    cols = {n: getattr(engine.state, n).cpu().numpy().copy()
            for n in ("uid", "src", "dst", "active", "props")}
    regs = (dict(engine._rows), dict(engine._peer),
            dict(engine._row_owner), set(engine._shaped_rows))
    return cols, regs


def _assert_bits_equal(a, b):
    for n in a[0]:
        np.testing.assert_array_equal(a[0][n], b[0][n],
                                      err_msg=f"column {n} moved")
    assert a[1] == b[1]


def _staged_record(seed, prefix):
    h = _harness(prefix)
    ev = tslo.SloEvaluator(h.registry, h.plane)
    ap = tap.Autopilot(h.registry, h.plane, ev,
                       config=tap.AutopilotConfig(
                           seed=seed, width=2, steps=80, page_polls=1,
                           cooldown_s=5.0, verify_polls=20),
                       tick_driver=lambda n: h.ticks(n))
    ap.enable()
    try:
        h.ticks(10, feed=40)
        ev.maybe_evaluate()
        h.inject_loss()
        staged = None
        for _ in range(50):
            h.ticks(5, feed=40)
            ev.maybe_evaluate()
            staged = next((a for a in ap.poll()
                           if a.get("verdict") == "staged"), staged)
            if staged:
                break
        assert staged is not None, ap.history()
        props = {uid: dataclasses.asdict(p) for uid, p in
                 ap._edge_props(h.registry.tenant_snapshot(h.plane, "t0"),
                                "t0").items()}
        return staged, ap.status(), props, _engine_bits(h.engine)
    finally:
        h.plane.stop()


def test_same_seed_stages_the_identical_delta():
    """Two independent planes, the same topology, fault and seed: the
    same candidate, the same properties afterwards, the same engine
    columns; one search, staged from a projected burn under the
    baseline."""
    r1, st1, p1, bits1 = _staged_record(7, "apdet")
    r2, _st2, p2, bits2 = _staged_record(7, "apdet")
    same = ("candidate", "kind", "candidates", "plans", "baseline_burn",
            "projected_burn", "staged")
    assert {k: r1[k] for k in same} == {k: r2[k] for k in same}
    assert p1 == p2
    _assert_bits_equal(bits1, bits2)
    assert st1["stats"]["searches_run"] == 1
    assert r1["plans"] > 0 and r1["staged"]
    assert r1["projected_burn"] < r1["baseline_burn"]
    assert st1["tenants"]["t0"]["state"] in ("verify", "hold")


@pytest.mark.parametrize("mode", ["rejected", "dry-run"])
def test_rejected_or_dry_run_actuation_leaves_the_plane(mode):
    """A shape candidate through guardrails that reject it, or in dry
    run: the engine's SoA columns and row / peer / owner / shaped
    registries are byte-identical afterwards and the paged loss is
    still there; the dry run's gate verdicts are recorded."""
    h = _harness(f"ap{mode[:3]}")
    ev = tslo.SloEvaluator(h.registry, h.plane)
    try:
        v = _page(h, ev)
        ap = tap.Autopilot(h.registry, h.plane, ev)
        snap = h.registry.tenant_snapshot(h.plane, "t0")
        cand = next(c for c in candidate_grid(
            v, ap._edge_props(snap, "t0"), seed=0, width=0)
            if c.kind == "shape")
        before = _engine_bits(h.engine)
        if mode == "rejected":
            out = actuate(h.plane, h.registry, "t0", cand, v,
                          guardrails=Guardrails(max_delivery_drop=-1.0,
                                                ticks=40, dt_us=1000.0),
                          tick_driver=lambda n: h.ticks(n))
            assert out.rejected and not out.staged and not out.ok
            assert "delivery" in out.reason
        else:
            out = actuate(h.plane, h.registry, "t0", cand, v,
                          overrides=(("ticks", 40),), dry_run=True,
                          tick_driver=lambda n: h.ticks(n))
            assert out.dry_run and not out.staged and out.ok
            assert out.plans and all(p.gate_ok for p in out.plans)
        _assert_bits_equal(before, _engine_bits(h.engine))
        after = h.registry.tenant_snapshot(h.plane, "t0")
        assert any("25" in (p.loss or "")
                   for p in ap._edge_props(after, "t0").values())
        assert torch.equal(after.sim.edges.props, snap.sim.edges.props)
    finally:
        h.plane.stop()


# -- entry.build_daemon ----------------------------------------------------

@pytest.mark.parametrize("autopilot", [False, True, "dry-run"])
def test_build_daemon_wires_slo_and_autopilot(autopilot):
    """build_daemon(slo=True) wires the SLO plane as cmd_daemon does with
    telemetry on: the plane's telemetry (1 s windows), an evaluator and
    an autopilot attached to the daemon, both sidecars running, the
    autopilot enabled only when asked (in dry run for "dry-run"); the
    exporter then carries both collectors."""
    import urllib.request

    from kubedtn_tpu_torch import entry

    d = entry.build_daemon("cpu", n_spine=2, n_leaf=3, links_per_pair=1,
                           capacity=64, tenancy=True, slo=True,
                           autopilot=autopilot)
    daemon, ev, ap, plane = d["daemon"], d["slo"], d["autopilot"], \
        d["plane"]
    srv = None
    try:
        assert daemon.slo is ev and daemon.autopilot is ap
        assert ev.plane is plane and ap.evaluator is ev
        assert plane.telemetry is not None
        assert plane.telemetry.window_s == 1.0
        assert ev._thread is not None and ap._thread is not None
        assert ap.enabled == bool(autopilot)
        assert ap.dry_run == (autopilot == "dry-run")
        srv = entry.serve_metrics(daemon, plane, port=0, host="127.0.0.1")
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv['port']}/metrics", timeout=30
        ).read().decode()
        assert 'kubedtn_slo_severity{tenant="default"}' in body
        assert f"kubedtn_autopilot_enabled {float(bool(autopilot))}" \
            in body
    finally:
        if srv is not None:
            srv["server"].stop()
        ap.stop()
        ev.stop()
        plane.stop()
    assert ev._thread is None and ap._thread is None


def test_build_daemon_refuses_slo_without_tenancy():
    from kubedtn_tpu_torch import entry

    for kw in ({"slo": True}, {"autopilot": True}):
        with pytest.raises(ValueError, match="tenancy"):
            entry.build_daemon("cpu", n_spine=2, n_leaf=3,
                               links_per_pair=1, capacity=64, **kw)
