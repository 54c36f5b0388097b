"""The port's SLO plane (kubedtn_tpu_torch.slo, ObserveSLO, the
`kubedtn_slo_*` collector) against the JAX package's, on the CPU.

Both packages run the same numpy float64 arithmetic on equal inputs, so
everything compared here is exact: tail fits, quantile estimates and
slower-than fractions on analytic, sampled and degenerate histograms;
burn rates on hand fixtures; the two-window severity rule; spec
validation (the same errors); verdict dicts; the fleet merge and the
frozen-window contributions; `Guardrails.from_slo` on a spec and on a
verdict (with a hypothesis property); the verdicts of a live evaluator
over tenant planes on deterministic links (latency-only, a TBF rate
overflowing its queue, latency_corr without jitter: the two packages'
draws differ, so only links whose results no draw decides are used),
with window rollovers and a throttled tenant's parked backlog; the
ObserveSLO responses over real gRPC servers, byte for byte; and the
`kubedtn_slo_*` exposition lines with the per-tenant series cap.

No test reads a wall clock: planes tick on an explicit clock.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import kubedtn_tpu.slo as jslo
import kubedtn_tpu.slo.tail as jtail
import kubedtn_tpu_torch.slo as tslo
import kubedtn_tpu_torch.slo.tail as ttail
from kubedtn_tpu import telemetry as jtele
from kubedtn_tpu.slo.fleet import contribution as jcontribution
from kubedtn_tpu.slo.fleet import from_frozen_window as jfrozen
from kubedtn_tpu.slo.spec import severity_of as jseverity
from kubedtn_tpu.updates.gate import Guardrails as JGuard
from kubedtn_tpu_torch import telemetry as ttele
from kubedtn_tpu_torch.slo.evaluator import _burns as tburns
from kubedtn_tpu_torch.slo.fleet import contribution as tcontribution
from kubedtn_tpu_torch.slo.fleet import from_frozen_window as tfrozen
from kubedtn_tpu_torch.slo.spec import severity_of as tseverity
from kubedtn_tpu_torch.updates.gate import Guardrails as TGuard
from kubedtn_tpu.slo.evaluator import _burns as jburns

from _torch_tenant_harness import mods, tenant_plane

PKG = {"jax": jslo, "torch": tslo}
N_BINS = ttele.N_BINS


def test_ladder_and_columns_match_jax():
    assert ttele.BUCKET_EDGES_US == jtele.BUCKET_EDGES_US
    assert (ttele.KCOLS, ttele.T_TX, ttele.T_DELIVERED, ttele.T_HIST0,
            ttele.N_BINS) == (jtele.KCOLS, jtele.T_TX, jtele.T_DELIVERED,
                              jtele.T_HIST0, jtele.N_BINS)


# -- the censored-tail fit ----------------------------------------------

def _analytic_hist(survival_fn, total=1_000_000.0):
    edges = np.asarray(ttele.BUCKET_EDGES_US)
    cum = (1.0 - np.asarray([survival_fn(e) for e in edges])) * total
    return np.concatenate([[cum[0]], np.diff(cum), [total - cum[-1]]])


def _sampled_hist(seed: int, mean: float, n: int = 50_000):
    lat = np.random.default_rng(seed).exponential(mean, size=n)
    edges = np.asarray(ttele.BUCKET_EDGES_US)
    b = np.minimum(np.searchsorted(edges, lat, side="left"), N_BINS - 1)
    return np.bincount(b, minlength=N_BINS).astype(float)


def _hists():
    out = {f"exp{int(m)}": _analytic_hist(lambda x, m=m: np.exp(-x / m))
           for m in (8e5, 1e6, 1.2e6, 1.6e6, 3e6)}
    out.update({f"sampled{s}": _sampled_hist(s, 9e5 + 2e5 * s)
                for s in range(4)})
    over = np.zeros(N_BINS)
    over[-1] = 1000.0
    inladder = np.zeros(N_BINS)
    inladder[1] = 100.0
    flat = np.zeros(N_BINS)
    flat[-4:] = 50.0
    rising = np.zeros(N_BINS)
    rising[-4:] = [1.0, 2.0, 4.0, 500.0]
    out.update(overflow=over, inladder=inladder, empty=np.zeros(N_BINS),
               flat_tail=flat, rising_tail=rising,
               random=np.random.default_rng(9).integers(0, 400, N_BINS)
               .astype(float))
    return out


HISTS = _hists()


@pytest.mark.parametrize("name", sorted(HISTS))
def test_tail_fit_and_estimates_equal_jax(name):
    """fit_tail, estimate_quantile at p50/p99/p99.9/p99.99 and
    fraction_slower_than at in-ladder and past-the-edge bounds: the
    same numbers and methods, exactly (the honest refusals included)."""
    h = HISTS[name]

    def fields(fit):   # the two packages' TailFit classes differ
        return None if fit is None else dataclasses.astuple(fit)

    for mp in (2, 3, 5):
        assert fields(ttail.fit_tail(h, min_points=mp)) == \
            fields(jtail.fit_tail(h, min_points=mp))
    for q in (0.5, 0.99, 0.999, 0.9999):
        assert ttail.estimate_quantile(h, q) == \
            jtail.estimate_quantile(h, q)
    for b in (500.0, 2e3, 7e3, 1e5, 2e6, 5e6, 8e6, 3e7):
        assert ttail.fraction_slower_than(h, b) == \
            jtail.fraction_slower_than(h, b)


def test_tail_methods_and_refusals():
    """The method tags and what each histogram gives: the fit past the
    edge, the clamp where it refuses, interpolation inside the ladder,
    None on no mass."""
    assert ttail.estimate_quantile(HISTS["exp1000000"], 0.999)[1] == \
        ttail.METHOD_TAIL_FIT
    assert ttail.estimate_quantile(HISTS["overflow"], 0.999) == \
        (ttele.BUCKET_EDGES_US[-1], ttail.METHOD_CENSORED)
    assert ttail.estimate_quantile(HISTS["inladder"], 0.5)[1] == \
        ttail.METHOD_INTERP
    assert ttail.estimate_quantile(HISTS["empty"], 0.99) == \
        (None, ttail.METHOD_EMPTY)
    # no survival point past any edge: nothing to fit
    assert ttail.fit_tail(HISTS["overflow"]) is None
    assert ttail.fit_tail(HISTS["empty"]) is None


# -- burn rates, severity, specs -----------------------------------------

def _row(tele, tx=0.0, delivered=0.0, hist=None, loss=0.0, queue=0.0):
    r = np.zeros(tele.KCOLS)
    r[tele.T_TX] = tx
    r[tele.T_DELIVERED] = delivered
    r[tele.T_DROP_LOSS] = loss
    r[tele.T_DROP_QUEUE] = queue
    if hist is not None:
        r[tele.T_HIST0:] = np.asarray(hist)
    return r


def _h(**bins):
    h = np.zeros(N_BINS)
    for k, v in bins.items():
        h[int(k[1:])] = v
    return h


# (spec kwargs, row kwargs, parked, hand-computed burn)
BURN_FIXTURES = [
    (dict(p999_bound_us=0.0), dict(tx=1000.0, delivered=980.0,
                                   hist=_h(b0=980.0), loss=20.0),
     0.0, 0.02 / 0.01),
    (dict(p999_bound_us=0.0), dict(tx=1000.0, delivered=1000.0,
                                   hist=_h(b1=950.0, b2=50.0)),
     0.0, 0.05 / 0.01),
    (dict(p999_bound_us=0.0), dict(tx=100.0, delivered=100.0),
     900.0, (900.0 / 1000.0) / 0.01),
    (dict(p999_bound_us=0.0), dict(tx=100.0, delivered=130.0), 0.0, 0.0),
    (dict(p999_bound_us=100_000.0),
     dict(tx=1000.0, delivered=1000.0, hist=_h(b1=998.0, b6=2.0)),
     0.0, 0.002 / 0.001),
    (dict(), dict(), 0.0, 0.0),
]


@pytest.mark.parametrize("i", range(len(BURN_FIXTURES)))
def test_burns_hand_fixtures_equal_jax(i):
    """_burns on hand fixtures: loss against the budget, the latency
    objective, parked backlog as unserved demand, early deliveries
    clamped to no error, the p99.9 objective, no traffic."""
    spec_kw, row_kw, parked, want = BURN_FIXTURES[i]
    kw = dict(delivery_ratio_floor=0.99, p99_bound_us=5_000.0, **spec_kw)
    got_t = tburns(tslo.SloSpec(**kw), _row(ttele, **row_kw), parked)
    got_j = jburns(jslo.SloSpec(**kw), _row(jtele, **row_kw), parked)
    assert got_t == got_j
    assert got_t == pytest.approx(want)


@pytest.mark.parametrize("fast,slow", [
    (0.5, 0.5), (10.0, 0.5), (2.0, 1.5), (5.0, 4.5), (4.0, 100.0),
    (1.0, 1.0), (3.999, 4.0), (0.0, 0.0)])
def test_two_window_severity_equals_jax(fast, slow):
    spec = dict(warn_burn=1.0, page_burn=4.0)
    assert tseverity(tslo.SloSpec(**spec), fast, slow) == \
        jseverity(jslo.SloSpec(**spec), fast, slow)


@pytest.mark.parametrize("kw", [
    dict(delivery_ratio_floor=1.5), dict(delivery_ratio_floor=0.0),
    dict(fast_windows=5, slow_windows=2), dict(fast_windows=0)])
def test_spec_validation_raises_the_same_errors(kw):
    with pytest.raises(ValueError) as et:
        tslo.SloSpec(**kw)
    with pytest.raises(ValueError) as ej:
        jslo.SloSpec(**kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("qos", ["gold", "silver", "bronze", "other"])
def test_qos_defaults_equal_jax(qos):
    t, j = tslo.SloSpec.for_qos(qos), jslo.SloSpec.for_qos(qos)
    assert t.to_dict() == j.to_dict()
    assert tslo.SloSpec.from_dict(t.to_dict()) == t
    assert tslo.SEVERITY_LEVELS == jslo.SEVERITY_LEVELS


@pytest.mark.parametrize("seed", range(6))
def test_verdict_to_dict_equals_jax(seed):
    """evaluate_tenant on random fast/slow rows (some past the ladder,
    some empty) under random specs: the verdict dicts are equal."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 300, N_BINS).astype(float)
    hist[-1] = float(rng.choice([0.0, 5.0, 400.0]))
    if seed == 5:
        hist[:] = 0.0
    delivered = hist.sum()
    tx = delivered + float(rng.integers(0, 50))
    fast_hist = hist * rng.uniform(0.0, 0.5)
    spec = dict(delivery_ratio_floor=float(rng.uniform(0.9, 0.999)),
                p99_bound_us=float(rng.choice([5e3, 2e4, 1e7])),
                p999_bound_us=float(rng.choice([0.0, 1e5])))
    parked = float(rng.choice([0.0, 12.5]))
    out = {}
    for name, tele, pkg in (("t", ttele, tslo), ("j", jtele, jslo)):
        out[name] = pkg.evaluate_tenant(
            "ten", "silver", pkg.SloSpec(**spec),
            _row(tele, tx=tx, delivered=delivered, hist=hist), 6.0,
            _row(tele, tx=tx / 3, delivered=fast_hist.sum(),
                 hist=fast_hist), parked=parked).to_dict()
    assert out["t"] == out["j"]


# -- the fleet merge ---------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_fleet_merge_equals_jax_and_the_pooled_verdict(seed):
    """Random per-plane splits: merge_tenant equals JAX's and the
    single-plane verdict over the pooled rows; merge_hists is the
    exact sum."""
    rng = np.random.default_rng(seed)
    spec = dict(delivery_ratio_floor=0.99, p99_bound_us=100_000.0)
    n = int(rng.integers(2, 5))
    hists = rng.integers(0, 500, size=(n, N_BINS)).astype(float)
    loss = rng.integers(0, 30, size=n).astype(float)
    delivered = hists.sum(axis=1)
    tx = delivered + loss
    pooled = _row(ttele, tx=tx.sum(), delivered=delivered.sum(),
                  hist=hists.sum(axis=0), loss=loss.sum())
    truth = tslo.evaluate_tenant("t", "gold", tslo.SloSpec(**spec),
                                 pooled, 10.0 * n, _row(ttele))
    merged = {}
    for name, pkg, contrib in (("t", tslo, tcontribution),
                               ("j", jslo, jcontribution)):
        cs = [contrib(f"p{i}", tx[i], delivered[i], hists[i], 10.0,
                      dropped_loss=loss[i], fast_burn=float(i))
              for i in range(n)]
        merged[name] = pkg.merge_tenant("t", cs,
                                        spec=pkg.SloSpec(**spec))
    assert merged["t"] == merged["j"]
    for k in ("delivery_ratio", "p99_us", "p999_us", "slow_burn"):
        assert merged["t"][k] == getattr(truth, k)
    assert merged["t"]["hist"] == [float(x) for x in hists.sum(axis=0)]
    assert np.array_equal(tslo.merge_hists(hists), hists.sum(axis=0))


def test_fleet_slo_and_frozen_windows_equal_jax():
    """fleet_slo over a live plane's verdicts and a migration record's
    frozen slice (continuity: the totals add), from_frozen_window on a
    full slice, on an empty one and on one without a histogram."""
    hist_a, hist_b = _h(b1=100.0), _h(b2=50.0)
    live = {"B": [{
        "tenant": "mig", "qos": "gold",
        "spec": tslo.SloSpec.for_qos("gold").to_dict(),
        "tx": 50.0, "delivered": 50.0, "window_seconds": 5.0,
        "hist": list(hist_b), "fast_burn": 0.25,
        "throttle_backlog": 0.0}],
        "C": [{"tenant": "other", "tx": 3.0, "delivered": 2.0,
               "hist": list(hist_a), "window_seconds": 1.0}]}
    win = {"tx": 100.0, "delivered": 99.0, "window_seconds": 10.0,
           "hist": list(hist_a), "dropped_loss": 1.0}
    frozen = [("A", "mig", win, "gold"), ("A", "gone", {}, "gold")]
    for tenant in ("", "mig", "nope"):
        assert tslo.fleet_slo(live, frozen, tenant=tenant) == \
            jslo.fleet_slo(live, frozen, tenant=tenant)
    v = tslo.fleet_slo(live, frozen)["mig"]
    assert (v["tx"], v["frozen_tx"], v["planes"], v["frozen_planes"]) \
        == (150.0, 100.0, ["B"], ["A"])
    for w in (win, {}, {"tx": 1.0}):
        assert tfrozen("A", w, qos="silver") == \
            jfrozen("A", w, qos="silver")


# -- Guardrails.from_slo -------------------------------------------------

def _guard_fields(g) -> dict:
    return dataclasses.asdict(g)


def test_guardrails_from_slo_equal_jax():
    """On a spec, on a verdict (the allowed drop scaled by the budget
    left) and with overrides: the same guardrails and the same checks."""
    for qos in ("gold", "silver", "bronze"):
        ts, js = tslo.SloSpec.for_qos(qos), jslo.SloSpec.for_qos(qos)
        assert _guard_fields(TGuard.from_slo(ts)) == \
            _guard_fields(JGuard.from_slo(js))
        assert _guard_fields(TGuard.from_slo(ts, ticks=100, seed=3)) == \
            _guard_fields(JGuard.from_slo(js, ticks=100, seed=3))
    hist = np.eye(N_BINS)[0] * 999.5
    vt = tslo.evaluate_tenant(
        "t", "gold", tslo.SloSpec.for_qos("gold"),
        _row(ttele, tx=1000.0, delivered=999.5, hist=hist), 10.0,
        _row(ttele))
    vj = jslo.evaluate_tenant(
        "t", "gold", jslo.SloSpec.for_qos("gold"),
        _row(jtele, tx=1000.0, delivered=999.5, hist=hist), 10.0,
        _row(jtele))
    gt, gj = TGuard.from_slo(vt), JGuard.from_slo(vj)
    assert _guard_fields(gt) == _guard_fields(gj)
    assert gt.max_delivery_drop == pytest.approx(
        0.001 * vt.budget_remaining)
    for args in ((1.0, 25_000.0, 1.0, 24_000.0),
                 (1.0, 15_000.0, 1.0, 14_000.0),
                 (0.99, 100.0, 1.0, 100.0)):
        assert gt.check(*args) == gj.check(*args)


@settings(max_examples=60, deadline=None)
@given(floor=st.floats(0.9, 0.9999), bound=st.floats(5_000.0, 1e6),
       remaining=st.one_of(st.none(), st.floats(-0.5, 1.5)),
       ticks=st.one_of(st.none(), st.integers(1, 1000)))
def test_guardrails_from_slo_property(floor, bound, remaining, ticks):
    """Property: for every spec (and a verdict-like object carrying a
    budget left, clamped to [0, 1]) the port's guardrails equal JAX's,
    accept a no-op plan, reject delivery through the floor and a p99
    past the bound."""
    import types

    t_spec = tslo.SloSpec(delivery_ratio_floor=floor, p99_bound_us=bound)
    j_spec = jslo.SloSpec(delivery_ratio_floor=floor, p99_bound_us=bound)
    over = {} if ticks is None else {"ticks": ticks}
    t_in, j_in = t_spec, j_spec
    if remaining is not None:
        t_in = types.SimpleNamespace(spec=t_spec, budget_remaining=remaining)
        j_in = types.SimpleNamespace(spec=j_spec, budget_remaining=remaining)
    g = TGuard.from_slo(t_in, **over)
    assert _guard_fields(g) == _guard_fields(JGuard.from_slo(j_in, **over))
    healthy = bound * 0.5
    assert g.check(1.0, healthy, 1.0, healthy)[0]
    if remaining is None:
        ok, why = g.check(floor - 1e-4, healthy, 1.0, healthy)
        assert not ok and "delivery" in why
    ok, why = g.check(1.0, bound * 1.01, 1.0, bound * 1.01)
    assert not ok and "SLO bound" in why


# -- the live evaluator on tenant planes --------------------------------

DET_PROPS = {
    "t0": dict(latency="10ms"),
    "t1": dict(rate="1Mbit"),
    "t2": dict(latency="5ms", latency_corr="30"),
}
NAMES = sorted(DET_PROPS)
TICK_S = 0.01
WINDOW_S = 0.05
BUDGET_FPS = 150.0      # t0's frame budget: 2 wires x 4 frames a tick
                        # offer 800 frames/s, so its backlog parks


def _live(pkg: str, telemetry: bool = True):
    """One package's three-tenant plane (t0 throttled) on an explicit
    clock, telemetry windows of WINDOW_S, with its evaluator attached."""
    plane, reg, wires = tenant_plane(
        mods(pkg), NAMES, DET_PROPS, telemetry=False,
        registry_kw={"t0": {"frame_budget_per_s": BUDGET_FPS}})
    if telemetry:
        plane.enable_telemetry(window_s=WINDOW_S, sample_period=4)
    return plane, reg, wires


def _feed(wires, k: int) -> None:
    for ns in NAMES:
        for i, w in enumerate(wires[ns][0]):
            w.ingress.extend(bytes([i, k % 256]) + b"\x5a" * (60 + 40 * i)
                             for _ in range(4))


def _drive(plane, wires, ticks: range) -> None:
    for k in ticks:
        if k < 60:
            _feed(wires, k)
        plane.tick(now_s=100.0 + (k + 1) * TICK_S)


@pytest.fixture(scope="module")
def live():
    """Both packages' planes and evaluators, driven in lockstep: the
    verdict payloads at five points (after 10, 25, 40, 60 fed ticks and
    30 idle ones), each after maybe_evaluate; then both left attached
    to their daemons for the RPC and collector tests."""
    out = {}
    for pkg in ("jax", "torch"):
        plane, reg, wires = _live(pkg)
        ev = PKG[pkg].SloEvaluator(reg, plane).attach(plane.daemon)
        seen = []
        k0 = 0
        for k1 in (10, 25, 40, 60, 90):
            _drive(plane, wires, range(k0, k1))
            k0 = k1
            fresh = ev.maybe_evaluate()
            seen.append((plane.telemetry.windows_closed,
                         None if fresh is None else
                         ev.verdict_payloads(), ev.stats.snapshot()))
        out[pkg] = dict(plane=plane, reg=reg, ev=ev, seen=seen)
    yield out
    for v in out.values():
        v["plane"].stop()


def test_live_verdicts_equal_jax(live):
    """Every payload, window count and evaluator counter equal; the
    windows rolled over, t0 parks a backlog its burn charges, and the
    unthrottled tenants meet their objectives."""
    assert live["torch"]["seen"] == live["jax"]["seen"]
    closed = [c for c, _v, _s in live["torch"]["seen"]]
    assert closed[0] >= 1 and closed[-1] > closed[0]
    final = {v["tenant"]: v for v in live["torch"]["seen"][3][1]}
    assert final["t0"]["throttle_backlog"] > 0.0
    assert final["t0"]["slow_burn"] > 1.0
    assert final["t2"]["attainment_ok"] and final["t2"]["severity"] == "ok"
    assert live["torch"]["ev"].stats.snapshot()["evaluations"] >= 4


def _serve(pkg, daemon):
    srv_mod = mods(pkg).srv
    server, port = srv_mod.make_server(daemon, port=0, host="127.0.0.1",
                                       log_rpcs=False)
    server.start()
    return server, port


def _client(pkg, port):
    import importlib

    root = "kubedtn_tpu_torch" if pkg == "torch" else "kubedtn_tpu"
    return importlib.import_module(f"{root}.wire.client").DaemonClient(
        f"127.0.0.1:{port}")


def _proto(pkg):
    import importlib

    root = "kubedtn_tpu_torch" if pkg == "torch" else "kubedtn_tpu"
    return importlib.import_module(f"{root}.wire.proto")


@pytest.mark.parametrize("tenant", ["", "t0", "t2", "nope"])
def test_observe_slo_over_grpc_equals_jax(live, tenant):
    """ObserveSLO through each package's server and client: the
    responses are the same bytes (every SloTenant field, the window
    count, the evaluation count)."""
    got = {}
    for pkg in ("jax", "torch"):
        server, port = _serve(pkg, live[pkg]["plane"].daemon)
        c = _client(pkg, port)
        try:
            got[pkg] = c.ObserveSLO(_proto(pkg).ObserveSLORequest(
                tenant=tenant), timeout=30.0)
        finally:
            c.close()
            server.stop(0)
    assert got["torch"].ok, got["torch"].error
    assert got["torch"].SerializeToString(deterministic=True) == \
        got["jax"].SerializeToString(deterministic=True)
    want = {"": NAMES, "nope": []}.get(tenant, [tenant])
    assert [r.tenant for r in got["torch"].tenants] == want


def test_observe_slo_lazy_evaluator_and_refusal_equal_jax():
    """A daemon with a registry and a telemetry plane but no evaluator
    gets one on first ObserveSLO (evaluator_for); with telemetry off it
    answers JAX's refusal. Both answers equal JAX's."""
    for telemetry in (True, False):
        got = {}
        for pkg in ("jax", "torch"):
            plane, _reg, wires = _live(pkg, telemetry=telemetry)
            try:
                _drive(plane, wires, range(12))
                daemon = plane.daemon
                assert daemon.slo is None
                got[pkg] = daemon.ObserveSLO(
                    _proto(pkg).ObserveSLORequest(), None)
                assert (daemon.slo is not None) == telemetry
            finally:
                plane.stop()
        assert got["torch"].ok == telemetry
        assert got["torch"].SerializeToString(deterministic=True) == \
            got["jax"].SerializeToString(deterministic=True)


def _exposition(pkg, ev, **kw) -> list:
    import importlib

    from prometheus_client import generate_latest

    root = "kubedtn_tpu_torch" if pkg == "torch" else "kubedtn_tpu"
    met = importlib.import_module(f"{root}.metrics.metrics")
    reg, _h = met.make_registry(slo=ev, **kw)
    return sorted(generate_latest(reg).decode().splitlines())


@pytest.mark.parametrize("cap", [256, 2, 1, 0])
def test_slo_collector_exposition_equals_jax(live, cap):
    """The kubedtn_slo_* lines equal JAX's, with the per-tenant series
    cap and its truncation gauge."""
    t = _exposition("torch", live["torch"]["ev"], max_tenants=cap)
    j = _exposition("jax", live["jax"]["ev"], max_tenants=cap)
    assert t == j
    assert f"kubedtn_slo_series_truncated {float(max(0, 3 - cap))}" in t
    kept = [n for n in NAMES[:cap]]
    for n in NAMES:
        line = f'kubedtn_slo_severity{{tenant="{n}"}}'
        assert any(x.startswith(line) for x in t) == (n in kept)


def test_evaluator_prunes_departed_tenants_like_jax():
    """A tenant deleted between passes leaves the verdicts (the tenant
    set changed, so maybe_evaluate runs without a rollover) and the
    throttle baselines, in both packages."""
    got = {}
    for pkg in ("jax", "torch"):
        plane, reg, wires = _live(pkg)
        try:
            ev = PKG[pkg].SloEvaluator(reg, plane)
            _drive(plane, wires, range(20))
            ev.maybe_evaluate()
            assert reg.delete("t1")
            fresh = ev.maybe_evaluate()
            got[pkg] = (sorted(fresh), sorted(ev._meter_base),
                        ev.verdict_payloads())
        finally:
            plane.stop()
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ["t0", "t2"]



# -- a fault of the JAX design, shared by the port (ROADMAP §3) ----------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("ahead", [True, False])
def test_start_after_an_explicit_clock_ahead_holds_windows_fault(pkg,
                                                                 ahead):
    """Both packages: WireDataPlane.start() rebases the plane's clock
    from an explicit-clock session onto the monotonic clock, but not the
    telemetry window clock. When the explicit clock ran AHEAD of the
    monotonic one, the real-time runner's ticks fall before the open
    window's start and no window closes (the evaluator's rollover
    trigger never fires) until the monotonic clock catches up; an
    explicit clock behind it rolls the window at once. Phase 17 of
    chip_smoke.py starts its explicit clock at the monotonic reading
    for this reason. Waits are bounded by runner ticks, not sleeps."""
    import time

    plane, _reg, wires = _live(pkg)
    try:
        t = time.monotonic() + (1000.0 if ahead else -10.0)
        for k in range(3):
            _feed(wires, k)
            plane.tick(now_s=t + k * TICK_S)
        tel = plane.telemetry
        w0, k0 = tel.windows_closed, plane.ticks
        plane.start()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and (
                plane.ticks < k0 + 50 if ahead
                else tel.windows_closed == w0):
            time.sleep(0.01)
        plane.stop()
        assert plane.ticks >= k0 + (50 if ahead else 1)
        assert (tel.windows_closed == w0) == ahead
    finally:
        plane.stop()
