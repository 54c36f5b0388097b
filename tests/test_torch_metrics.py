"""Port parity: kubedtn_tpu_torch.metrics (the daemon's Prometheus
exporter) against kubedtn_tpu.metrics, on the CPU.

Both packages' planes are driven with the same feed on deterministic
links (the plane tests' DET_PROPS, telemetry on, explicit clock), so
their engines and counters are equal; the two expositions are then the
same sorted lines — every series, label and value — except the samples
of the series that time the host (stage seconds, pause seconds and the
tick-latency histogram, plus the JAX package's jit-compile pause cause),
whose families must still be the same. Also here: the request
histogram's name and buckets, the node aggregates and the per-interface
series cap, deleted links left out of the totals, the dataplane, pause
and link-telemetry series, the HTTP server (404, concurrent scrapes, a
collector raising mid-scrape), make_registry refusing the collectors
that are not ported yet (migration, fleet) and accepting the SLO and
autopilot ones, and the shared-memory ingest series after the
same ring traffic (the tenant series are held in test_torch_tenancy.py).
"""

import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
from prometheus_client import generate_latest

import kubedtn_tpu.metrics.metrics as jm
import kubedtn_tpu_torch.metrics.metrics as tm
from kubedtn_tpu.twin.query import WhatIfStats as JWhatIfStats
from kubedtn_tpu.updates.stager import UpdateStats as JUpdateStats
from kubedtn_tpu_torch.twin.query import WhatIfStats as TWhatIfStats
from kubedtn_tpu_torch.updates.stager import UpdateStats as TUpdateStats

import test_torch_plane as tp

MET = {"jax": jm, "torch": tm}
# families whose samples time the host: compared by family, not value
TIMED = ("kubedtn_dataplane_stage_seconds", "kubedtn_pause_",
         "kubedtn_tick_latency_seconds")
FEED_TICKS, TICKS = 3, 6


def drive(pkg):
    sc = tp.build(pkg, tp.DET_PROPS, telemetry=True)
    rng = np.random.default_rng(5)
    for t in range(TICKS):
        if t < FEED_TICKS:
            for k, w in enumerate(sc.win):
                w.ingress.extend(tp.frames_for(k, t, tp.DET_COUNTS[k], rng))
        sc.plane.tick(now_s=(t + 1) * tp.DT)
    return sc


@pytest.fixture(scope="module")
def runs():
    """Both packages' clusters after the same feed (the JAX plane's
    first ticks compile, so once per module)."""
    return {pkg: drive(pkg) for pkg in ("jax", "torch")}


def exposition(pkg, sc, **kw) -> list[str]:
    reg, _hist = MET[pkg].make_registry(
        sc.engine, sim_counters_fn=sc.plane.counters_fn,
        dataplane=sc.plane, **kw)
    return sorted(generate_latest(reg).decode().splitlines())


def split_timed(lines):
    """(lines compared exactly, names of the timed families)."""
    exact, timed = [], set()
    for line in lines:
        body = line.split(" ", 3)[2] if line.startswith("#") else line
        if body.startswith(TIMED):
            timed.add(body.split("{")[0].split(" ")[0])
        else:
            exact.append(line)
    return exact, timed


def samples(lines, name) -> dict:
    """{labels: value} of one series in an exposition."""
    out = {}
    for line in lines:
        if line.startswith(name + "{") or line.startswith(name + " "):
            key, _, val = line.rpartition(" ")
            out[key[len(name):]] = float(val)
    return out


@pytest.mark.parametrize("max_interfaces,delete", [
    (10_000, False), (5, False), (10_000, True)])
def test_exposition_equals_jax(runs, max_interfaces, delete):
    if delete:
        # a deleted link leaves the totals; its counters stay in the
        # plane's columns until the row is reused
        for pkg, sc in runs.items():
            topo = sc.store.get("default", "a3")
            sc.engine.del_links(topo, topo.spec.links)
    got = {pkg: split_timed(exposition(pkg, sc,
                                       max_interfaces=max_interfaces))
           for pkg, sc in runs.items()}
    assert got["torch"][0] == got["jax"][0]
    # the timed families are the same (the port has no jit compiles)
    assert got["torch"][1] == got["jax"][1]
    lines = got["torch"][0]
    assert samples(lines, "interface_tx_packets")
    assert samples(lines, "kubedtn_link_tx")
    if delete:
        sc = runs["torch"]
        row = sc.engine.row_of("default/a3", 4)
        assert row is None
        c = sc.plane.counters
        active = np.fromiter(sc.engine._rows.values(), np.int64)
        assert samples(lines, "kubedtn_node_tx_packets_total")[""] == \
            float(c.tx_packets[active].sum()) < float(c.tx_packets.sum())


def test_series_cap_and_node_totals(runs):
    sc = runs["torch"]
    lines = exposition("torch", sc, max_interfaces=5)
    n = sc.engine.num_active
    assert len(samples(lines, "interface_tx_packets")) == 5
    assert samples(lines, "kubedtn_interface_series_truncated")[""] == \
        float(n - 5)
    c = sc.plane.counters
    active = np.fromiter(sc.engine._rows.values(), np.int64)
    for k in tm.InterfaceStatsCollector.COUNTER_KEYS:
        assert samples(lines, f"kubedtn_node_{k}_total")[""] == \
            float(getattr(c, k)[active].sum()), k
    full = exposition("torch", sc)
    tx = samples(full, "interface_tx_packets")
    assert len(tx) == n
    assert sum(tx.values()) == float(c.tx_packets[active].sum())
    assert samples(full, "kubedtn_interface_series_truncated")[""] == 0.0


def test_dataplane_pause_and_link_series(runs):
    sc = runs["torch"]
    p = sc.plane
    with p.pauses.pause("checkpoint_save", rows=64):
        pass
    lines = exposition("torch", sc)
    for name, want in (("ticks", p.ticks), ("shaped", p.shaped),
                       ("dropped", p.dropped), ("tick_errors", 0)):
        assert samples(lines, f"kubedtn_dataplane_{name}_total")[""] == \
            float(want), name
    assert samples(lines, "kubedtn_dataplane_pipeline_depth")[""] == 1.0
    assert samples(lines, "kubedtn_dataplane_heartbeat_age_seconds")[
        ""] == -1.0
    ev = samples(lines, "kubedtn_pause_events_total")
    assert ev['{cause="checkpoint_save"}'] == 1.0
    assert samples(lines, "kubedtn_pause_rows_total")[
        '{cause="checkpoint_save"}'] == 64.0
    assert samples(lines, "kubedtn_tick_latency_seconds_count")[
        '{cause="none"}'] == float(TICKS)
    rows, _secs, _trunc = p.telemetry.link_rows(sc.engine)
    tx = samples(lines, "kubedtn_link_tx")
    assert len(tx) == len(rows) > 0
    for r in rows:
        lab = (f'{{interface="uid{r["uid"]}",namespace="{r["namespace"]}",'
               f'pod="{r["pod"]}"}}')
        assert tx[lab] == r["tx"]
    assert samples(lines, "kubedtn_link_windows_closed_total")[""] == \
        float(p.telemetry.windows_closed)
    assert samples(lines, "kubedtn_flight_sampled_frames_total")[""] == \
        float(p.recorder.sampled)


def test_request_histogram_name_and_buckets():
    out = {}
    for pkg, m in MET.items():
        reg = m.CollectorRegistry()
        hist = m.LatencyHistograms(reg)
        for method, ms in (("add", 0.4), ("add", 3.0), ("update", 12.5),
                           ("del", 4999.0), ("setup", 7000.0),
                           ("remoteUpdate", 0.0)):
            hist.observe(method, ms)
        # every line but the _created samples (the series' wall-clock
        # creation time)
        out[pkg] = sorted(l for l in generate_latest(reg).decode()
                          .splitlines() if "_created" not in l)
    assert out["torch"] == out["jax"]
    assert tm.BUCKETS == jm.BUCKETS == (0, 1, 5, 10, 20, 50, 100, 200,
                                        500, 1000, 2000, 5000)
    assert tm.HTTP_ADDR_DEFAULT == 51112
    b = samples(out["torch"], "kubedtnd_request_duration_milliseconds_bucket")
    assert b['{le="5.0",method="add"}'] == 2.0
    assert b['{le="+Inf",method="setup"}'] == 1.0
    assert b['{le="5000.0",method="setup"}'] == 0.0


def test_whatif_and_update_series_equal_jax():
    sweep = types.SimpleNamespace(replicas=4, ticks=100, compile_s=0.5,
                                  run_s=1.25)
    ok = types.SimpleNamespace(ok=True, gate_s=2.5)
    bad = types.SimpleNamespace(ok=False, gate_s=1.0)
    staged = types.SimpleNamespace(rounds_applied=2, rolled_back=True,
                                   ok=False, stage_s=0.75)
    out = {}
    for pkg, (ws, us) in (("jax", (JWhatIfStats(), JUpdateStats())),
                          ("torch", (TWhatIfStats(), TUpdateStats()))):
        ws.record(sweep, 3)
        ws.record_error()
        us.record_plan(ok)
        us.record_plan(bad)
        us.record_plan_error()
        us.record_stage(staged)
        reg, _h = MET[pkg].make_registry(whatif_stats=ws, update_stats=us)
        out[pkg] = sorted(generate_latest(reg).decode().splitlines())
    assert out["torch"] == out["jax"]
    assert samples(out["torch"], "kubedtn_whatif_replica_steps_run_total")[
        ""] == 400.0
    assert samples(out["torch"], "kubedtn_update_rollbacks_total")[""] == \
        1.0


@pytest.mark.parametrize("arg,collector", [
    ("migration_stats", "MigrationStatsCollector"),
    ("fleet", "FleetStatsCollector")])
def test_make_registry_refuses_unported_collectors(arg, collector):
    with pytest.raises(ValueError, match=collector):
        tm.make_registry(**{arg: object()})


@pytest.mark.parametrize("arg,family", [
    ("slo", "kubedtn_slo_evaluations_total"),
    ("autopilot", "kubedtn_autopilot_searches_run_total")])
def test_make_registry_accepts_slo_and_autopilot(arg, family):
    """make_registry(slo=, autopilot=) registers the SLO and autopilot
    collectors (their series against JAX's are held in
    test_torch_slo.py and test_torch_autopilot.py)."""
    from prometheus_client import generate_latest

    from kubedtn_tpu_torch.autopilot import Autopilot
    from kubedtn_tpu_torch.slo import SloStats

    ev = types.SimpleNamespace(verdicts=dict, stats=SloStats())
    obj = ev if arg == "slo" else Autopilot(None, None, ev)
    reg, _h = tm.make_registry(**{arg: obj})
    text = generate_latest(reg).decode()
    assert f"{family} 0.0" in text


def _shm_feed(pkg, sc, tmp_path):
    """One package's ShmIngest over a ring fed 5 frames for no wire,
    then 300 for the cluster's first ingress wire; drained at 100 frames
    a wire, throttled once, drained again."""
    if pkg == "jax":
        from _torch_native_guard import ensure_jax_native

        ensure_jax_native()
        from kubedtn_tpu import shm
    else:
        from kubedtn_tpu_torch import shm
    d = tmp_path / pkg
    d.mkdir()
    sender = shm.ShmSender(str(d / "p.ring"), slots=1024, namespace="ns1")
    ingest = shm.ShmIngest(str(d))
    ingest.attach_ring(shm.ShmRing.attach(sender.ring.path))
    sender.send(0x5FFFFF, [b"nowhere"] * 5)
    sender.send(sc.win[0].wire_id, [bytes([i % 251]) * 80
                                    for i in range(300)])
    sc.daemon.shm = ingest
    sc.daemon.drain_ingress(max_per_wire=100)
    sc.daemon.drain_ingress(max_per_wire=100, admit=lambda w: 0)
    sc.daemon.drain_ingress(max_per_wire=100)
    return sender, ingest


def test_shm_exposition_equals_jax(tmp_path):
    """The kubedtn_shm_* series of the two packages' ingest planes after
    the same ring traffic and drains: the same sorted lines, and the
    values are ShmIngest.stats(); make_registry(shm=, tenancy=) installs
    the shm and tenant collectors."""
    from prometheus_client import CollectorRegistry

    from kubedtn_tpu_torch import native as tnative
    from kubedtn_tpu_torch.tenancy import TenantRegistry

    try:
        tnative._load()
    except tnative.NativeUnavailable as e:
        pytest.skip(f"the port's native library does not build here: {e}")
    out, keep = {}, {}
    for pkg in ("jax", "torch"):
        sc = tp.build(pkg, tp.DET_PROPS[:1])
        sender, ingest = _shm_feed(pkg, sc, tmp_path)
        reg = CollectorRegistry()
        reg.register(MET[pkg].ShmStatsCollector(ingest))
        out[pkg] = sorted(generate_latest(reg).decode().splitlines())
        keep[pkg] = (sc, sender, ingest)
    assert out["torch"] == out["jax"]
    sc, sender, ingest = keep["torch"]
    stats = ingest.stats()
    assert stats["frames_in"] == 200 and stats["unresolved_frames"] == 5
    assert stats["throttled_events"] == 1 and stats["pending"] == 105
    assert samples(out["torch"], "kubedtn_shm_frames_total")[""] == 200.0
    assert samples(out["torch"], "kubedtn_shm_pending_frames")[""] == 105.0
    reg, _h = tm.make_registry(shm=ingest,
                               tenancy=TenantRegistry(sc.engine))
    text = generate_latest(reg).decode()
    assert "kubedtn_shm_batches_total" in text
    assert "kubedtn_tenant_series_truncated 0.0" in text
    for _sc, s, i in keep.values():
        s.close()
        i.close()


class _Raises:
    def collect(self):
        raise RuntimeError("boom mid-scrape")


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_server_404_concurrent_scrapes_and_a_failing_collector(runs):
    sc = runs["torch"]
    reg, _hist = tm.make_registry(sc.engine,
                                  sim_counters_fn=sc.plane.counters_fn,
                                  dataplane=sc.plane)
    srv = tm.MetricsServer(reg, port=0, host="127.0.0.1")
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        assert _get(base + "/nope")[0] == 404
        status, body = _get(base + "/metrics")
        assert status == 200 and "interface_tx_packets" in body
        results = []

        def scrape():
            for _ in range(5):
                results.append(_get(base + "/metrics"))

        threads = [threading.Thread(target=scrape) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(results) == 40
        want = sorted(l for l in body.splitlines()
                      if l.startswith("interface_"))
        for st, b in results:
            assert st == 200
            assert sorted(l for l in b.splitlines()
                          if l.startswith("interface_")) == want
        bad = _Raises()
        reg.register(bad)
        status, body = _get(base + "/metrics")
        assert status == 500 and "scrape failed: RuntimeError" in body
        reg.unregister(bad)
        assert _get(base + "/")[0] == 200
    finally:
        srv.stop()
