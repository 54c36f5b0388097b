"""The port's tracer (kubedtn_tpu_torch/utils/tracing.py) against the JAX
package's: the same operations give the same spans (names, nesting,
metadata), the same aggregates (time fields excluded), the same catapult
events and the same rotate_out appends; and the port's reconciler,
checkpoint save / live save / load, what-if sweep and PauseLedger open
the same spans as the JAX package's for the same operations.
device_trace writes a torch.profiler trace (here its CPU half)."""

import json
import os

import numpy as np
import pytest

from kubedtn_tpu import checkpoint as jckpt
from kubedtn_tpu import pauses as jpauses
from kubedtn_tpu.utils import tracing as jtr
from kubedtn_tpu_torch import checkpoint as tckpt
from kubedtn_tpu_torch import pauses as tpauses
from kubedtn_tpu_torch.utils import tracing as ttr

from _torch_tenant_harness import mods, tenant_plane

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING4 = os.path.join(ROOT, "config", "samples", "ring4.yaml")


def drive(tr) -> None:
    """One fixed sequence of tracer operations."""
    with tr.span("outer", key="a/b"):
        with tr.span("inner", n=1):
            pass
        with tr.span("inner", n=2):
            with tr.span("leaf"):
                pass
    tr.add_span("pause:compact", 0.002, rows=7)

    @tr.traced("decorated")
    def f(x):
        """doc"""
        return x + 1

    assert f(1) == 2
    assert f.__doc__ == "doc" and f.__name__ == "f"

    @tr.traced()
    def g():
        return None

    g()


def shape(spans) -> list:
    """The spans without their times and thread ids."""
    return [(s.name, s.depth, s.meta) for s in spans]


def both(**kw):
    return jtr.Tracer(**kw), ttr.Tracer(**kw)


def test_spans_nesting_and_meta_equal_jax():
    j, t = both()
    drive(j)
    drive(t)
    assert shape(t.spans()) == shape(j.spans())
    # g's label is its qualname in both: the test module's function
    assert [s.name for s in t.spans()][-1].endswith("g")


def test_aggregates_equal_jax_without_times():
    j, t = both()
    drive(j)
    drive(t)
    sj, st = j.stats(), t.stats()
    assert sorted(st) == sorted(sj)
    for name in sj:
        assert st[name]["count"] == sj[name]["count"]
        assert sorted(st[name]) == sorted(sj[name])
    assert t.pending() == j.pending() == len(j.spans())


def test_disabled_tracer_records_nothing_like_jax():
    j, t = both(enabled=False)
    drive(j)
    drive(t)
    assert t.spans() == j.spans() == []


@pytest.mark.parametrize("cap", [1, 3, 5])
def test_bounded_buffer_drops_like_jax(cap):
    j, t = both(max_spans=cap)
    drive(j)
    drive(t)
    assert t.dropped_spans == j.dropped_spans
    assert shape(t.spans()) == shape(j.spans())


def _events_without_times(path: str) -> list:
    with open(path) as f:
        doc = json.load(f)
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
            for e in doc["traceEvents"]]


def test_catapult_export_equal_jax(tmp_path):
    j, t = both()
    drive(j)
    drive(t)
    j.export_chrome(str(tmp_path / "j.json"))
    t.export_chrome(str(tmp_path / "t.json"))
    ej = _events_without_times(str(tmp_path / "j.json"))
    et = _events_without_times(str(tmp_path / "t.json"))
    assert et == ej
    with open(tmp_path / "t.json") as f:
        ev = json.load(f)["traceEvents"]
    with open(tmp_path / "j.json") as f:
        evj = json.load(f)["traceEvents"]
    assert [sorted(e) for e in ev] == [sorted(e) for e in evj]
    assert {e["ph"] for e in ev} == {"X"}


def _rotated(path: str) -> list:
    """A rotate_out file: the array format, closing bracket optional."""
    with open(path) as f:
        text = f.read()
    events = json.loads(text + "\n]")
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
            for e in events]


def test_rotate_out_appends_like_jax(tmp_path):
    j, t = both()
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    counts = []
    for tr, p in ((j, pj), (t, pt)):
        open(p, "w").close()
        drive(tr)
        n1 = tr.rotate_out(p)
        n0 = tr.rotate_out(p)          # nothing buffered: nothing written
        with tr.span("after", k=1):
            pass
        n2 = tr.rotate_out(p)
        counts.append((n1, n0, n2, tr.pending()))
    assert counts[1] == counts[0]
    assert counts[1][1] == 0 and counts[1][3] == 0
    assert _rotated(pt) == _rotated(pj)
    with open(pt) as f:
        text = f.read()
    assert text.startswith("[\n") and text.count(",\n{") == counts[1][0] \
        + counts[1][2] - 1


@pytest.mark.parametrize("stage_s", [
    {}, {"drain": 0.0, "release": 0.0},
    {"drain": 0.25, "decide": 0.125, "kernel": 1.0, "release": 2.5},
    {"a": 1e-7, "b": 3.333333}])
def test_stage_shares_equal_jax(stage_s):
    assert ttr.stage_shares(stage_s) == jtr.stage_shares(stage_s)


def test_plane_stage_breakdown_uses_stage_shares():
    """The plane's stage_breakdown is stage_shares over its stage_s (the
    runtime's own copy is gone)."""
    from kubedtn_tpu_torch import runtime

    assert not hasattr(runtime, "_stage_shares")
    plane, _reg, _w = tenant_plane(mods("torch"), ["t"],
                                   {"t": {"latency": "1ms"}})
    plane.tick(now_s=1.0)
    bd = plane.stage_breakdown()
    want = ttr.stage_shares(plane.stage_s)
    assert bd["seconds"] == want["seconds"]
    assert bd["share"] == want["share"]


def test_module_level_helpers_use_the_default_tracer():
    tr = ttr.default_tracer()
    tr.reset()
    with ttr.span("mod-span", x=1):
        pass
    ttr.traced("mod-traced")(lambda: None)()
    got = [(s.name, s.meta) for s in tr.spans()]
    tr.reset()
    assert got == [("mod-span", {"x": 1}), ("mod-traced", {})]


# -- the spans of the port's call sites against JAX's ----------------------


def _site_spans(pkg: str, fn) -> list:
    """(name, sorted meta keys) of the spans `fn` opens on the package's
    default tracer, in order."""
    tr = (ttr if pkg == "torch" else jtr).default_tracer()
    tr.reset()
    fn()
    out = [(s.name, sorted(s.meta)) for s in tr.spans()]
    tr.reset()
    return out


def _ring4(pkg: str):
    root = "kubedtn_tpu_torch" if pkg == "torch" else "kubedtn_tpu"
    import importlib

    types_ = importlib.import_module(f"{root}.api.types")
    topo = importlib.import_module(f"{root}.topology")
    store = topo.TopologyStore()
    kw = {"device": "cpu"} if pkg == "torch" else {}
    engine = topo.SimEngine(store, **kw)
    topos = types_.load_yaml(RING4)
    for t in topos:
        store.create(t)
    for t in topos:
        engine.setup_pod(t.name, t.namespace)
    return store, engine, topo.Reconciler(store, engine)


def test_reconcile_spans_equal_jax():
    got = {}
    for pkg in ("jax", "torch"):
        _store, _engine, rec = _ring4(pkg)
        got[pkg] = _site_spans(pkg, rec.drain)
    assert got["torch"] == got["jax"]
    assert got["torch"] and {n for n, _ in got["torch"]} == {"reconcile"}
    assert got["torch"][0][1] == ["key"]


def test_checkpoint_save_and_load_spans_equal_jax(tmp_path):
    got = {}
    for pkg, ck in (("jax", jckpt), ("torch", tckpt)):
        store, engine, rec = _ring4(pkg)
        rec.drain()
        path = str(tmp_path / pkg)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        save = _site_spans(pkg, lambda: ck.save(path, store, engine))
        load = _site_spans(pkg, lambda: ck.load(path, **kw))
        got[pkg] = (save, load)
    assert got["torch"] == got["jax"]
    assert got["torch"] == ([("checkpoint-save", ["path"])],
                            [("checkpoint-load", ["path"])])


def test_plane_save_live_save_and_pause_spans_equal_jax(tmp_path):
    """On a plane: save_live's span with the checkpoint_save pause it
    records, save's with the pause of a stopped plane, in JAX's order."""
    got = {}
    for pkg, ck in (("jax", jckpt), ("torch", tckpt)):
        plane, _reg, wires = tenant_plane(mods(pkg), ["t"],
                                          {"t": {"latency": "1ms"}})
        engine = plane.daemon.engine
        wires["t"][0][0].ingress.append(b"x" * 64)
        plane.tick(now_s=1.0)
        live = _site_spans(pkg, lambda: ck.save_live(
            str(tmp_path / f"{pkg}-live"), engine.store, engine, plane))
        cold = _site_spans(pkg, lambda: ck.save(
            str(tmp_path / f"{pkg}-cold"), engine.store, engine,
            dataplane=plane))
        got[pkg] = (live, cold)
    assert got["torch"] == got["jax"]
    live, cold = got["torch"]
    assert ("checkpoint-save-live", ["path"]) in live
    assert ("checkpoint-save", ["path"]) in cold
    assert any(n == "pause:checkpoint_save" for n, _ in live + cold)


def test_whatif_sweep_span_equals_jax():
    got = {}
    for pkg in ("jax", "torch"):
        root = "kubedtn_tpu_torch" if pkg == "torch" else "kubedtn_tpu"
        import importlib

        pb = importlib.import_module(f"{root}.wire.proto")
        query = importlib.import_module(f"{root}.twin.query")
        server = importlib.import_module(f"{root}.wire.server")
        _store, engine, rec = _ring4(pkg)
        rec.drain()
        daemon = server.Daemon(engine)
        req = pb.WhatIfRequest(ticks=10, dt_us=1000.0,
                               include_baseline=True)
        sc = req.scenarios.add()
        sc.name = "fail11"
        p = sc.perturbations.add()
        p.kind, p.uid = "fail", 11
        resp = []
        got[pkg] = _site_spans(
            pkg, lambda: resp.append(query.serve_whatif(daemon, req)))
        assert resp[0].ok, resp[0].error
    assert got["torch"] == got["jax"]
    assert got["torch"] == [("whatif-sweep", ["scenarios"])]


@pytest.mark.parametrize("cause,detail", [
    ("compact", {"rows": 3}), ("staged_update", {"plan": 2, "rows": 8}),
    ("migration_fork", {"tenant": "t0", "bytes": 100})])
def test_pause_opens_its_span_like_jax(cause, detail):
    got = {}
    for pkg, mod in (("jax", jpauses), ("torch", tpauses)):
        ledger = mod.PauseLedger()

        def run():
            with ledger.pause(cause, **detail):
                pass
            ledger.record(cause, 0.001, **detail)

        got[pkg] = _site_spans(pkg, run)
    assert got["torch"] == got["jax"]
    assert got["torch"] == [(f"pause:{cause}", sorted(detail))] * 2


def test_pause_span_goes_to_a_given_tracer_like_jax():
    tj, tt = both()
    jpauses.PauseLedger(tracer=tj).record("gc", 0.001, generation=2)
    tpauses.PauseLedger(tracer=tt).record("gc", 0.001, generation=2)
    assert shape(tt.spans()) == shape(tj.spans()) \
        == [("pause:gc", 0, {"generation": 2})]


def test_disabled_ledger_opens_no_span():
    tr = ttr.Tracer()
    ledger = tpauses.PauseLedger(tracer=tr, enabled=False)
    with ledger.pause("compact", rows=1):
        pass
    assert tr.spans() == []


def test_device_trace_writes_a_profiler_trace(tmp_path):
    import torch

    d = str(tmp_path / "prof")
    with ttr.device_trace(d):
        x = torch.ones(64, 64)
        (x @ x).sum()
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(d, files[0])) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any("mm" in (n or "") for n in names)
    assert np.isfinite(len(doc["traceEvents"]))
