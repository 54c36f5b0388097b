"""The fleet supervisor in the port (kubedtn_tpu_torch.federation's
placement and supervisor modules and their surfaces), held against the
JAX package on the same inputs.

Mirrors tests/test_fleet.py case by case, each run in both packages and
compared: the placement ledger's journal record byte for byte in both
directions, with its crash discipline and `.prev` recovery; the
placement scores, choices and rebalance plans on seeded random health
and placement maps (exactly); the suspicion machine's state sequence
under scripted probe outcomes (`ChaosInjector.fail_probes`, degraded
answers, hysteresis); the checkpoint surfaces an evacuation restores
from (a live save against a stopped one, the running-plane refusal, the
autosave loop, queued ingress across a restart); Local.Health along the
degradation ladder and grpc.health.v1; `fork_from_checkpoint` of either
package's checkpoint; the evacuations (after a kill, with pending and ingress
frames, retried until a survivor is healthy, without a checkpoint,
after a post-cutover death of the destination, orphan resume, a
rolled-back record refused); Health by plane name; FleetStatus and
FleetUpgrade over gRPC; the `kubedtn_fleet_*` exposition; the
autopilot's escalation into a real `rebalance`; ObserveSLO's fleet
branch; `entry.build_fleet`'s wiring; and the two scenarios,
`plane_failover` and `fleet_rolling_upgrade`, at CPU size.

The policy's own fault is pinned in both packages: a tenant holding
more than `min_gain` of a plane's capacity moves back and forth between
two planes as the healths are probed again
(`test_rebalance_oscillates_for_a_large_tenant_fault`).
"""

import os
import shutil

import numpy as np
import pytest
from prometheus_client import generate_latest

import _torch_fleet_harness as H
import kubedtn_tpu.wire.proto as jpb
import kubedtn_tpu_torch.wire.proto as tpb

pytestmark = pytest.mark.fleet

M = {"torch": H.fmods("torch"), "jax": H.fmods("jax")}
PB = {"torch": tpb, "jax": jpb}


def both(fn, *a, **kw) -> dict:
    """fn(m, *a, **kw) for each package: {"torch": ..., "jax": ...}."""
    return {pkg: fn(M[pkg], *a, **kw) for pkg in ("torch", "jax")}


def same(out: dict):
    assert out["torch"] == out["jax"]
    return out["torch"]


def _load(m, path: str):
    """checkpoint.load of either package, the port's on the CPU."""
    return m.ckpt.load(path, **({"device": "cpu"} if m.pkg == "torch"
                                else {}))


def _tmp(tmp_path, pkg: str) -> str:
    d = tmp_path / pkg
    d.mkdir(exist_ok=True)
    return str(d)


def _states(sup) -> list:
    return [(p["name"], p["state"], p["consecutive_failures"],
             p["last_error"]) for p in sup.status()["planes"]]


# -- the placement ledger ------------------------------------------------

LEDGER_OPS = ("assign", "assign", "assign", "remove", "cordon",
              "uncordon")


def _ledger_script(m, root: str, seed: int) -> list:
    """A seeded random op sequence on a fresh ledger; the committed
    manifest's bytes after every op."""
    rng = np.random.default_rng(seed)
    led = m.place.PlacementLedger(root)
    out = []
    for _ in range(12):
        op = LEDGER_OPS[int(rng.integers(len(LEDGER_OPS)))]
        t = f"t{int(rng.integers(5))}"
        p = "ABC"[int(rng.integers(3))]
        if op == "assign":
            qos = [None, "gold", "silver", "bronze"][int(rng.integers(4))]
            led.assign(t, p, qos=qos)
        elif op == "remove":
            led.remove(t)
        else:
            getattr(led, op)(p)
        path = os.path.join(m.journal.record_dir(root, "placement"),
                            "manifest.json")
        with open(path, "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_record_bytes_equal_jax(tmp_path, seed):
    """Every committed generation of the ledger record is byte for byte
    JAX's for the same op sequence."""
    got = {pkg: _ledger_script(M[pkg], _tmp(tmp_path, pkg), seed)
           for pkg in M}
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) == 12


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_ledger_loads_across_packages(tmp_path, writer, reader):
    """A ledger one package committed is the other's on load: the
    placements, QoS classes and cordons."""
    root = str(tmp_path / "ledger")
    w = M[writer].place.PlacementLedger(root)
    w.assign("t1", "A", qos="gold")
    w.assign("t2", "B", qos="bronze")
    w.assign("t3", "B")
    w.cordon("C")
    r = M[reader].place.PlacementLedger(root)
    assert r.placements() == w.placements() == {"t1": "A", "t2": "B",
                                                 "t3": "B"}
    assert r.cordoned() == {"C"}
    assert [r.qos_of(t) for t in ("t1", "t2", "t3")] == \
        ["gold", "bronze", "gold"]
    assert r.on_plane("B") == ["t2", "t3"]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_ledger_crash_discipline_equals_jax(tmp_path, writer):
    """A crash between save_record's two renames (the current
    generation torn, `.prev` complete) loads the previous generation in
    both packages; with both generations gone both start empty."""
    root = str(tmp_path / "ledger")
    led = M[writer].place.PlacementLedger(root)
    led.assign("t1", "A", qos="gold")
    led.assign("t2", "B", qos="bronze")
    led.cordon("B")
    cur = M[writer].journal.record_dir(root, "placement")
    shutil.copytree(cur, cur + ".prev")
    with open(os.path.join(cur, "manifest.json"), "w") as fh:
        fh.write('{"torn')
    for m in M.values():
        led2 = m.place.PlacementLedger(root)
        assert led2.placements() == {"t1": "A", "t2": "B"}
        assert led2.cordoned() == {"B"}
        assert led2.qos_of("t2") == "bronze"
    shutil.rmtree(cur + ".prev")
    for m in M.values():
        assert m.place.PlacementLedger(root).placements() == {}


# -- the placement policy ------------------------------------------------

def _random_maps(seed: int):
    rng = np.random.default_rng(seed)
    names = [f"P{i}" for i in range(int(rng.integers(2, 6)))]
    healths = {}
    for n in names:
        cap = int(rng.choice([64, 128, 1024, 1 << 18]))
        h = {"capacity": cap,
             "headroom_rows": int(rng.integers(0, cap + 1)),
             "degrade_level": int(rng.choice([0, 0, 0, 1, 2])),
             "backlog": int(rng.choice([0, 0, 100, 70000]))}
        if rng.random() < 0.2:
            h["serving"] = False
        healths[n] = h
    qos = {f"t{j}": str(rng.choice(["gold", "silver", "bronze"]))
           for j in range(int(rng.integers(1, 12)))}
    placed = {n: [] for n in names}
    for t in qos:
        placed[str(rng.choice(names))].append(t)
    exclude = {n for n in names if rng.random() < 0.2}
    return healths, placed, qos, exclude


@pytest.mark.parametrize("seed", range(10))
def test_placement_policy_equals_jax(seed):
    """plane_score, pressure_of, choose_plane and rebalance_plan on
    seeded random health and placement maps equal JAX's exactly (the
    floats to the bit), with and without exclusions and gain floors."""
    healths, placed, qos, exclude = _random_maps(seed)
    T, J = M["torch"].place, M["jax"].place
    for n, h in healths.items():
        p = T.pressure_of(placed[n], qos.get)
        assert p == J.pressure_of(placed[n], qos.get)
        assert T.plane_score(h, p) == J.plane_score(h, p)
    for ex in ((), exclude):
        try:
            want = J.choose_plane(healths, placed, qos.get, exclude=ex)
        except J.PlacementError:
            with pytest.raises(T.PlacementError):
                T.choose_plane(healths, placed, qos.get, exclude=ex)
        else:
            assert T.choose_plane(healths, placed, qos.get,
                                  exclude=ex) == want
        for gain in (0.0, 0.1, 0.25):
            assert T.rebalance_plan(healths, placed, qos.get, exclude=ex,
                                    min_gain=gain) == \
                J.rebalance_plan(healths, placed, qos.get, exclude=ex,
                                 min_gain=gain)
    assert T.QOS_PRESSURE == J.QOS_PRESSURE
    assert T.LEDGER_RECORD == J.LEDGER_RECORD == "placement"


def test_placement_policy_deterministic_and_stable():
    """tests/test_fleet.py's policy case in both packages: headroom
    dominates, the degraded twin loses, a full plane sheds onto the
    empty ones, the applied plan re-planned on the same healths moves
    nothing, cordoned planes are never targets."""
    healths = {
        "A": {"capacity": 128, "headroom_rows": 120, "serving": True,
              "degrade_level": 0, "backlog": 0},
        "B": {"capacity": 128, "headroom_rows": 16, "serving": True,
              "degrade_level": 0, "backlog": 0},
        "C": {"capacity": 128, "headroom_rows": 120, "serving": True,
              "degrade_level": 1, "backlog": 0},
    }
    qos = {"t1": "gold", "t2": "bronze", "t3": "gold"}.get
    placed = {"B": ["t1", "t2", "t3"], "A": [], "C": []}
    plans = {}
    for pkg, m in M.items():
        P = m.place
        assert P.choose_plane(healths, {}, qos) == "A"
        assert P.plane_score(healths["A"], 0.0) > \
            P.plane_score(healths["C"], 0.0)
        moves = P.rebalance_plan(healths, placed, qos)
        assert moves and all(d in ("A", "C") for _t, _s, d in moves)
        placed2 = {p: list(ts) for p, ts in placed.items()}
        for t, s, d in moves:
            placed2[s].remove(t)
            placed2.setdefault(d, []).append(t)
        assert P.rebalance_plan(healths, placed2, qos) == []
        assert P.rebalance_plan(healths, placed, qos,
                                exclude={"A", "C"}) == []
        plans[pkg] = moves
    same(plans)


def test_rebalance_oscillates_for_a_large_tenant_fault():
    """FAULT, shared with the JAX package (ROADMAP §3): rebalance_plan's
    docstring says the gain floor and the self-pressure term make the
    reverse move strictly worse. That holds on the SAME healths (the
    case above), but the supervisor probes the healths again before
    every plan, and the headroom then moves with the tenant's rows: a
    tenant holding more than `min_gain` (0.25) of a plane's capacity
    gains the same margin going back, so every rebalance moves it again.
    Pinned in both packages (40 rows of 128: gain 0.3125 each way)."""
    def health(active):
        return {"capacity": 128, "headroom_rows": 128 - active,
                "serving": True, "degrade_level": 0, "backlog": 0}

    qos = {"big": "gold"}.get
    plans = {}
    for pkg, m in M.items():
        P = m.place
        placed, rows = {"P": ["big"], "Q": []}, {"P": 40, "Q": 0}
        seq = []
        for _ in range(4):
            healths = {n: health(rows[n]) for n in rows}
            moves = P.rebalance_plan(healths, placed, qos)
            seq.append(moves)
            for t, s, d in moves:
                placed[s].remove(t)
                placed[d].append(t)
                rows[s], rows[d] = rows[s] - 40, rows[d] + 40
        assert seq == [[("big", "P", "Q")], [("big", "Q", "P")]] * 2
        plans[pkg] = seq
    same(plans)


# -- the suspicion machine ---------------------------------------------

def _script_hard(f, chaos):
    sup = f["sup"]
    out = []
    chaos.fail_probes("A", 1)
    out.append(sup.sweep())
    out.append(sup.sweep())
    chaos.fail_probes("A", 2)
    out += [sup.sweep(), sup.sweep(), sup.sweep(), sup.sweep()]
    chaos.fail_probes("A", 4)
    out += [sup.sweep() for _ in range(5)]
    sup.mark_restarted("A")
    out.append(sup.sweep())
    return out


def _script_degraded(f, chaos):
    sup = f["sup"]
    out = []
    f["A"][1].force_degrade(2)
    out += [sup.sweep() for _ in range(10)]
    f["A"][1].force_degrade(0)
    out += [sup.sweep() for _ in range(3)]
    return out


def _script_hysteresis(f, chaos):
    sup = f["sup"]
    out = []
    for _ in range(3):          # isolated failures never turn suspect
        chaos.fail_probes("B", 1)
        out += [sup.sweep(), sup.sweep()]
    chaos.fail_probes("B", 2)
    out += [sup.sweep(), sup.sweep()]
    out.append(sup.sweep())     # one clean probe: still suspect
    chaos.fail_probes("B", 1)   # ...a failure resets the clean count
    out += [sup.sweep(), sup.sweep(), sup.sweep()]
    f["B"][1].force_degrade(2)  # a degraded answer resets it too
    out.append(sup.sweep())
    f["B"][1].force_degrade(0)
    out += [sup.sweep(), sup.sweep()]
    return out


def _script_random(seed):
    def script(f, chaos):
        rng = np.random.default_rng(seed)
        sup = f["sup"]
        out = []
        for _ in range(30):
            plane = "AB"[int(rng.integers(2))]
            r = rng.random()
            if r < 0.3:
                chaos.fail_probes(plane, int(rng.integers(1, 4)))
            elif r < 0.4:
                f[plane][1].force_degrade(int(rng.choice([0, 2])))
            elif r < 0.45:
                sup.mark_restarted(plane)
            out.append(sup.sweep())
        return out
    return script


SCRIPTS = {"hard": _script_hard, "degraded": _script_degraded,
           "hysteresis": _script_hysteresis,
           **{f"random{s}": _script_random(s) for s in range(4)}}


def _suspicion(m, tmp_path, name):
    tmp = _tmp(tmp_path, m.pkg)
    chaos = m.chaos.ChaosInjector()
    f = H.fleet(m, tmp, chaos=chaos, suspect_after=2, dead_after=4,
                healthy_after=2)
    seq = []
    real = f["sup"].sweep

    def sweep():
        tr = real()
        seq.append(_states(f["sup"]))
        return tr

    f["sup"].sweep = sweep
    trs = SCRIPTS[name](f, chaos)
    snap = f["sup"].stats.snapshot()
    return {"transitions": trs, "states": seq, "stats": snap,
            "evacuations": H.evacuation_view(f["sup"]),
            "injected": chaos.injected["probe"],
            "status": H.status_view(f["sup"])}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_suspicion_sequence_equals_jax(tmp_path, name):
    """The suspicion machine fed scripted probe outcomes: per sweep the
    transitions and every plane's (state, consecutive failures, last
    error), the stats, the status and any evacuation record equal JAX's.
    Hard failures walk healthy -> suspect -> dead, dead is final until
    mark_restarted; degraded answers turn suspect and never dead; one
    clean probe never clears suspicion."""
    r = same(both(_suspicion, tmp_path, name))
    states = [dict((n, s) for n, s, _c, _e in row) for row in r["states"]]
    if name == "hard":
        assert [s["A"] for s in states] == [
            "healthy", "healthy", "healthy", "suspect", "suspect",
            "healthy", "healthy", "suspect", "suspect", "dead", "dead",
            "healthy"]
        # mark_restarted resets the watch without a transition
        assert r["stats"]["transitions"] == {"suspect": 2, "healthy": 1,
                                             "dead": 1}
    if name == "degraded":
        assert {s["A"] for s in states[:10]} <= {"healthy", "suspect"}
        assert states[9]["A"] == "suspect" and states[-1]["A"] == "healthy"
        assert "dead" not in r["stats"]["transitions"]
    if name == "hysteresis":
        assert [s["B"] for s in states][:6] == ["healthy"] * 6
        assert states[7]["B"] == states[8]["B"] == "suspect"
        assert states[-1]["B"] == "healthy"


def test_fleet_stats_snapshot_shape():
    out = {}
    for pkg, m in M.items():
        s = m.sup.FleetStats()
        s.add(probes=3, sweeps=1)
        s.add_transition(m.sup.SUSPECT)
        s.set_reported_lost(7.0)
        out[pkg] = s.snapshot()
    snap = same(out)
    assert snap["probes"] == 3 and snap["reported_lost"] == 7.0
    assert snap["transitions"] == {"suspect": 1}


# -- the checkpoint surfaces the evacuation reads ----------------------

def _fed_plane(m, ticks: int = 10):
    """tests/test_fleet.py's one-tenant plane, fed and drained."""
    d, p, r, s, e = H.build_plane(m, {"t1": 0}, "10.0.0.1")
    k = H.feed_and_tick(d, p, "t1", 0, ticks)
    for _ in range(10):
        k += 1
        p.tick(now_s=100.0 + k * H.DT)
    p.flush()
    return d, p, r, s, e


def _live_vs_stopped(m, tmp_path):
    tmp = _tmp(tmp_path, m.pkg)
    _d, p, _r, s, e = _fed_plane(m)
    m.ckpt.save_live(f"{tmp}/live", s, e, p)
    m.ckpt.save(f"{tmp}/stop", s, e, dataplane=p)
    cols = {}
    for name in ("live", "stop"):
        with np.load(f"{tmp}/{name}/edge_state.npz") as z:
            cols[name] = {k: (z[k].dtype.str, z[k].tobytes())
                          for k in z.files}
    assert cols["live"] == cols["stop"]
    _s2, e2 = _load(m, f"{tmp}/live")
    assert e2._rows == e._rows
    cnt = m.ckpt.load_plane_counters(f"{tmp}/live")
    return {"has_counters": m.ckpt.plane_meta(f"{tmp}/live")[
                "has_counters"],
            "rx_packets": float(cnt["rx_packets"].sum()),
            "rows": sorted(e2._rows.items()),
            "wires": m.ckpt.load_wires(f"{tmp}/live", m.srv.Daemon(e2))}


def test_save_live_matches_stopped_save_equals_jax(tmp_path):
    """tests/test_fleet.py's live-save case in both packages: the live
    capture's columns equal a stopped save's bit for bit, and the row
    map, the counters and the wires it restores equal JAX's."""
    r = same(both(_live_vs_stopped, tmp_path))
    assert r["has_counters"] and r["rx_packets"] > 0
    assert r["wires"] == 2 * H.PAIRS


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_save_refuses_running_plane_points_at_save_live(tmp_path, pkg):
    """A plane with a runner thread refuses the stopped save and names
    save_live, in both packages."""
    import threading
    import time

    m = M[pkg]
    _d, p, _r, s, e = H.build_plane(m, {"t1": 0}, "10.0.0.1")
    p._thread = threading.Thread(target=lambda: time.sleep(0.2))
    p._thread.start()
    try:
        with pytest.raises(RuntimeError, match="save_live"):
            m.ckpt.save(str(tmp_path / "nope"), s, e, dataplane=p)
    finally:
        p._thread.join()
        p._thread = None
    assert not os.path.exists(tmp_path / "nope")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_autosaver_loop(tmp_path, pkg):
    """The autosave stand-in the evacuation restores from: a loop of
    live saves, no errors, the row map loads back; in both packages."""
    import time

    m = M[pkg]
    d, p, _r, s, e = H.build_plane(m, {"t1": 0}, "10.0.0.1")
    H.feed_and_tick(d, p, "t1", 0, 5)
    auto = m.ckpt.Autosaver(str(tmp_path / "ck"), s, e, p,
                            interval_s=0.05)
    auto.start()
    time.sleep(0.3)
    auto.stop()
    assert auto.saves >= 2 and auto.errors == 0
    _s2, e2 = _load(m, str(tmp_path / "ck"))
    assert e2._rows == e._rows


def _ingress_roundtrip(m, tmp_path):
    tmp = _tmp(tmp_path, m.pkg)
    d, p, _r, s, e = H.build_plane(m, {"t1": 0}, "10.0.0.1")
    H.feed_and_tick(d, p, "t1", 0, 5)
    w = d.wires.get_by_key("t1/t1-a0", 1)
    for j in range(7):
        w.ingress.append(bytes([j]) * 64)
    ck = f"{tmp}/ck"
    m.ckpt.save(ck, s, e, dataplane=p)
    entries = [(pk, int(u), bytes(f))
               for pk, u, f in m.ckpt.read_ingress_entries(ck)]
    _s2, e2 = _load(m, ck)
    d2 = m.srv.Daemon(e2)
    m.ckpt.load_wires(ck, d2)
    n = m.ckpt.load_ingress(ck, d2)
    got = [bytes(f) for f in d2.wires.get_by_key("t1/t1-a0", 1).ingress]
    m.ckpt.consume_pending(ck)
    return {"entries": entries, "loaded": n, "queue": got,
            "after_consume": m.ckpt.read_ingress_entries(ck),
            "file_left": os.path.exists(f"{ck}/wire_ingress.npz")}


def test_ingress_checkpoint_roundtrip_equals_jax(tmp_path):
    """Frames accepted but not drained survive a restart, and consume
    removes the file, the same in both packages."""
    r = same(both(_ingress_roundtrip, tmp_path))
    assert r["loaded"] == len(r["entries"]) == 7
    assert r["queue"] == [bytes([j]) * 64 for j in range(7)]
    assert r["after_consume"] == [] and not r["file_left"]


def _health_ladder(m):
    d, p, _r, _s, _e = H.build_plane(m, {"t1": 0}, "10.0.0.1")
    req = PB[m.pkg].HealthRequest()
    out = []
    for level in (0, 2, 0):
        p.force_degrade(level)
        h = d.Health(req, None)
        out.append((h.ok, h.serving, h.running, h.tenants, h.capacity,
                    h.active_rows, h.headroom_rows, h.degrade_level))
    return out


def test_health_rpc_reflects_ladder_and_tenants_equals_jax():
    """Local.Health, the probe the suspicion machine reads, through a
    degrade to the bottom rung and back: every field the machine uses
    equals JAX's."""
    seq = same(both(_health_ladder))
    assert [x[1] for x in seq] == [True, False, True]
    assert seq[0][3] == 1 and seq[0][6] == seq[0][4] - seq[0][5]


def _health_v1(m):
    import grpc

    d, p, _r, _s, _e = H.build_plane(m, {"t1": 0}, "10.0.0.1")
    server, port = m.srv.make_server(d, port=0, host="127.0.0.1",
                                     log_rpcs=False)
    server.start()
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        check = channel.unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=lambda x: x,
            response_deserializer=lambda b: b)
        out = []
        for level in (0, 2, 0):
            p.force_degrade(level)
            out.append(check(b""))
        channel.close()
        return out
    finally:
        server.stop(0)


def test_grpc_health_v1_not_serving_when_degraded_equals_jax():
    """The generic grpc.health.v1 probe agrees with Local.Health:
    NOT_SERVING while the ladder sits at its bottom rung, byte for byte
    JAX's answers."""
    assert same(both(_health_v1)) == [b"\x08\x01", b"\x08\x02",
                                      b"\x08\x01"]


# -- fork_from_checkpoint across packages ------------------------------

def _checkpointed(m, tmp):
    """Plane A of a fleet fed, with frames in flight and queued, saved
    live into tmp/ck."""
    d, p, _r, s, e = H.build_plane(m, {"t1": 0, "bg": H.PAIRS},
                                   "10.0.0.1")
    k = H.feed_and_tick(d, p, "bg", H.PAIRS, 3, fpt=1)
    k = H.feed_and_tick(d, p, "t1", 0, 3, fpt=2, k0=k)
    w = d.wires.get_by_key("t1/t1-a0", 1)
    for j in range(4):
        w.ingress.append(bytes([j]) * 64)
    ck = f"{tmp}/ck"
    m.ckpt.save_live(ck, s, e, p)
    return ck


def _fork_view(out):
    fork, arrays, counters, pending, ingress, addr = out
    return (fork, {k: (v.dtype.str, v.tobytes()) for k, v in arrays.items()},
            {k: (v.dtype.str, v.tobytes()) for k, v in counters.items()},
            [(pk, int(u), bytes(fr), float(dl)) for pk, u, fr, dl in pending],
            [(pk, int(u), bytes(fr)) for pk, u, fr in ingress], addr)


@pytest.mark.parametrize("tenant", ["t1", "bg"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_fork_from_checkpoint_across_packages(tmp_path, writer, tenant):
    """One package's checkpoint sliced by both packages'
    fork_from_checkpoint: the fork record, every array (dtype and
    bits), the counter slice, the pending and ingress frames and the
    source address are equal. The port reads the JAX package's
    checkpoint and JAX reads the port's."""
    ck = _checkpointed(M[writer], str(tmp_path))
    got = {pkg: _fork_view(m.sup.fork_from_checkpoint(ck, tenant))
           for pkg, m in M.items()}
    fork, arrays, counters, pending, ingress, addr = same(got)
    assert addr == "10.0.0.1"
    assert len(arrays["rows"][1]) == 8 * 2 * H.PAIRS    # int64 rows
    assert set(counters) >= {"rx_packets", "tx_packets"}
    assert len(fork["identities"]) == 2 * H.PAIRS
    assert fork["registry"]["namespaces"] == [tenant]
    if tenant == "t1":
        assert len(pending) > 0 and len(ingress) == 4
    for pkg, m in M.items():
        with pytest.raises(m.sup.FleetError, match="no durable state"):
            m.sup.fork_from_checkpoint(ck, "nope")


# -- evacuation --------------------------------------------------------

def _evac_pending_ingress(m, tmp_path):
    """tests/test_fleet.py's pending + ingress evacuation."""
    tmp = _tmp(tmp_path, m.pkg)
    ck_a = f"{tmp}/ckA"
    chaos = m.chaos.ChaosInjector()
    f = H.fleet(m, tmp, chaos=chaos, ck_a=ck_a, suspect_after=1,
                dead_after=2)
    d_a, p_a, _r_a, s_a, e_a = f["A"]
    d_b, p_b, r_b, _s_b, _e_b = f["B"]
    sup = f["sup"]
    k = H.feed_and_tick(d_b, p_b, "bg", H.PAIRS, 3, fpt=1)
    k = H.feed_and_tick(d_a, p_a, "t1", 0, 3, fpt=2, k0=k)
    w = d_a.wires.get_by_key("t1/t1-a0", 1)
    in_flight = len(p_a.export_pending())
    for _ in range(4):
        w.ingress.append(b"Q" * 64)
    m.ckpt.save_live(ck_a, s_a, e_a, p_a)
    chaos.kill_plane(f["fed"].handle("A"))
    trs = [sup.sweep() for _ in range(4)]
    ev = sup.evacuations()[-1]["tenants"]["t1"]
    got = []
    for _ in range(30):
        k += 1
        p_b.tick(now_s=100.0 + k * H.DT)
    p_b.flush()
    k += 5000
    p_b.tick(now_s=100.0 + k * H.DT)
    for i in range(H.PAIRS):
        for side in "ba":
            wx = d_b.wires.get_by_key(f"t1/t1-{side}{i}", i + 1)
            if wx is not None:
                got += list(wx.egress)
    return {"in_flight": in_flight, "transitions": trs,
            "evacuations": H.evacuation_view(sup), "entry": ev,
            "delivered": got, "rows": int(r_b.rows_of("t1").size),
            "ledger": sup.ledger.placements(),
            "stats": sup.stats.snapshot()}


def test_evacuation_restores_pending_and_ingress(tmp_path):
    """A checkpoint with frames in flight and queued hands both to the
    survivor; the record, the frames the survivor delivers (bytes and
    order), the ledger and the stats equal JAX's."""
    r = same(both(_evac_pending_ingress, tmp_path))
    assert r["entry"]["survivor"] == "B"
    assert r["entry"]["pending_restored"] == r["in_flight"] > 0
    assert r["entry"]["ingress_restored"] == 4
    assert len(r["delivered"]) == r["in_flight"] + 4
    assert r["rows"] == 2 * H.PAIRS


def _evac_retry(m, tmp_path):
    tmp = _tmp(tmp_path, m.pkg)
    ck_a = f"{tmp}/ckA"
    chaos = m.chaos.ChaosInjector()
    f = H.fleet(m, tmp, chaos=chaos, ck_a=ck_a, suspect_after=1,
                dead_after=2, healthy_after=1)
    d_a, p_a, _r_a, s_a, e_a = f["A"]
    r_b = f["B"][2]
    sup = f["sup"]
    H.feed_and_tick(d_a, p_a, "t1", 0, 3)
    m.ckpt.save_live(ck_a, s_a, e_a, p_a)
    chaos.fail_probes("B", 1)
    chaos.kill_plane(f["fed"].handle("A"))
    trs = [sup.sweep() for _ in range(3)]
    first = H.evacuation_view(sup)
    trs += [sup.sweep() for _ in range(4)]
    n = len(sup.evacuations())
    sup.sweep()
    return {"transitions": trs, "first": first,
            "evacuations": H.evacuation_view(sup),
            "latched": len(sup.evacuations()) == n,
            "ledger": sup.ledger.placements(),
            "rows": int(r_b.rows_of("t1").size)}


def test_evacuation_retries_until_a_survivor_is_healthy(tmp_path):
    """A plane dying while its only survivor is suspect: the failed
    evacuation is retried by later sweeps and lands once the survivor
    recovers, then latches complete; every record equals JAX's."""
    r = same(both(_evac_retry, tmp_path))
    first = next(x for x in r["first"] if x["plane"] == "A")
    assert first["tenants"]["t1"].get("survivor") is None
    assert r["ledger"]["t1"] == "B" and r["rows"] == 2 * H.PAIRS
    assert r["latched"]


def _evac_no_checkpoint(m, tmp_path):
    tmp = _tmp(tmp_path, m.pkg)
    chaos = m.chaos.ChaosInjector()
    f = H.fleet(m, tmp, chaos=chaos, suspect_after=1, dead_after=2)
    chaos.kill_plane(f["fed"].handle("A"))
    trs = [f["sup"].sweep() for _ in range(3)]
    return {"transitions": trs, "evacuations": H.evacuation_view(f["sup"]),
            "status": f["sup"].status()["planes"][0]["state"]}


def test_evacuation_without_checkpoint_reports_loss(tmp_path):
    """No checkpoint directory: the tenant cannot be restored and the
    record says so, in both packages alike."""
    r = same(both(_evac_no_checkpoint, tmp_path))
    ev = r["evacuations"][-1]["tenants"]["t1"]
    assert ev["survivor"] is None and "no durable state" in ev["error"]
    assert r["status"] == "dead"


def _evac_post_cutover(m, tmp_path):
    tmp = _tmp(tmp_path, m.pkg)
    chaos = m.chaos.ChaosInjector()
    f = H.fleet(m, tmp, chaos=chaos, suspect_after=1, dead_after=2)
    fed, sup = f["fed"], f["sup"]
    p_a, r_a = f["A"][1], f["A"][2]
    p_b = f["B"][1]

    def settle():
        p_a.tick(now_s=200.0)
        p_b.tick(now_s=200.0)

    chaos.fail_migration_step("reconcile")
    with pytest.raises(m.chaos.ChaosError):
        fed.migrate("t1", "A", "B", settle=settle)
    mid = fed.status(tenant="t1")[-1]["migration_id"]
    chaos.kill_plane(fed.handle("B"))
    trs = [sup.sweep() for _ in range(3)]
    meta = m.journal.load_record_meta(f"{tmp}/journal", mid)
    return {"transitions": trs, "evacuations": H.evacuation_view(sup),
            "state": meta["state"], "failover": meta["failover"],
            "steps": meta["steps_done"],
            "rows": int(r_a.rows_of("t1").size),
            "ledger": sup.ledger.placements()}


def test_post_cutover_dst_death_rolls_forward(tmp_path):
    """A migration that committed cutover and lost its destination
    rolls forward: the journal fork evacuates onto the alive source,
    RELEASE is finished, the record closes done; equal to JAX's."""
    r = same(both(_evac_post_cutover, tmp_path))
    assert r["state"] == "done" and r["failover"] == "B"
    assert "release" in r["steps"]
    ev = r["evacuations"][-1]["tenants"]["t1"]
    assert ev["survivor"] == "A" and ev["source"] == "journal-fork"
    assert r["rows"] == 2 * H.PAIRS and r["ledger"]["t1"] == "A"


def _orphans(m, tmp_path, fail_step):
    tmp = _tmp(tmp_path, m.pkg)
    chaos = m.chaos.ChaosInjector()
    f = H.fleet(m, tmp, chaos=chaos)
    fed = f["fed"]
    p_a, p_b = f["A"][1], f["B"][1]

    def settle():
        p_a.tick(now_s=200.0)
        p_b.tick(now_s=200.0)

    chaos.fail_migration_step(fail_step)
    with pytest.raises(m.chaos.ChaosError):
        fed.migrate("t1", "A", "B", settle=settle)
    mid = fed.status(tenant="t1")[-1]["migration_id"]
    if fail_step == "fork":
        fed.coordinator(mid).rollback()
    else:
        fed.coordinator(mid).settle = settle
    sup2 = m.sup.FleetSupervisor(fed, f"{tmp}/ledger2").attach()
    meta = m.journal.load_record_meta(f"{tmp}/journal", mid)
    return {"state": meta["state"], "steps": meta["steps_done"],
            "resumed": sup2.stats.snapshot()["orphans_resumed"],
            "ledger": sup2.ledger.placements()}


@pytest.mark.parametrize("fail_step", ["restore", "fork"])
def test_orphan_resume_on_attach(tmp_path, fail_step):
    """A fresh supervisor's attach resumes the journaled migration a
    crash left running (RESTORE fault: done, the ledger follows through
    the placement hook); a rolled-back record (FORK fault, then
    rollback) stays refused. Equal to JAX's."""
    r = same(both(_orphans, tmp_path, fail_step))
    if fail_step == "restore":
        assert r["state"] == "done" and r["resumed"] == 1
        assert r["ledger"]["t1"] == "B"
    else:
        assert r["state"] == "rolled_back" and r["resumed"] == 0
        assert r["ledger"]["t1"] == "A"


# -- the RPCs and the collector ----------------------------------------

@pytest.mark.parametrize("plane", ["B", "A", "nope"])
def test_health_by_plane_name_equals_jax(tmp_path, plane):
    """Health with a named plane answers for that plane of the
    federation (its node, tenants, capacity), or refuses an unknown
    name; the response is byte for byte JAX's."""
    def health(m):
        f = H.fleet(m, _tmp(tmp_path, m.pkg))
        d_a = f["A"][0]
        return d_a.Health(PB[m.pkg].HealthRequest(plane=plane),
                          None).SerializeToString()

    raw = same(both(health))
    resp = tpb.HealthResponse.FromString(raw)
    if plane == "nope":
        assert not resp.ok and "nope" in resp.error
    else:
        assert resp.ok and resp.node == {"A": "10.0.0.1",
                                         "B": "10.0.0.2"}[plane]
        assert resp.tenants == 1 and resp.capacity == H.CAPACITY


def _served(m, tmp_path, fn):
    """fn(client, fleet) against plane A's daemon behind a real gRPC
    server on 127.0.0.1."""
    f = H.fleet(m, _tmp(tmp_path, m.pkg))
    server, port = m.srv.make_server(f["A"][0], port=0, host="127.0.0.1",
                                     log_rpcs=False)
    server.start()
    client = m.client.DaemonClient(f"127.0.0.1:{port}")
    try:
        return fn(client, f, PB[m.pkg])
    finally:
        client.close()
        server.stop(0)


def test_fleet_status_rpc_equals_jax(tmp_path):
    """FleetStatus over gRPC after a sweep: every plane's state, health
    and placement count and the ledger, byte for byte JAX's."""
    def status(c, f, pb):
        f["sup"].sweep()
        return c.FleetStatus(pb.FleetStatusRequest()).SerializeToString()

    resp = tpb.FleetStatusResponse.FromString(same(both(
        _served, tmp_path, status)))
    assert resp.ok and [p.name for p in resp.planes] == ["A", "B"]
    assert all(p.state == "healthy" and p.health.ok for p in resp.planes)
    assert {e.tenant: e.plane for e in resp.placements} == {"t1": "A",
                                                            "bg": "B"}
    assert resp.sweeps == 1


def test_fleet_upgrade_rpc_without_restarter_equals_jax(tmp_path):
    """FleetUpgrade over gRPC on planes with no restarter: the report
    names the refusal, nothing is cordoned or drained; equal to JAX's."""
    def upgrade(c, f, pb):
        resp = c.FleetUpgrade(pb.FleetUpgradeRequest(planes=["A"]))
        return (resp.SerializeToString(), f["sup"].ledger.cordoned(),
                f["sup"].ledger.placements())

    raw, cordoned, placements = same(both(_served, tmp_path, upgrade))
    resp = tpb.FleetUpgradeResponse.FromString(raw)
    assert not resp.ok and resp.migrations == 0
    assert resp.reports[0].error.startswith("plane A has no")
    assert cordoned == set() and placements["t1"] == "A"


def _exposition(m, tmp_path):
    tmp = _tmp(tmp_path, m.pkg)
    chaos = m.chaos.ChaosInjector()
    f = H.fleet(m, tmp, chaos=chaos, ck_a=f"{tmp}/ckA", suspect_after=1,
                dead_after=2)
    d_a, p_a, _r, s_a, e_a = f["A"]
    H.feed_and_tick(d_a, p_a, "t1", 0, 3)
    m.ckpt.save_live(f"{tmp}/ckA", s_a, e_a, p_a)
    chaos.kill_plane(f["fed"].handle("A"))
    for _ in range(3):
        f["sup"].sweep()
    f["sup"].stats.set_reported_lost(5.0)
    reg, _h = m.metrics.make_registry(fleet=f["sup"])
    return sorted(generate_latest(reg).decode().splitlines())


def test_fleet_collector_exposition_equals_jax(tmp_path):
    """make_registry(fleet=...) registers FleetStatsCollector; after a
    kill and an evacuation its kubedtn_fleet_* lines equal JAX's."""
    lines = same(both(_exposition, tmp_path))
    text = "\n".join(lines)
    for want in ("kubedtn_fleet_probes_total", "kubedtn_fleet_sweeps_total",
                 'kubedtn_fleet_planes{state="dead"} 1.0',
                 "kubedtn_fleet_evacuated_tenants_total 1.0",
                 "kubedtn_fleet_reported_lost 5.0",
                 'kubedtn_fleet_transitions_total{to_state="dead"} 1.0',
                 "kubedtn_fleet_placements 2.0"):
        assert want in text, want


def _escalate(m, tmp_path):
    """A fleet-wide burn through the autopilot into the supervisor's
    real rebalance: plane A crowded (t1, t2, t3 in capacity 16), B
    empty but for bg."""
    tmp = _tmp(tmp_path, m.pkg)
    a = H.build_plane(m, {"t1": 0, "t2": 1, "t3": 2}, "10.0.0.1",
                      capacity=16)
    b = H.build_plane(m, {"bg": 3}, "10.0.0.2", capacity=64)
    fed = m.fed.FederationController(f"{tmp}/journal")
    fed.register(m.fed.PlaneHandle("A", *a[:3]))
    fed.register(m.fed.PlaneHandle("B", *b[:3]))
    sup = m.sup.FleetSupervisor(fed, f"{tmp}/ledger").attach()
    ap_mod = m.autopilot

    class Ev:
        def verdicts(self):
            import types

            return {n: types.SimpleNamespace(
                severity="page", qos="gold", spec=None,
                throttle_backlog=0.0) for n in ("t1", "t2", "t3")}

    ap = ap_mod.Autopilot(None, None, Ev(), fleet=sup,
                          config=ap_mod.AutopilotConfig(
                              page_polls=99, cooldown_s=30.0,
                              fleet_page_tenants=3),
                          clock=lambda: 100.0)
    ap.enable()
    polls = ap.poll()
    return {"polls": polls, "ledger": sup.ledger.placements(),
            "rows": {t: int(b[2].rows_of(t).size)
                     for t in ("t1", "t2", "t3")},
            "migrations": [(r["tenant"], r["src"], r["dst"], r["state"])
                           for r in fed.status()]}


def test_autopilot_escalation_reaches_a_real_rebalance(tmp_path):
    """The autopilot's fleet tier calls FleetSupervisor.rebalance, which
    runs the placement plan as live migrations off the crowded plane;
    the escalation record, the ledger and the migrations equal JAX's."""
    r = same(both(_escalate, tmp_path))
    esc = [x for x in r["polls"] if x.get("kind") == "escalate"]
    assert esc and esc[0]["verdict"] == "escalated" and esc[0]["moves"] > 0
    moved = [t for t, p in r["ledger"].items() if p == "B" and t != "bg"]
    assert len(moved) == esc[0]["moves"]
    assert all(r["rows"][t] == 2 * H.PAIRS for t in moved)
    assert all(s == "done" for *_x, s in r["migrations"])


def _observe_fleet(m, tmp_path):
    tmp = _tmp(tmp_path, m.pkg)
    f = H.fleet(m, tmp, telemetry=True)
    d_a, p_a = f["A"][0], f["A"][1]
    d_b, p_b = f["B"][0], f["B"][1]
    k = H.feed_and_tick(d_a, p_a, "t1", 0, 5)
    k = H.feed_and_tick(d_b, p_b, "bg", H.PAIRS, 5, k0=k)

    def settle():
        nonlocal k
        k += 1
        p_a.tick(now_s=100.0 + k * H.DT)
        p_b.tick(now_s=100.0 + k * H.DT)

    f["fed"].migrate("t1", "A", "B", settle=settle)
    f["sup"].sweep()
    pb = PB[m.pkg]
    out = {}
    for tenant in ("", "t1"):
        resp = d_b.ObserveSLO(pb.ObserveSLORequest(fleet=True,
                                                   tenant=tenant), None)
        out[tenant] = [(t.tenant, t.frozen, list(t.frozen_planes),
                        t.frozen_tx, t.frozen_delivered, t.tx,
                        t.delivered, t.severity)
                       for t in resp.tenants] + [resp.ok, resp.fleet]
    return out


def test_observe_slo_fleet_branch_equals_jax(tmp_path):
    """ObserveSLO(fleet=true) on a daemon with a supervisor serves the
    sweep's fleet merge: a migrated tenant's live half on its new plane
    with the journal's frozen slice from the old one; equal to JAX's."""
    r = same(both(_observe_fleet, tmp_path))
    assert r[""][-2:] == [True, True]
    t1 = [x for x in r["t1"][:-2] if x[0] == "t1"]
    assert t1 and t1[0][2] == ["A"] and t1[0][4] > 0


def test_build_fleet_wires_the_autopilot_and_the_exporter(tmp_path):
    """entry.build_fleet attaches the supervisor as the JAX CLI does
    (placement hook, every daemon's `fleet`, FleetStatus answering) and
    points an autopilot built before it at it; serve_metrics then
    exports the kubedtn_fleet_* series."""
    from kubedtn_tpu_torch import entry

    m = M["torch"]
    a = entry.build_daemon("cpu", capacity=64, tenancy=True, slo=True,
                           node_ip="10.0.0.1",
                           crs=entry.clos_crs(2, 2, 1, namespace="ta",
                                              node_ip="10.0.0.1"))
    b = entry.build_daemon("cpu", capacity=64, tenancy=True,
                           node_ip="10.0.0.2",
                           crs=entry.clos_crs(2, 2, 1, namespace="tb",
                                              node_ip="10.0.0.2",
                                              uid_base=4))
    try:
        assert a["autopilot"].fleet is None
        fed = entry.build_federation({"A": a, "B": b},
                                     str(tmp_path / "journal"))
        sup = entry.build_fleet(fed, str(tmp_path / "ledger"),
                                suspect_after=3)
        assert isinstance(sup, m.sup.FleetSupervisor)
        assert sup.suspect_after == 3
        assert fed.placement_hook == sup._on_migrated
        assert a["daemon"].fleet is sup and b["daemon"].fleet is sup
        assert a["autopilot"].fleet is sup
        assert sup.ledger.placements() == {"ta": "A", "tb": "B"}
        st = a["daemon"].FleetStatus(tpb.FleetStatusRequest(), None)
        assert st.ok and [p.name for p in st.planes] == ["A", "B"]
        ms = entry.serve_metrics(b["daemon"], b["plane"], port=0,
                                 host="127.0.0.1")
        try:
            body = generate_latest(ms["registry"]).decode()
            assert "kubedtn_fleet_placements 2.0" in body
        finally:
            ms["server"].stop()
    finally:
        a["slo"].stop()
        a["autopilot"].stop()


def test_grpc_probe_dials_health(tmp_path):
    """grpc_probe reads a live daemon's Health over the wire as the
    JAX package's does (the same dict), and raises once the server is
    gone: the hard failure the suspicion machine counts."""
    out = {}
    for pkg, m in M.items():
        f = H.fleet(m, _tmp(tmp_path, pkg))
        server, port = m.srv.make_server(f["B"][0], port=0,
                                         host="127.0.0.1", log_rpcs=False)
        server.start()
        probe = m.sup.grpc_probe(f"127.0.0.1:{port}", timeout_s=2.0)
        out[pkg] = probe()
        server.stop(None)
        with pytest.raises(Exception):
            probe()
    h = same(out)
    assert h["node"] == "10.0.0.2" and h["serving"] and h["tenants"] == 1


# -- the scenarios -----------------------------------------------------

@pytest.mark.parametrize("pairs", [1, 2])
def test_plane_failover_equals_jax(pairs):
    """plane_failover at CPU size in both packages: the whole outcome
    but the wall time equals JAX's — the evacuation (survivor, source,
    rows, the resolved migration), the failover accounting exact with
    reported_lost == the gap frames, the gauges, the transitions."""
    from _torch_native_guard import ensure_jax_native

    ensure_jax_native()
    r = {pkg: m.scen.plane_failover(pairs=pairs, warm_ticks=20,
                                    **({"device": "cpu"}
                                       if pkg == "torch" else {}))
         for pkg, m in M.items()}
    for v in r.values():
        v.pop("wall_s")
    out = same(r)
    assert out["in_guardrails"] and out["restored_rows_byte_identical"]
    acct = out["accounting"]
    assert acct["mismatch"] == 0.0
    assert acct["reported_lost"] == out["gap_frames"] > 0
    assert out["fed"] == (acct["delivered_src"] + acct["delivered_dst"]
                          + acct["reported_lost"])


def test_fleet_rolling_upgrade_verdict_equals_jax():
    """fleet_rolling_upgrade at CPU size: both planes drained, restarted
    on their ports, verified and refilled under a retrying producer,
    every accepted frame delivered, in both packages; the verdicts, the
    reports and the migration counts equal JAX's (the frame counts
    follow the host's clock)."""
    from _torch_native_guard import ensure_jax_native

    ensure_jax_native()
    r = {pkg: m.scen.fleet_rolling_upgrade(
        steady_s=0.4, offered_frames_per_s=1_000,
        **({"device": "cpu"} if pkg == "torch" else {}))
        for pkg, m in M.items()}
    keys = ("frames_lost", "migrations", "reports", "in_guardrails",
            "accounting_mismatch_gauge", "migrations_completed")
    out = same({pkg: {k: v[k] for k in keys} for pkg, v in r.items()})
    assert out["in_guardrails"] and out["frames_lost"] == 0
    assert out["migrations"] == out["migrations_completed"] == 4
    assert r["torch"]["frames_fed"] == r["torch"]["frames_delivered"] > 0
