"""The plane-only probes of kubedtn_tpu_torch.scenarios on the CPU:
`_plane_only_setup` + `_probe_round` fed the same rounds in both packages
(the same realized rows, virtual clocks, deliveries and, with telemetry
on, the same recorder and window counts and link rows), and the probe
scenarios `telemetry_overhead`, `pause_observability`, `slo_overhead`,
`whatif_sweep` and `sharded_soak` at the sizes of the JAX package's own
smoke tests, held against JAX where no wall clock decides the answer:
the forced barriers' causes and rows, the sweep's perturbation list and
snapshot, the sharded plane's shard layout and cross-shard counts.

The JAX package's planes run under tests/_torch_native_guard.py. The
JAX plane's pipeline depth follows the host's core count and the port's
CPU plane's is 1: the round-for-round comparisons set both to the same
depth. JAX's sharded plane program needs `check_vma=False` on the
installed jax (tests/test_torch_sharded.py's fixture)."""

import functools
import inspect

import jax
import numpy as np
import pytest

from kubedtn_tpu import runtime as jrt
from kubedtn_tpu import scenarios as jsc
from kubedtn_tpu import twin as jtwin
from kubedtn_tpu.parallel import mesh as jmesh
from kubedtn_tpu_torch import convert
from kubedtn_tpu_torch import scenarios as tsc
from kubedtn_tpu_torch import twin as ttwin

from _torch_native_guard import assert_jax_wheel, ensure_jax_native

PROBES = ("telemetry_overhead", "slo_overhead", "pause_observability",
          "whatif_sweep", "sharded_soak")
ROUNDS = (100, 5_000, 37, 4_096)     # frames per wire, round by round


@pytest.fixture
def jax_rep_unchecked(monkeypatch):
    monkeypatch.setattr(jmesh, "shard_map",
                        functools.partial(jax.shard_map, check_vma=False))
    monkeypatch.setattr(jrt, "_EXCHANGE_PROBE_CACHE", {})


def probe_pair(pairs: int, depth: int, prefix: str):
    """`_plane_only_setup` in both packages, both planes at `depth`."""
    assert ensure_jax_native() is None
    j = jsc._plane_only_setup(pairs, "2ms", 2_000.0, prefix)
    assert_jax_wheel(j[2])
    t = tsc._plane_only_setup(pairs, "2ms", 2_000.0, prefix, device="cpu")
    for parts in (j, t):
        parts[2].pipeline_depth = depth
    return j, t


@pytest.mark.parametrize("name", [*PROBES, "_plane_only_setup",
                                  "_probe_round"])
def test_defaults_equal_jax(name):
    jp = inspect.signature(getattr(jsc, name)).parameters
    tp = inspect.signature(getattr(tsc, name)).parameters
    extra = ["device"] if "device" in tp else []
    assert list(tp) == [*jp, *extra]
    for k, p in jp.items():
        assert tp[k].default == p.default, k


@pytest.mark.parametrize("depth", [1, 2])
def test_plane_only_setup_realises_jax_engine(depth):
    j, t = probe_pair(3, depth, "pp")
    try:
        je, te = j[1], t[1]
        assert te._rows == je._rows
        ts = convert.edge_state_to_numpy(te.state)
        for f in ("uid", "src", "dst", "active", "props"):
            np.testing.assert_array_equal(ts[f], np.asarray(
                getattr(je.state, f)), err_msg=f)
        for k in (3, 4):
            assert [w.wire_id for w in t[k]] == [w.wire_id for w in j[k]]
        assert t[2].pipeline_explicit_clock and j[2].pipeline_explicit_clock
    finally:
        j[2].stop()
        t[2].stop()


@pytest.mark.parametrize("telemetry", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("depth", [1, 2])
def test_probe_rounds_equal_jax(depth, telemetry):
    """The same rounds through both packages' probes: the clock after
    each round (the ticks it took), every frame delivered, the plane's
    counts, and with telemetry on (windows of 4 ms, so rounds close
    some) the recorder's samples and events, the windows closed and the
    link rows."""
    j, t = probe_pair(2, depth, "pr")
    tels = []
    try:
        for parts in (j, t):
            if telemetry:
                tels.append(parts[2].enable_telemetry(window_s=0.004,
                                                      sample_period=16))
        clocks = {"jax": [], "torch": []}
        for key, parts in (("jax", j), ("torch", t)):
            clk = 100.0
            for n in ROUNDS:
                rate, clk = tsc._probe_round(parts[2], parts[3], parts[4],
                                             n, clk, 0.002) \
                    if key == "torch" else jsc._probe_round(
                        parts[2], parts[3], parts[4], n, clk, 0.002)
                assert rate > 0
                clocks[key].append(clk)
        assert clocks["torch"] == clocks["jax"]
        for attr in ("ticks", "shaped", "dropped", "bypassed",
                     "tick_errors"):
            assert getattr(t[2], attr) == getattr(j[2], attr), attr
        assert t[2].shaped == 2 * sum(ROUNDS)
        if telemetry:
            (jtel, jrec), (ttel, trec) = tels
            assert trec.sampled == jrec.sampled > 0
            assert trec.recorded == jrec.recorded > 0
            assert ttel.windows_closed == jtel.windows_closed > 0
            jrows, _js, jtr = jtel.link_rows(j[1])
            trows, _ts, ttr = ttel.link_rows(t[1])
            key = ("pod", "namespace", "uid", "row", "tx", "delivered",
                   "dropped_loss", "dropped_queue", "queue_depth")
            assert [{k: r[k] for k in key} for r in trows] == \
                [{k: r[k] for k in key} for r in jrows]
            assert len(trows) == 2 and ttr == jtr == 0   # the fed ends
    finally:
        j[2].stop()
        t[2].stop()


# -- the probe scenarios (the JAX package's smoke sizes and asserts) -------

def test_telemetry_overhead_under_5pct():
    """tests/test_telemetry_overhead.py on the port: the best of three
    trials meets the 5 % bar."""
    last = None
    for _trial in range(3):
        r = tsc.telemetry_overhead(pairs=2, frames_per_wire=6_000,
                                   rounds=3, device="cpu")
        last = r
        assert r["device"] == "cpu"
        assert r["tick_errors_off"] == 0
        assert r["tick_errors_on"] == 0
        assert r["sampled_frames"] > 0
        assert r["recorder_events"] > 0
        assert r["telemetry_link_rows"] == 2
        assert r["frames_per_s_off"] > 0
        assert r["frames_per_s_on"] > 0
        if r["meets_5pct_target"]:
            break
    assert last["meets_5pct_target"], last


PAUSE_KW = dict(pairs=2, frames_per_wire=600, rounds=2,
                load_frames_per_wire=300)


def test_pause_observability_equals_jax():
    """tests/test_pauses.py's smoke on the port, and the forced barriers
    equal to JAX's: each cause's count and rows, the rows compact moved
    and the staged rounds."""
    assert ensure_jax_native() is None
    j = jsc.pause_observability(**PAUSE_KW)
    t = tsc.pause_observability(**PAUSE_KW, device="cpu")
    # both packages add `stalled_first_attempt` only when a round stalled
    # and was measured again, which depends on the host's timing
    cond = {"stalled_first_attempt"}
    assert set(t) - cond == (set(j) - cond) | {"device"}, \
        (set(t) - cond) ^ ((set(j) - cond) | {"device"})
    assert t["all_attributed"], t["forced"]
    assert t["staged_ok"] and t["staged_rounds"] >= 1
    assert t["compact_moved"] >= 1
    for cause in ("checkpoint_save", "compact", "staged_update"):
        st = t["causes"][cause]
        assert st["count"] >= 1 and st["seconds"] > 0.0
        assert st["rows"] > 0
        assert (st["count"], st["rows"]) == (j["causes"][cause]["count"],
                                             j["causes"][cause]["rows"])
    assert t["tick_errors_on"] == 0 and t["tick_errors_off"] == 0
    assert isinstance(t["hook_overhead_pct"], float)
    assert t["dropped_events"] == 0
    for k in ("compact_moved", "staged_rounds", "staged_ok",
              "all_attributed", "dropped_events"):
        assert t[k] == j[k], k


def test_slo_overhead_smoke():
    r = tsc.slo_overhead(pairs=2, frames_per_wire=3_000, rounds=2,
                         device="cpu")
    assert r["device"] == "cpu" and r["scenario"] == "slo_overhead"
    assert r["tick_errors_off"] == 0 and r["tick_errors_on"] == 0
    assert r["slo_evaluations"] > 0
    assert r["tenants_evaluated"] == r["tenants"] == 3
    assert r["all_ok"]
    assert len(r["rounds_off_frames_per_s"]) >= 2
    assert isinstance(r["overhead_pct"], float)
    assert r["meets_1pct_target"] == (r["overhead_pct"] < 1.0)


class _Recorded(Exception):
    pass


def record_sweep(monkeypatch, module, calls, run: bool):
    """Record `module.run_sweep`'s arguments; the JAX sweep is not run
    (the recorder raises once the call is recorded)."""
    real = module.run_sweep

    def recorded(snap, scenarios, **kw):
        calls.append((snap, list(scenarios), kw))
        if not run:
            raise _Recorded
        return real(snap, scenarios, **kw)

    monkeypatch.setattr(module, "run_sweep", recorded)


def scenario_list(scenarios) -> list:
    return [(sc.name, [(p.kind, p.uid, p.node, p.factor)
                       for p in sc.perturbations]) for sc in scenarios]


def test_whatif_sweep_smoke_and_sweep_equal_jax(monkeypatch):
    """tests/test_twin.py's smoke on the port; the sweep it asks for
    equals JAX's: the scenario list (names, kinds, uids, nodes, factors)
    drawn from the same numpy generator, the snapshot's active rows and
    their columns, and the sweep's arguments."""
    kw = dict(replicas=6, steps=40, n_nodes=12, n_links=24, k_slots=2)
    jcalls, tcalls = [], []
    record_sweep(monkeypatch, jtwin, jcalls, run=False)
    record_sweep(monkeypatch, ttwin, tcalls, run=True)
    with pytest.raises(_Recorded):
        jsc.whatif_sweep(**kw)
    r = tsc.whatif_sweep(**kw, device="cpu")
    assert r["device"] == "cpu"
    assert r["replicas"] == 6
    assert r["steps"] == 40
    assert r["replicas_steps_per_s"] > 0
    assert r["virtual_speedup"] > 0
    assert 0 < r["baseline_delivery_ratio"] <= 1.0
    assert ((r["worst_delivery_ratio"] or 0.0)
            <= r["baseline_delivery_ratio"])
    assert r["compile_s"] >= 0.0 and r["run_s"] > 0.0
    (jsnap, jscen, jkw), = jcalls
    (tsnap, tscen, tkw), = tcalls
    assert scenario_list(tscen) == scenario_list(jscen)
    kinds = {p.kind for sc in tscen for p in sc.perturbations}
    assert kinds == {"degrade", "fail", "blackhole", "scale"}
    for k in ("steps", "dt_us", "k_slots", "seed"):
        assert tkw[k] == jkw[k], k
    je, te = jsnap.sim.edges, convert.edge_state_to_numpy(tsnap.sim.edges)
    act = np.asarray(je.active)
    np.testing.assert_array_equal(te["active"], act)
    for f in ("uid", "src", "dst", "props"):
        np.testing.assert_array_equal(te[f][act], np.asarray(
            getattr(je, f))[act], err_msg=f)
    assert tsnap.n_nodes == jsnap.n_nodes == 12


# 7 pairs pad the capacity to 36 rows: 9 a shard on 4 shards, so the pair
# on rows 8 and 9 straddles the first boundary
SHARD_KW = dict(pairs=7, frames_per_wire=300, rounds=1, devices=4)
SHARD_EXACT = ("mesh_shape", "edges_per_shard", "shard_imbalance",
               "colocated_frac", "xshard_frames_total", "mailbox_hwm",
               "devices", "dropped", "tick_errors")


def test_sharded_soak_on_4_shards_equals_jax(jax_rep_unchecked):
    assert ensure_jax_native() is None
    j = jsc.sharded_soak(**SHARD_KW)
    t = tsc.sharded_soak(**SHARD_KW, device="cpu")
    assert set(t) == set(j) | {"device"}, set(t) ^ (set(j) | {"device"})
    assert j["mesh_shape"] == [4]
    for k in SHARD_EXACT:
        assert t[k] == j[k], (k, t[k], j[k])
    assert t["xshard_frames_total"] > 0
    assert sum(t["edges_per_shard"]) == 2 * SHARD_KW["pairs"]
    assert t["backend"] == "cpu" and t["remote_dma"] is False
    assert t["exchange_seconds"] > 0
    assert t["sharded_over_single"] > 0


def test_sharded_soak_default_devices_on_the_cpu_is_one_shard():
    r = tsc.sharded_soak(pairs=2, frames_per_wire=200, rounds=1,
                         device="cpu")
    assert r["devices"] == 1 and r["mesh_shape"] == [1]
    assert r["xshard_frames_total"] == 0 and r["exchange_seconds"] == 0.0
    assert r["dropped"] == 0 and r["tick_errors"] == 0


# -- chip_smoke.py's phase 24 helpers, rehearsed on the CPU -----------------

def test_chip_smoke_whatif_replay_rehearsed_on_the_cpu():
    """24(d)'s SweepLog records whatif_sweep's one sweep, and the replay
    of it through K1's wrapper and the plain version agrees bit for bit
    (the wrapper runs the plain step on CPU tensors: no launch)."""
    import chip_smoke

    with chip_smoke.SweepLog() as sweeps:
        tsc.whatif_sweep(replicas=6, steps=10, n_nodes=12, n_links=24,
                         k_slots=2, device="cpu")
    assert len(sweeps.calls) == 1
    call = sweeps.calls[0]
    assert len(call.scenarios) == 6 and call.kw["steps"] == 10
    out = chip_smoke.replay_whatif_sweep(call, False, 3)
    assert out == {"replicas": 6, "steps": 3, "k_slots": 2,
                   "rows": 6 * int(call.snapshot.sim.edges.capacity),
                   "k1_compare_launches": 0}


def test_chip_smoke_shard_accounting_rehearsed_on_the_cpu():
    """24(e)'s ShardLog on the CPU: one sharded plane recorded, its first
    ring step captured, and the ring steps == (dispatches + exchange
    probe runs) x (S - 1), the structure 24(e) holds K4's count to."""
    import chip_smoke

    probe = chip_smoke.ProbeK4().install()
    try:
        with chip_smoke.ShardLog() as shards:
            r = tsc.sharded_soak(pairs=7, frames_per_wire=300, rounds=1,
                                 devices=4, device="cpu")
    finally:
        probe.uninstall()
    (plane,) = shards.planes
    S = len(plane._shard_mesh)
    assert S == 4 and r["mesh_shape"] == [4]
    assert plane._exchange_count > 0 and probe.runs >= 1
    assert shards.steps == (plane._exchange_count + probe.runs) * (S - 1)
    blocks, mesh = shards.first
    assert len(blocks) == len(mesh) == S
    assert probe.launches == 0
