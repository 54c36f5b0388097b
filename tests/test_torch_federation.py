"""Live tenant migration in the port (kubedtn_tpu_torch.federation),
held against the JAX package's own contracts and against the JAX
package itself.

Within the port, tests/test_federation.py's contracts re-pinned: a
tenant migrated src -> dst mid-run delivers the stream of the same
tenant never migrated, byte for byte and on the same ticks, at pipeline
depths 1 and 2, for a clean run and after a crash at each of the six
steps (then resume); a rollback before cutover leaves src serving the
never-migrated stream and dst without a trace (a neighbour wire in the
tenant's namespace survives); the journal's crash discipline; the hold;
the RPCs; the collector. The alignment contract is JAX's: the planes
share a seed, tick in lockstep, and the migration lands in a feed gap
of the tenant (tests/_torch_federation_harness.py).

Against JAX, on deterministic links only (threefry and Philox draw
different bits): the fork record and fork.npz, the migrated tenant's
egress and `check_accounting`, the journal read both ways, a JAX record
committed at FORK resumed on the port's planes, and the engine's
`adopt_rows` / `abandon_rows`.
"""

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import _torch_federation_harness as H

pytestmark = pytest.mark.federation

TM = H.fmods("torch")
STEPS = TM.fed.STEPS
# the record's wall-clock fields: everything else of two packages'
# records of one migration is equal
WALL_FIELDS = ("started_s", "finished_s", "step_seconds")

_REF = {}


def _ref(depth, props=None, frame_bytes=64):
    key = (depth, id(props), frame_bytes)
    if key not in _REF:
        _REF[key] = H.reference(TM, depth, props=props,
                                frame_bytes=frame_bytes)
    return _REF[key]


def _same_stream(h, ref, name):
    for i in range(H.PAIRS):
        assert h.deliv[i] == ref[0][i], f"{name}: wire {i} bytes"
        assert h.ticks[i] == ref[3][i], f"{name}: wire {i} ticks"


def _accounted(cnt):
    return (cnt["delivered_packets"] + cnt["dropped_loss"]
            + cnt["dropped_queue"] + cnt["dropped_ring"])


# -- within the port: the JAX package's contracts ---------------------

@pytest.mark.parametrize("depth", [1, 2], ids=["d1", "d2"])
def test_migration_byte_identical(depth):
    ref = _ref(depth)
    rec, h, acct, stats, _fed = H.run_migrated(TM, depth=depth)
    assert rec["state"] == "done"
    assert rec["steps_done"] == list(STEPS)
    assert h.fed == ref[1]
    _same_stream(h, ref, "clean")
    assert acct["mismatch"] == 0.0
    assert acct["accounted_src"] + acct["accounted_dst"] == \
        pytest.approx(_accounted(ref[2]))
    assert stats.snapshot()["accounting_mismatch"] == 0.0


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("depth", [1, 2], ids=["d1", "d2"])
def test_crash_at_step_resumes_byte_identical(depth, step):
    """An injected failure at the step (side effects done, commit not
    written), then resume: the stream stays the never-migrated one and
    the accounting reconciles."""
    ref = _ref(depth)
    rec, h, acct, stats, _fed = H.run_migrated(TM, depth=depth,
                                               fail_step=step)
    assert rec["state"] == "done"
    assert rec["resumed"] >= 1
    _same_stream(h, ref, step)
    assert acct["mismatch"] == 0.0, acct
    snap = stats.snapshot()
    assert snap["resumed"] >= 1 and snap["completed"] == 1
    assert snap["accounting_mismatch"] == 0.0


def test_sharded_source_migration_byte_identical():
    """A source plane on 2 virtual CPU shards at depth 2: the fork reads
    the engine's whole state after stage_update_round's pipeline flush,
    so the migrated stream is the unsharded never-migrated one."""
    ref = _ref(2)
    rec, h, acct, _stats, _fed = H.run_migrated(TM, depth=2, shards=2)
    assert rec["state"] == "done"
    _same_stream(h, ref, "sharded source")
    assert acct["mismatch"] == 0.0


@pytest.mark.parametrize("step", ["throttle", "fork", "restore",
                                  "cutover"])
def test_crash_rollback_byte_identical(step):
    ref = _ref(1)
    rec, h, _acct, stats, fed = H.run_migrated(
        TM, depth=1, fail_step=step, do="rollback", neighbor_wire=True)
    assert rec["state"] == "rolled_back"
    _same_stream(h, ref, step)
    assert stats.snapshot()["rolled_back"] == 1
    assert fed.handle("A").registry.get("mig") is not None
    dst = fed.handle("B")
    assert dst.registry.get("mig") is None
    assert dst.registry.rows_of("mig").size == 0
    assert not [k for k in dst.engine._rows if k[0].startswith("mig/")]
    assert not dst.store.list("mig")
    assert dst.daemon.wires.get_by_key("mig/neighbor", 9999) is not None
    assert [w.pod_key for w in dst.daemon.wires.in_namespaces(["mig"])] \
        == ["mig/neighbor"]
    with pytest.raises(TM.fed.MigrationError):
        fed.resume(rec["migration_id"])


@pytest.mark.parametrize("depth", [1, 2], ids=["d1", "d2"])
def test_tbf_fork_mid_bucket_lands_after_the_adopt_scatter(depth):
    """A TBF tenant forked mid-bucket (tokens below burst, backlog_until
    ahead of the clock): the restored rows carry those dynamics, so the
    migrated stream leaves on the never-migrated ticks. Restoring them
    before adopt_rows' pending init lands would restart every row from a
    full bucket: the bytes stay, the ticks move."""
    seen = {}

    def on_fork(arrays, co):
        seen.update({k: v.copy() for k, v in arrays.items()})

    ref = _ref(depth, H.DET_PROPS, 1500)
    rec, h, acct, _stats, fed = H.run_migrated(
        TM, depth=depth, props=H.DET_PROPS, frame_bytes=1500,
        on_fork=on_fork)
    assert rec["state"] == "done"
    burst = 9e6 / 250.0
    fed_rows = seen["pkt_count"] > 0
    assert fed_rows.any()
    assert (seen["tokens"][fed_rows] < burst).all()
    assert (seen["backlog_until"][fed_rows] > 0.0).all()
    _same_stream(h, ref, "tbf")
    assert acct["mismatch"] == 0.0
    dst = fed.handle("B")
    rows = dst.registry.rows_of("mig")
    assert rows.size == 2 * H.PAIRS


def test_migration_ids_never_reuse_journaled_records():
    root = tempfile.mkdtemp(prefix="kdt-fed-test-")
    TM.journal.save_record(root, "t-0001", {"migration_id": "t-0001",
                                            "state": "done"})
    fed = TM.fed.FederationController(root)
    assert fed._new_migration_id("t", None) == "t-0002"
    with pytest.raises(TM.fed.MigrationError):
        fed._new_migration_id("t", "t-0001")
    assert TM.journal.load_record_meta(root, "t-0001")["state"] == "done"


def test_concurrent_migration_of_same_tenant_refused():
    fed = TM.fed.FederationController(tempfile.mkdtemp(prefix="kdt-fed-"))
    fed._begin("t")
    with pytest.raises(TM.fed.MigrationError):
        fed._begin("t")
    fed._begin("other")
    fed._end("t")
    fed._begin("t")


def test_resume_after_controller_restart():
    ref = _ref(1)
    rec, h, acct, _stats, _fed = H.run_migrated(
        TM, depth=1, fail_step="restore", restart_controller=True)
    assert rec["state"] == "done"
    _same_stream(h, ref, "restart")
    assert acct["mismatch"] == 0.0


def test_rollback_after_cutover_refused():
    chaos = TM.chaos.ChaosInjector(seed=1)
    chaos.fail_migration_step("reconcile")
    fed, (d_s, p_s, _r), (d_d, p_d, _r2), _root = H.federation(
        TM, chaos=chaos)
    h = H.Harness([(d_s, p_s), (d_d, p_d)],
                  {id(d_s): "bg", id(d_d): "bg2"})
    for _ in range(3):
        h.feed_mig(d_s)
        h.tick()
    with pytest.raises(TM.chaos.ChaosError):
        fed.migrate("mig", "A", "B", settle=h.tick,
                    reconcile_timeout_s=5.0)
    mid = fed.status(tenant="mig")[-1]["migration_id"]
    with pytest.raises(TM.fed.MigrationError):
        fed.coordinator(mid).rollback()


def test_hold_queues_frames_with_typed_verdict():
    d, p, r = H.build_plane(TM, ["bg", "mig"])
    h = H.Harness([(d, p)], {id(d): "bg"})
    r.hold("mig")
    assert r.held("mig")
    for _ in range(3):
        h.feed_mig(d)
        h.tick()
    assert sum(len(x) for x in h.deliv) == 0
    assert sum(len(H.wire(d, "mig", "a", i).ingress)
               for i in range(H.PAIRS)) == h.fed
    verdicts = r.admission.recent()
    assert verdicts and all(v.reason == "migration-hold"
                            for v in verdicts)
    r.release_hold("mig")
    for _ in range(10):
        h.tick()
    h.finish()
    delivered = sum(len(x) for x in h.deliv)
    assert delivered > 0
    # held frames queued, never dropped: after the release every fed
    # frame reached a terminal outcome
    cnt = r.tenant_counters(p, "mig")
    assert cnt["delivered_packets"] == delivered
    assert _accounted(cnt) == h.fed


def test_coordinator_from_journal_unknown_plane():
    root = tempfile.mkdtemp(prefix="kdt-fed-test-")
    TM.journal.save_record(root, "m-x", {
        "migration_id": "m-x", "tenant": "t", "src": "A", "dst": "B",
        "state": "running", "steps_done": [], "resumed": 0,
        "rollbacks": 0, "step_seconds": {}})
    with pytest.raises(KeyError):
        TM.fed.MigrationCoordinator.from_journal(root, "m-x", {})


def test_build_federation_registers_planes_on_the_cpu(tmp_path):
    """entry.build_federation over two build_daemon planes (the CPU
    here): both daemons answer for the controller, a migration moves a
    tenant and serve_metrics exports its stats."""
    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.wire import proto as pb

    members = {}
    for name, ns, ip in (("A", "ta", "10.0.0.1"), ("B", "tb", "10.0.0.2")):
        crs = entry.clos_crs(2, 3, 1, namespace=ns, node_ip=ip,
                             uid_base=0 if ns == "ta" else 100)
        members[name] = entry.build_daemon("cpu", capacity=64, crs=crs,
                                           tenancy=True, node_ip=ip)
    fed = entry.build_federation(members, str(tmp_path / "journal"))
    a, b = members["A"], members["B"]
    assert a["daemon"].federation is fed and b["daemon"].federation is fed
    assert fed.plane_names() == ["A", "B"]
    assert a["plane"].device.type == "cpu"
    t = 100.0
    for p in (a["plane"], b["plane"]):
        p.pipeline_explicit_clock = True
        p.tick(now_s=t)
    resp = a["daemon"].MigrateTenant(pb.MigrateRequest(
        tenant="ta", dst="B", reconcile_timeout_s=5.0), None)
    assert resp.ok, resp.error
    assert resp.migration.state == "done"
    assert b["tenancy"].rows_of("ta").size == 12
    assert a["engine"].num_active == 0
    m = entry.serve_metrics(a["daemon"], a["plane"], port=0)
    try:
        from prometheus_client import generate_latest

        body = generate_latest(m["registry"]).decode()
        assert "kubedtn_migration_completed_total 1.0" in body
        assert "kubedtn_migration_accounting_mismatch 0.0" in body
    finally:
        m["server"].stop()


# -- the journal's crash discipline ------------------------------------

def test_journal_torn_manifest_is_typed_and_a_resave_recovers(tmp_path):
    root = str(tmp_path)
    TM.journal.save_record(root, "m-1", {"step": 1},
                           arrays={"x": np.arange(4)})
    TM.journal.save_record(root, "m-1", {"step": 2})
    rec, arrays = TM.journal.load_record(root, "m-1")
    assert rec["step"] == 2
    np.testing.assert_array_equal(arrays["x"], np.arange(4))
    mpath = os.path.join(TM.journal.record_dir(root, "m-1"),
                         "manifest.json")
    with open(mpath, "w") as f:
        f.write("{ torn")
    with pytest.raises(TM.journal.JournalCorruptError):
        TM.journal.load_record(root, "m-1")
    TM.journal.save_record(root, "m-1", {"step": 3},
                           arrays={"x": np.arange(4)})
    assert TM.journal.load_record(root, "m-1")[0]["step"] == 3


def test_journal_torn_manifest_resolves_to_prev(tmp_path):
    """A torn current manifest beside an intact `.prev` (a crash that
    left both generations): the load resolves `.prev`."""
    root = str(tmp_path)
    TM.journal.save_record(root, "m-p", {"step": 1},
                           arrays={"x": np.arange(5)})
    d = TM.journal.record_dir(root, "m-p")
    shutil.copytree(d, d + ".prev")
    with open(os.path.join(d, "manifest.json"), "w") as f:
        f.write("{ torn")
    rec, arrays = TM.journal.load_record(root, "m-p")
    assert rec["step"] == 1
    np.testing.assert_array_equal(arrays["x"], np.arange(5))


def test_journal_mid_swap_crash_resolves_prev(tmp_path):
    root = str(tmp_path)
    TM.journal.save_record(root, "m-2", {"step": 1},
                           arrays={"x": np.arange(3)})
    d = TM.journal.record_dir(root, "m-2")
    os.rename(d, d + ".prev")
    rec, arrays = TM.journal.load_record(root, "m-2")
    assert rec["step"] == 1
    np.testing.assert_array_equal(arrays["x"], np.arange(3))
    assert "m-2" in TM.journal.list_records(root)


def test_journal_checksum_damage_is_typed(tmp_path):
    root = str(tmp_path)
    TM.journal.save_record(root, "m-3", {"step": 1},
                           arrays={"x": np.arange(64)})
    fpath = os.path.join(TM.journal.record_dir(root, "m-3"), "fork.npz")
    with open(fpath, "r+b") as f:
        f.seek(10)
        b = f.read(1)
        f.seek(10)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(TM.journal.JournalCorruptError):
        TM.journal.load_record(root, "m-3")


def test_journal_missing_is_typed(tmp_path):
    with pytest.raises(TM.journal.JournalMissingError):
        TM.journal.load_record(str(tmp_path), "nope")


def test_journal_sweeps_dead_pid_staging_and_spares_live(tmp_path):
    root = str(tmp_path)
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    dead = os.path.join(root, f".mig-tmp-m-4-{proc.pid}")
    live = os.path.join(root, f".mig-tmp-m-4-{os.getppid()}")
    other = os.path.join(root, f".mig-tmp-m-5-{proc.pid}")
    for d in (dead, live, other):
        os.makedirs(d)
    TM.journal.save_record(root, "m-4", {"step": 1})
    assert not os.path.exists(dead)
    assert os.path.isdir(live)
    assert os.path.isdir(other)     # another migration's staging
    assert TM.journal.list_records(root) == ["m-4"]


# -- RPCs and the collector --------------------------------------------

def test_migrate_rpcs_in_process():
    from kubedtn_tpu_torch.wire import proto as pb

    fed, (d_s, p_s, _r), (d_d, p_d, _r2), _root = H.federation(TM)
    h = H.Harness([(d_s, p_s), (d_d, p_d)],
                  {id(d_s): "bg", id(d_d): "bg2"})
    for _ in range(3):
        h.feed_mig(d_s)
        h.tick()
    # the tenant's in-flight drains first: the RPC has no settle hook
    for _ in range(20):
        h.tick()
    resp = d_s.MigrateTenant(pb.MigrateRequest(
        tenant="mig", dst="B", reconcile_timeout_s=5.0), None)
    assert resp.ok, resp.error
    m = resp.migration
    assert m.state == "done" and list(m.steps_done) == list(STEPS)
    assert m.src == "A" and m.dst == "B"
    st = d_s.MigrationStatus(pb.MigrationStatusRequest(), None)
    assert st.ok and len(st.migrations) == 1
    assert st.migrations[0] == m
    st = d_d.MigrationStatus(pb.MigrationStatusRequest(
        tenant="other"), None)
    assert st.ok and len(st.migrations) == 0
    resp = d_s.MigrateTenant(pb.MigrateRequest(tenant="bg", dst="nope"),
                             None)
    assert not resp.ok and "unknown federation plane" in resp.error
    resp = d_s.MigrateTenant(pb.MigrateRequest(
        resume=True, migration_id="nope"), None)
    assert not resp.ok and "JournalMissingError" in resp.error
    bare = TM.srv.Daemon(TM.eng.SimEngine(TM.st.TopologyStore(),
                                          capacity=8, device="cpu"))
    for rpc, req in (("MigrateTenant", pb.MigrateRequest(tenant="x",
                                                          dst="B")),
                     ("MigrationStatus", pb.MigrationStatusRequest())):
        resp = getattr(bare, rpc)(req, None)
        assert not resp.ok and "not enabled" in resp.error


def test_migration_metrics_collector_matches_jax():
    from prometheus_client import generate_latest

    from kubedtn_tpu.federation import MigrationStats as JStats
    from kubedtn_tpu.metrics.metrics import make_registry as jreg
    from kubedtn_tpu_torch.metrics.metrics import (MigrationStatsCollector,
                                                   make_registry)

    out = {}
    for pkg, cls, mk in (("jax", JStats, jreg),
                         ("torch", TM.fed.MigrationStats, make_registry)):
        stats = cls()
        stats.add(attempts=2, completed=1, rolled_back=1, resumed=3,
                  bytes_reconciled=1234.0)
        stats.add_step_seconds("fork", 0.5)
        stats.set_mismatch(2.0)
        stats.set_mismatch(0.0)
        reg, _h = mk(migration_stats=stats)
        out[pkg] = sorted(generate_latest(reg).decode().splitlines())
        if pkg == "torch":
            fams = {f.name: f for f in
                    MigrationStatsCollector(stats).collect()}
    assert out["torch"] == out["jax"]
    step = {s.labels["step"]: s.value
            for s in fams["kubedtn_migration_step_seconds"].samples}
    assert step["fork"] == 0.5 and step["release"] == 0.0
    assert "kubedtn_migration_accounting_mismatch 0.0" in out["torch"]


# -- against JAX (deterministic links) ----------------------------------

@pytest.fixture(scope="module")
def det_runs():
    """One clean migration per package on the TBF tenant, telemetry on
    (the reconcile record freezes the window slice)."""
    out = {}
    for pkg in ("jax", "torch"):
        m = H.fmods(pkg)
        rec, h, acct, stats, fed = H.run_migrated(
            m, depth=1, props=H.DET_PROPS, frame_bytes=1500,
            telemetry=True)
        record, arrays = m.journal.load_record(fed.journal_root,
                                               rec["migration_id"])
        out[pkg] = dict(m=m, rec=rec, h=h, acct=acct, stats=stats,
                        fed=fed, record=record, arrays=arrays)
    return out


def _no_wall(rec):
    return {k: v for k, v in rec.items() if k not in WALL_FIELDS}


def test_fork_record_and_arrays_match_jax(det_runs):
    j, t = det_runs["jax"], det_runs["torch"]
    fj, ft = j["record"]["fork"], t["record"]["fork"]
    for key in ("identities", "peers", "topologies", "wires", "registry",
                "counters_at_fork", "fork_shaped_s"):
        assert ft[key] == fj[key], key
    assert ft == fj
    assert sorted(t["arrays"]) == sorted(j["arrays"])
    for k, a in j["arrays"].items():
        b = t["arrays"][k]
        assert b.dtype == a.dtype and b.shape == a.shape, k
        assert np.array_equal(a, b), k
    # mid-bucket: the capture is not a rest state
    assert (t["arrays"]["tokens"] < 9e6 / 250.0).any()


def test_migrated_egress_and_accounting_match_jax(det_runs):
    j, t = det_runs["jax"], det_runs["torch"]
    assert t["h"].deliv == j["h"].deliv
    assert t["h"].ticks == j["h"].ticks
    assert t["acct"] == j["acct"]
    assert t["acct"]["mismatch"] == 0.0
    assert _no_wall(t["record"]) == _no_wall(j["record"])
    assert _no_wall(t["rec"]) == _no_wall(j["rec"])
    sj, st = j["stats"].snapshot(), t["stats"].snapshot()
    assert {k: v for k, v in st.items() if k != "step_seconds"} == \
        {k: v for k, v in sj.items() if k != "step_seconds"}


def test_observe_slo_serves_the_frozen_slice_like_jax(det_runs):
    """ObserveSLO on the plane the tenant left names the plane and
    appends the tenant's RECONCILE-frozen window slice (frozen=true),
    field for field JAX's answer; the plane it moved to serves it
    live."""
    from google.protobuf.json_format import MessageToDict

    from kubedtn_tpu.wire import proto as jpb
    from kubedtn_tpu_torch.wire import proto as tpb

    rows = {}
    for pkg, pb in (("jax", jpb), ("torch", tpb)):
        fed = det_runs[pkg]["fed"]
        resp = fed.handle("A").daemon.ObserveSLO(pb.ObserveSLORequest(),
                                                 None)
        assert resp.ok, resp.error
        assert resp.plane == "A"
        rows[pkg] = [MessageToDict(r, preserving_proto_field_name=True)
                     for r in resp.tenants]
        frozen = [r for r in resp.tenants if r.frozen]
        assert [r.tenant for r in frozen] == ["mig"]
        assert frozen[0].plane == "A"
        win = det_runs[pkg]["record"]["reconcile"]["window_src"]
        assert frozen[0].delivered == win["delivered"] > 0
        live = fed.handle("B").daemon.ObserveSLO(
            pb.ObserveSLORequest(tenant="mig"), None)
        assert live.ok and live.plane == "B"
        assert [(r.tenant, r.frozen) for r in live.tenants] == \
            [("mig", False)]
    assert rows["torch"] == rows["jax"]


def test_journal_reads_across_packages_both_ways(det_runs):
    """A JAX-written record loads in the port's load_record and a
    port-written one in JAX's; each equals its writer's own load."""
    for w, r in (("jax", "torch"), ("torch", "jax")):
        fed = det_runs[w]["fed"]
        mid = det_runs[w]["rec"]["migration_id"]
        rec_w, arr_w = det_runs[w]["m"].journal.load_record(
            fed.journal_root, mid)
        rec_r, arr_r = det_runs[r]["m"].journal.load_record(
            fed.journal_root, mid)
        assert rec_r == rec_w
        assert det_runs[r]["m"].journal.load_record_meta(
            fed.journal_root, mid) == rec_w
        assert sorted(arr_r) == sorted(arr_w)
        for k in arr_w:
            assert arr_r[k].dtype == arr_w[k].dtype
            assert np.array_equal(arr_r[k], arr_w[k])
    # and status() of each controller lists the other's record
    for w, r in (("jax", "torch"), ("torch", "jax")):
        root = det_runs[w]["fed"].journal_root
        got = det_runs[r]["m"].fed.FederationController(root).status()
        assert [_no_wall(x) for x in got] == \
            [_no_wall(det_runs[w]["record"])]


def test_journal_writes_jax_bytes(det_runs, tmp_path):
    """The same record and arrays committed by each package's journal:
    manifest.json is the same file, byte for byte."""
    rec, arrays = det_runs["torch"]["record"], det_runs["torch"]["arrays"]
    out = {}
    for pkg in ("jax", "torch"):
        root = str(tmp_path / pkg)
        det_runs[pkg]["m"].journal.save_record(root, "m-b", rec,
                                               arrays=arrays)
        with open(os.path.join(root, "m-b", "manifest.json"), "rb") as f:
            out[pkg] = f.read()
    assert out["torch"] == out["jax"]


def test_jax_record_committed_at_fork_resumes_on_the_port(tmp_path):
    """JAX's journal after a crash in RESTORE (THROTTLE and FORK
    committed) resumes to done on the port's planes, byte for byte the
    port's own clean run."""
    jm = H.fmods("jax")
    _r, _h, _a, _s, jfed = H.run_migrated(
        jm, depth=1, props=H.DET_PROPS, frame_bytes=1500,
        fail_step="restore", stop_after_fault=True)
    [jrec] = jfed.status(tenant="mig")
    assert jrec["steps_done"] == ["throttle", "fork"]
    mid = jrec["migration_id"]
    root = str(tmp_path / "journal")
    shutil.copytree(jm.journal.record_dir(jfed.journal_root, mid),
                    os.path.join(root, mid))

    ref = _ref(1, H.DET_PROPS, 1500)
    fed, (d_s, p_s, _rs), (d_d, p_d, _rd), _root = H.federation(
        TM, props=H.DET_PROPS, root=root)
    h = H.Harness([(d_s, p_s), (d_d, p_d)],
                  {id(d_s): "bg", id(d_d): "bg2"}, H.DET_PROPS, 1500)
    while h.k < H.GAP_START:
        h.feed_mig(d_s)
        h.tick()
    co = fed.coordinator(mid)
    co.settle = h.tick
    rec = co.resume()
    assert rec["state"] == "done" and rec["resumed"] == 1
    while h.k < H.GAP_END:
        h.tick()
    while h.k < H.T_TOTAL:
        h.feed_mig(d_d)
        h.tick()
    h.finish()
    _same_stream(h, ref, "resumed from JAX's record")
    assert co.check_accounting(h.fed)["mismatch"] == 0.0


def _adopt_engine(m, block: int):
    store = m.st.TopologyStore()
    kw = {"device": "cpu"} if m.pkg == "torch" else {}
    engine = m.eng.SimEngine(store, capacity=32, **kw)
    reg = m.ten.TenantRegistry(engine)
    reg.create("other")
    reg.create("mig", block_edges=block)
    return engine, reg


def test_adopt_and_abandon_rows_match_jax():
    """Row maps, peers, the registry and the props bits after adopting
    a slice into a tenant block (and past it), re-adopting it, and
    abandoning half of it, equal JAX's."""
    rng = np.random.default_rng(11)
    n_links = 10
    props = rng.random((2 * n_links, 13)).astype(np.float32)
    entries, peers = [], []
    for i in range(n_links):
        ka, kb = f"mig/a{i}", f"mig/b{i}"
        entries.append((ka, i + 1, ka, kb, props[2 * i], bool(i % 3)))
        entries.append((kb, i + 1, kb, ka, props[2 * i + 1], bool(i % 3)))
        peers.append(((ka, i + 1), (kb, i + 1)))
    out = {}
    for pkg in ("jax", "torch"):
        m = H.fmods(pkg)
        engine, reg = _adopt_engine(m, block=12)
        # a native neighbour first, so the free list is not pristine
        engine.adopt_rows([("other/x", 99, "other/x", "other/y",
                            props[0], True)])
        rows = engine.adopt_rows(entries, peers=peers)
        again = engine.adopt_rows(entries[:4], peers=peers[:2])
        st = engine.state
        snap1 = dict(
            rows=rows, again=again, map=dict(engine._rows),
            peer=dict(engine._peer), owner=dict(engine._row_owner),
            shaped=sorted(engine._shaped_rows),
            of=reg.rows_of("mig").tolist(), cfg=reg.export_config(),
            free=len(engine._free), reserved=reg.reserved_free(),
            props=np.asarray(st.props)[rows].copy(),
            uid=np.asarray(st.uid)[rows].copy(),
            active=np.asarray(st.active)[rows].copy(),
            keyid=engine._row_keyid[rows].copy(), adds=engine.stats.adds)
        freed = engine.abandon_rows([(k, u) for k, u, *_ in entries[::2]])
        freed_again = engine.abandon_rows([(entries[0][0], 1)])
        st = engine.state
        snap2 = dict(
            freed=freed, again=freed_again, map=dict(engine._rows),
            peer=dict(engine._peer), of=reg.rows_of("mig").tolist(),
            free=len(engine._free), reserved=reg.reserved_free(),
            active=np.asarray(st.active).copy(),
            keyid=engine._row_keyid.copy(), dels=engine.stats.dels)
        out[pkg] = (snap1, snap2)
    for a, b in zip(out["torch"], out["jax"]):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                assert np.array_equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k
    s1 = out["torch"][0]
    assert s1["again"] == s1["rows"][:4]
    assert s1["props"].view(np.uint32).tolist() == \
        props.view(np.uint32).tolist()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_shm_frames_parked_by_the_hold_strand_on_src_fault(pkg, tmp_path):
    """A fault of the JAX design, kept by the port: frames of the
    migrating tenant that an shm ring holds on src (admission parks them
    at the ring head while the tenant is held) are drained after RELEASE
    deregistered the tenant and deleted its wires, so they resolve to no
    wire and count as bulk_unresolved. The ring path's only append to a
    wire's ingress is the notifying one (it takes the cutover redirect),
    but nothing moves a ring's parked frames to dst."""
    import importlib

    m = H.fmods(pkg)
    root = "kubedtn_tpu_torch" if pkg == "torch" else "kubedtn_tpu"
    shm = importlib.import_module(f"{root}.shm")
    fed, (d_s, p_s, r_s), (d_d, p_d, _r), _root = H.federation(
        m, props=H.DET_PROPS)
    sender = shm.ShmSender(str(tmp_path / "mig.ring"), namespace="mig")
    ingest = shm.ShmIngest(str(tmp_path))
    ingest.attach_ring(shm.ShmRing.attach(sender.ring.path))
    d_s.shm = ingest
    p_s.attach_shm(ingest, watcher=False)
    h = H.Harness([(d_s, p_s), (d_d, p_d)],
                  {id(d_s): "bg", id(d_d): "bg2"}, H.DET_PROPS)
    w = H.wire(d_s, "mig", "a", 0, H.DET_PROPS)
    frames = [H.tagged("mig", 0, j) for j in range(40)]
    try:
        sender.send(w.wire_id, frames[:20])
        h.tick()
        r_s.hold("mig")
        sender.send(w.wire_id, frames[20:])
        h.tick()
        assert ingest.pending_total() == 20
        rec = fed.migrate("mig", "A", "B", settle=h.tick,
                          reconcile_timeout_s=5.0)
        assert rec["state"] == "done"
        h.finish()
    finally:
        sender.close()
        ingest.close()
        p_s.stop()
        p_d.stop()
    assert h.deliv[0] == frames[:20]
    assert ingest.pending_total() == 0
    assert d_s.bulk_unresolved == 20
    assert ingest.stats()["unresolved_frames"] == 20


# correlated loss keeps the tenant's rows on the sequential core, whose
# per-tick cap (seq_slots, 64) parks a burst's residue in the holdback;
# no latency, so a completed chunk leaves the delay line in its own tick
SEQ_PROPS = {"mig": dict(loss="10", loss_corr="25"),
             "bg": dict(latency="1ms"), "bg2": dict(latency="1ms")}


def _holdback_residue_migration(pkg, burst):
    """A depth-2 migration whose src holds a holdback residue of `burst`
    frames a wire at the fork: the held tenant's residue still shapes on
    src, one 64-frame chunk a tick. Returns (accounting, frames out of
    any egress, tenant frames in flight at the last residue check)."""
    m = H.fmods(pkg)
    fed, (d_s, p_s, _r_s), (d_d, p_d, _r_d), _root = H.federation(
        m, depth=2, props=SEQ_PROPS)
    h = H.Harness([(d_s, p_s), (d_d, p_d)],
                  {id(d_s): "bg", id(d_d): "bg2"}, SEQ_PROPS)
    for _ in range(3):
        h.feed_mig(d_s)
        h.tick()
    for i in range(H.PAIRS):
        H.wire(d_s, "mig", "a", i, SEQ_PROPS).ingress.extend(
            H.tagged("mig", i, 1000 + j) for j in range(burst))
    h.fed += burst * H.PAIRS
    h.tick()
    assert p_s._holdback, "no holdback residue at the fork"
    real = m.fed.MigrationCoordinator._src_residue
    last = []

    def residue(co, *a):
        out = real(co, *a)
        last[:] = [sum(len(it[2]) for job in p_s._inflight
                       for it in job.batches
                       if it[0].pod_key.startswith("mig/"))]
        return out

    m.fed.MigrationCoordinator._src_residue = residue
    try:
        # a bound on the wall clock, not on the settle ticks: each check
        # ticks once, and JAX compiles its first ticks of a shape
        rec = fed.migrate("mig", "A", "B", settle=h.tick,
                          reconcile_timeout_s=120.0)
    finally:
        m.fed.MigrationCoordinator._src_residue = real
    h.finish()
    acct = fed.coordinator(rec["migration_id"]).check_accounting(h.fed)
    return acct, sum(len(d) for d in h.deliv), last[0]


@pytest.mark.parametrize("burst", [150, 200, 300])
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_inflight_holdback_residue_at_reconcile_fault(pkg, burst):
    """A fault of the JAX design: RECONCILE's residue check counts the
    holdback and the delay line but not the dispatches in flight. At
    depth 2 the last chunk of a held tenant's holdback residue (a burst
    of more than seq_slots frames a wire on correlated-loss rows) is in
    flight when both are empty, the check passes, the src counters
    freeze without it, and its frames complete after the freeze and
    never come out (the src wires are gone at RELEASE): in the JAX
    package the mismatch is exactly the in-flight frames. The port
    counts them and waits (migrate._src_residue): mismatch 0, every
    frame accounted and out of an egress wire."""
    acct, out, inflight = _holdback_residue_migration(pkg, burst)
    if pkg == "jax":
        assert inflight > 0
        assert acct["mismatch"] == inflight
        assert out == acct["delivered_src"]
        assert acct["fed"] == (acct["accounted_src"] + acct["accounted_dst"]
                               + inflight)
    else:
        assert inflight == 0
        assert acct["mismatch"] == 0.0
        assert acct["fed"] == acct["accounted_src"] + acct["accounted_dst"]
        assert out == acct["delivered_src"] + acct["delivered_dst"]


def _migrated_then_dst_grows(pkg):
    """mig moved A -> B in its feed gap, fed on B, then a tenant whose
    reserved block B's free rows cannot hold grows B's engine, and mig
    is fed on. Returns (accounting, B's delivered count of mig just
    before the growth, B's capacity before and after, B's per-row
    delivered counts of mig at the end)."""
    m = H.fmods(pkg)
    fed, (d_s, p_s, _r_s), (d_d, p_d, r_d), _root = H.federation(
        m, props=H.DET_PROPS)
    h = H.Harness([(d_s, p_s), (d_d, p_d)],
                  {id(d_s): "bg", id(d_d): "bg2"}, H.DET_PROPS)
    while h.k < H.GAP_START:
        h.feed_mig(d_s)
        h.tick()
    rec = fed.migrate("mig", "A", "B", settle=h.tick,
                      reconcile_timeout_s=120.0)
    while h.k < H.GAP_END:
        h.tick()
    for _ in range(10):
        h.feed_mig(d_d)
        h.tick()
    for _ in range(10):
        h.tick()
    before = r_d.tenant_counters(p_d, "mig")["delivered_packets"]
    cap0 = d_d.engine.state.capacity
    r_d.create("big", block_edges=cap0)
    while h.k < H.T_TOTAL:
        h.feed_mig(d_d)
        h.tick()
    h.finish()
    acct = fed.coordinator(rec["migration_id"]).check_accounting(h.fed)
    rx = np.asarray(p_d.counters.rx_packets)[r_d.rows_of("mig")]
    return acct, before, (cap0, d_d.engine.state.capacity), rx


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_engine_growth_resets_plane_counters_fault(pkg):
    """A fault of the JAX design: when the engine grows, the plane's next
    dispatch replaces its cumulative per-row counters with zeros. A
    tenant migrated onto a plane that later grows (a RESTORE of a
    tenant whose reserved block needs a contiguous run) loses every
    delivery counted there, so the failover and migration accounting
    read short by exactly those frames. The port keeps each row's
    counts (runtime._grown_counters)."""
    acct, before, (cap0, cap1), rx = _migrated_then_dst_grows(pkg)
    assert cap1 > cap0 and before > 0
    assert rx.sum() == acct["delivered_dst"]
    if pkg == "jax":
        assert acct["mismatch"] == before
    else:
        assert acct["mismatch"] == 0.0
        assert acct["fed"] == acct["accounted_src"] + acct["accounted_dst"]


# -- the live scenario -------------------------------------------------

@pytest.mark.chaos
def test_migration_under_flap_smoke():
    """Two real gRPC daemons on the CPU, the src->dst breaker cycling:
    the migration completes (or rolls back) with no frame lost, the
    accounting mismatch 0 and the window rings agreeing with the
    counters."""
    from kubedtn_tpu_torch.scenarios import migration_under_flap

    r = migration_under_flap(pairs=2, seconds=3.0, migrate_after_s=0.8,
                             offered_frames_per_s=2_000, device="cpu")
    assert r["device"] == "cpu"
    assert r["frames_lost"] == 0
    assert r["tick_errors"] == 0
    assert r["outcome"] in ("completed", "rolled_back")
    assert r["accounting_mismatch_gauge"] == 0.0
    if r["outcome"] == "completed":
        assert r["accounting"]["mismatch"] == 0.0
        assert r["ring_totals_agree"]
        assert r["steps_done"] == list(STEPS)
    assert r["in_guardrails"], r
