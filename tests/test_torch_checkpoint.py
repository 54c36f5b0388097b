"""Port parity: kubedtn_tpu_torch.checkpoint (and the plane's delay-line
export/restore, the twin's snapshot files, entry.restore_daemon) against
kubedtn_tpu.checkpoint, on the CPU.

The two packages share one on-disk format: a checkpoint (or a snapshot
file) written by either is read by the other, registries equal and every
EdgeState column equal bit for bit, and the pending frames, queued
ingress, wires and plane counters equal. On deterministic links (the
plane tests' DET_PROPS: latency, TBF rate, latency_corr without jitter)
the two packages' planes export the same pending frames for the same
feed, and a daemon restored from a checkpoint taken mid-run resumes byte
for byte against the uninterrupted daemon. The crash-consistency
contracts of tests/test_checkpoint.py are held again for the port.

Every tick runs on an explicit clock; only the kill -9 loop and the
Autosaver wait on wall time, each under a bound.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import kubedtn_tpu.checkpoint as jck
import kubedtn_tpu.twin.snapshot as jsnap
import kubedtn_tpu_torch.checkpoint as tck
import kubedtn_tpu_torch.twin.snapshot as tsnap
from kubedtn_tpu_torch import entry
from kubedtn_tpu_torch.chaos import ChaosInjector
from kubedtn_tpu_torch.ops import edge_state as tes
from kubedtn_tpu_torch.sim import init_sim

import test_torch_plane as tp
from _torch_native_guard import ensure_jax_native

CK = {"jax": jck, "torch": tck}
LOAD_KW = {"jax": {}, "torch": {"device": "cpu"}}
DIRECTIONS = [("torch", "jax"), ("jax", "torch")]
FEED_TICKS = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def edge_cols(engine) -> dict:
    st = engine.state
    return {f.name: host(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def registries(engine) -> dict:
    return {"rows": dict(engine._rows), "peer": dict(engine._peer),
            "pod_ids": dict(engine._pod_ids),
            "pod_names": dict(engine._pod_names),
            "row_owner": dict(engine._row_owner),
            "alive": set(engine._topology_manager),
            "free": list(engine._free.tolist()),
            "shaped": set(engine._shaped_rows),
            "keyid": engine._row_keyid.tolist(),
            "node_ip": engine.node_ip,
            "capacity": int(engine.state.capacity)}


def store_view(store) -> list:
    return sorted((t.key, t.resource_version, tuple(t.finalizers),
                   json.dumps(t.to_manifest(), sort_keys=True))
                  for t in store.list())


def wire_view(daemon) -> set:
    return {(w.pod_key, int(w.uid), w.peer_ip, int(w.peer_intf_id),
             w.node_iface_name) for w in daemon.wires.all()}


def feed(sc, t, rng, counts=tp.DET_COUNTS):
    for k, w in enumerate(sc.win):
        w.ingress.extend(tp.frames_for(k, t, counts[k], rng))


def dirty(sc, seed: int) -> None:
    """Random mutable shaping state, counters and pending frames on a
    built cluster (no tick: nothing compiles), so a checkpoint carries
    every column's bits."""
    rng = np.random.default_rng(seed)
    st = sc.engine.state
    E = st.capacity
    new = {"tokens": rng.random(E, np.float32) * 5e4,
           "t_last": rng.random(E, np.float32) * 1e4 - 5e3,
           "backlog_until": rng.random(E, np.float32) * 2e4,
           "corr": rng.random((E, tes.NCORR), np.float32),
           "pkt_count": rng.integers(0, 1000, E).astype(np.int32)}
    if isinstance(st.uid, torch.Tensor):
        for k, v in new.items():
            getattr(st, k).copy_(torch.as_tensor(v))
    else:
        import jax.numpy as jnp

        sc.engine.state = dataclasses.replace(
            st, **{k: jnp.asarray(v) for k, v in new.items()})
    cnt = sc.plane.counters
    cols = {f.name: rng.integers(0, 500, E).astype(np.float32)
            for f in dataclasses.fields(type(cnt))}
    if not isinstance(cnt.tx_packets, np.ndarray):  # the JAX plane's
        import jax.numpy as jnp

        cols = {k: jnp.asarray(v) for k, v in cols.items()}
    sc.plane.counters = type(cnt)(**cols)
    entries = [(w.pod_key, int(w.uid), bytes([i % 251]) * (40 + i),
                float(rng.random() * 9e4))
               for i, w in enumerate(sc.wout * 3)]
    sc.plane.restore_pending(entries, now_s=0.0)
    for k, w in enumerate(sc.win):
        w.ingress.extend([bytes([k, j]) * 30 for j in range(k + 1)])


def built_pair(pkg, seed=3):
    """DET_PROPS's cluster in `pkg` (tp.build guards and asserts the JAX
    plane's wheel), its state dirtied."""
    sc = tp.build(pkg, tp.DET_PROPS)
    dirty(sc, seed)
    return sc


# -- the format crosses the packages ---------------------------------------

@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_checkpoint_crosses_packages(tmp_path, src, dst):
    sc = built_pair(src)
    path = str(tmp_path / "ckpt")
    want_pending = sc.plane.export_pending()
    CK[src].save(path, sc.store, sc.engine, dataplane=sc.plane)

    store2, engine2 = CK[dst].load(path, **LOAD_KW[dst])
    assert registries(engine2) == registries(sc.engine)
    assert store_view(store2) == store_view(sc.store)
    a, b = edge_cols(sc.engine), edge_cols(engine2)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)

    assert CK[dst].read_pending_entries(path) == want_pending
    want_in = [(w.pod_key, int(w.uid), f) for w in sc.daemon.wires.all()
               for f in w.ingress]
    assert CK[dst].read_ingress_entries(path) == want_in
    got_c = CK[dst].load_plane_counters(path)
    for f in dataclasses.fields(type(sc.plane.counters)):
        np.testing.assert_array_equal(
            got_c[f.name], host(getattr(sc.plane.counters, f.name)))
    sc2 = tp.build(dst, [])
    assert CK[dst].load_wires(path, sc2.daemon) == len(wire_view(sc.daemon))
    assert wire_view(sc2.daemon) == wire_view(sc.daemon)
    meta = {"last_shaped_s": None, "has_counters": True}
    if src == "torch":  # the port adds the wheel's origin
        meta["origin_s"] = 0.0
    assert CK[dst].plane_meta(path) == meta


def sim_flat(seed: int, E: int = 32, q: int = 8) -> dict:
    """A SimState's '<field>.<leaf>' arrays (edges inlined), every leaf
    drawn at random in its own dtype."""
    rng = np.random.default_rng(seed)
    sim = init_sim(tes.init_state(E, "cpu"), q=q)
    flat = tck.flatten_sim_arrays(sim, include_edges=True)
    for k, a in flat.items():
        if a.dtype == np.bool_:
            flat[k] = rng.random(a.shape) < 0.5
        elif np.issubdtype(a.dtype, np.integer):
            flat[k] = rng.integers(-5, 1000, a.shape).astype(a.dtype)
        else:
            flat[k] = (rng.random(a.shape) * 1e4).astype(a.dtype)
    return flat


def same_flat(got: dict, want: dict, skip_edges: bool = False) -> None:
    keys = {k for k in want if not (skip_edges and k.startswith("edges."))}
    assert set(got) == keys
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def small_cluster(pkg):
    sc = tp.build(pkg, tp.DET_PROPS[:1])
    return sc.store, sc.engine


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_sim_state_crosses_packages(tmp_path, src, dst):
    """SimState through sim_state.npz both ways (flatten_sim_arrays's
    '<field>.<leaf>' layout): every leaf equal, dtype included."""
    flat = sim_flat(7)
    sim = CK[src].unflatten_sim_arrays(flat, **LOAD_KW[src])
    store, engine = small_cluster(src)
    path = str(tmp_path / "ckpt")
    CK[src].save(path, store, engine, sim=sim)
    _s, engine2 = CK[dst].load(path, **LOAD_KW[dst])
    sim2 = CK[dst].load_sim(path, engine2, **LOAD_KW[dst])
    same_flat(CK[dst].flatten_sim_arrays(sim2), flat, skip_edges=True)


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_snapshot_files_cross_packages(tmp_path, src, dst):
    """The twin's save_snapshot / load_snapshot both ways, edges
    inlined; load_snapshot puts the port's snapshot on `device`."""
    flat = sim_flat(8)
    mod = {"jax": jsnap, "torch": tsnap}
    sim = CK[src].unflatten_sim_arrays(flat, **LOAD_KW[src])
    snap = mod[src].TwinSnapshot(sim=sim, router=None, n_nodes=17,
                                 captured_at_s=0.0, source="sim")
    path = str(tmp_path / "snap" / "s.npz")
    mod[src].save_snapshot(path, snap)
    got = mod[dst].load_snapshot(path, **LOAD_KW[dst])
    assert got.n_nodes == 17 and got.source == "sim"
    same_flat(CK[dst].flatten_sim_arrays(got.sim, include_edges=True), flat)
    if dst == "torch":
        assert got.sim.edges.uid.device.type == "cpu"


def _tenant_view(engine, reg) -> dict:
    return {"config": reg.export_config(),
            "blocks": {t.name: (t.block, list(t.block_free), t.block_rows)
                       for t in reg.list()},
            "rows_of": {t.name: reg.rows_of(t.name).tolist()
                        for t in reg.list()},
            "free": engine._free.tolist(),
            "reserved": reg.reserved_free()}


def _break_tenancy(path: str) -> None:
    """Rewrite the manifest's tenancy section with a tenant that has no
    name (the data files and their checksums stay valid)."""
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["tenancy"]["tenants"].append({"qos": "gold"})
    with open(mpath, "w") as f:
        json.dump(manifest, f)


def test_tenancy_section_restores_rows_refuses_quotas(tmp_path):
    """A JAX checkpoint with a tenancy section: the port's load restores
    store and engine with the reserved rows in the global pool (the JAX
    package's tenancy-less load), and the port's load_tenancy rebuilds
    the registry JAX's load_tenancy rebuilds (quotas, namespaces,
    meters, the re-carved block and the free list after it); a malformed
    section is refused with CheckpointError instead of dropped; without
    the section it is None."""
    from kubedtn_tpu.tenancy import TenantRegistry

    ensure_jax_native()
    store, engine = small_cluster("jax")
    reg = TenantRegistry(engine)
    reg.create("t1", block_edges=8, namespaces=["default"],
               frame_budget_per_s=1000)
    reg.get("t1").admitted_frames = 17
    path = str(tmp_path / "ckpt")
    jck.save(path, store, engine)
    _s, e_jax = jck.load(path)   # the JAX package's tenancy-less load
    _s, e2 = tck.load(path, device="cpu")
    assert sorted(e2._free.tolist()) == sorted(e_jax._free.tolist())
    assert e2._rows == engine._rows
    assert len(e2._free) + e2.num_active == e2.state.capacity
    want = _tenant_view(e_jax, jck.load_tenancy(path, e_jax))
    got = _tenant_view(e2, tck.load_tenancy(path, e2))
    assert got == want
    assert got["config"] == reg.export_config()
    _break_tenancy(path)
    with pytest.raises(tck.CheckpointError, match="tenancy"):
        tck.load_tenancy(path, tck.load(path, device="cpu")[1])
    store3, engine3 = small_cluster("torch")
    tck.save(str(tmp_path / "plain"), store3, engine3)
    assert tck.load_tenancy(str(tmp_path / "plain"), engine3) is None
    assert tck.load_tenancy(str(tmp_path / "absent"), engine3) is None
    with open(os.path.join(str(tmp_path / "plain"), "manifest.json")) as f:
        assert "tenancy" not in json.load(f)


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_tenancy_section_crosses_packages(tmp_path, src, dst):
    """A registry with a block, a quota-only tenant on a second
    namespace and admitted meters, saved by one package: the section
    (and the blocks' unused rows appended to the saved free list) equal
    in both packages' manifests, and the other package's load_tenancy
    rebuilds what the writer's own load_tenancy rebuilds."""
    ten = {"jax": "kubedtn_tpu.tenancy", "torch": "kubedtn_tpu_torch.tenancy"}
    import importlib

    views, manifests = {}, {}
    for pkg in ("jax", "torch"):
        store, engine = small_cluster(pkg)
        reg = importlib.import_module(ten[pkg]).TenantRegistry(engine)
        reg.create("t1", block_edges=6, namespaces=["default"],
                   qos="silver", byte_budget_per_s=5e4)
        reg.create("t2", namespaces=["other"], frame_budget_per_s=300.0)
        reg.get("t1").admitted_bytes = 1234
        path = str(tmp_path / pkg)
        CK[pkg].save(path, store, engine)
        with open(os.path.join(path, "manifest.json")) as f:
            m = json.load(f)
        manifests[pkg] = (m["tenancy"], m["engine"]["free"])
    assert manifests["torch"] == manifests["jax"]
    path = str(tmp_path / src)
    for pkg in (src, dst):
        _s, e = CK[pkg].load(path, **LOAD_KW[pkg])
        views[pkg] = _tenant_view(e, CK[pkg].load_tenancy(path, e))
    assert views[dst] == views[src]
    assert views[dst]["blocks"]["t1"][2] == 6



def test_restore_daemon_restores_the_registry(tmp_path):
    """entry.restore_daemon brings the checkpoint's registry back,
    attached to the engine, the daemon and the plane (Health counts its
    tenants, the drain enforces it); a malformed tenancy section makes
    the restore raise rather than drop it; a checkpoint without a
    section restores no registry."""
    from kubedtn_tpu_torch.tenancy import TenantRegistry

    sc = tp.build("torch", tp.DET_PROPS)
    reg = TenantRegistry(sc.engine)
    sc.plane.attach_tenancy(reg)
    reg.create("default", qos="bronze", frame_budget_per_s=500.0)
    reg.create("spare", block_edges=5, namespaces=["spare"])
    rng = np.random.default_rng(3)
    for t in range(2):
        feed(sc, t, rng)
        sc.plane.tick(now_s=(t + 1) * tp.DT)
    path = str(tmp_path / "ckpt")
    tck.save_live(path, sc.store, sc.engine, sc.plane)
    want = _tenant_view(sc.engine, reg)
    r = entry.restore_daemon(path, device="cpu", capacity=64,
                             now_s=2 * tp.DT)
    got = r["tenancy"]
    assert got is not None and r["engine"].tenancy is got
    assert r["daemon"].tenancy is got and r["plane"].tenancy is got
    view = _tenant_view(r["engine"], got)
    assert view["config"] == want["config"]
    assert view["rows_of"] == want["rows_of"]
    assert view["blocks"]["spare"][2] == 5
    assert r["daemon"].health_snapshot()["tenants"] == 2
    assert got.get("default").admitted_frames > 0
    _break_tenancy(path)
    with pytest.raises(tck.CheckpointError, match="tenancy"):
        entry.restore_daemon(path, device="cpu", capacity=64)
    plain = str(tmp_path / "plain")
    sc2 = tp.build("torch", tp.DET_PROPS[:1])
    tck.save(plain, sc2.store, sc2.engine)
    r3 = entry.restore_daemon(plain, device="cpu", capacity=64)
    assert r3["tenancy"] is None and r3["plane"].tenancy is None
    assert r3["engine"].tenancy is None


# -- the delay line ---------------------------------------------------------

def test_export_pending_equals_jax_on_the_same_feed():
    """Both packages' planes, fed the same frames on deterministic
    links, hold the same frames with the same remaining delays."""
    got = {}
    for pkg in ("jax", "torch"):
        sc = tp.build(pkg, tp.DET_PROPS)
        rng = np.random.default_rng(5)
        for t in range(FEED_TICKS):
            feed(sc, t, rng)
            sc.plane.tick(now_s=(t + 1) * tp.DT)
        got[pkg] = sc.plane.export_pending()
    assert len(got["torch"]) > 100
    assert sorted(got["torch"]) == sorted(got["jax"])


@pytest.mark.parametrize("dst", ["torch", "jax"])
def test_pending_frames_survive_daemon_restart(tmp_path, dst):
    """The counterpart of tests/test_checkpoint.py's restart test: a
    port checkpoint's frame completes its REMAINING delay on a restored
    port plane and on a restored JAX plane."""
    src = tp.build("torch", [dict(latency="500ms")])
    frame = b"\xee" * 77
    src.daemon._frame_in(src.win[0], frame)
    src.plane.tick(now_s=0.0)       # shaped: 500 ms of delay scheduled
    src.plane.tick(now_s=0.2)       # 200 ms elapsed, 300 ms remain
    assert len(src.wout[0].egress) == 0
    path = str(tmp_path / "ckpt")
    tck.save(path, src.store, src.engine, dataplane=src.plane)
    (_pk, _uid, got, rem), = src.plane.export_pending()
    assert got == frame and rem == pytest.approx(300_000.0, abs=11_000)

    sc = tp.build(dst, [dict(latency="500ms")])
    assert CK[dst].load_pending(path, sc.plane, now_s=100.0) == 1
    sc.plane.tick(now_s=100.2)      # still held (~300 ms remained)
    assert len(sc.wout[0].egress) == 0
    sc.plane.tick(now_s=100.35)     # past the remaining delay
    assert list(sc.wout[0].egress) == [frame]


@pytest.mark.parametrize("clock", ["explicit", "monotonic"])
def test_restore_pending_mixed_clock_guards(clock):
    """An explicit-clock plane refuses a restore without now_s; a
    monotonic plane refuses a synthetic now_s. Each accepts its own."""
    sc = tp.build("torch", [])
    plane = sc.plane
    entry_ = [("default/a", 1, b"\x00" * 32, 1_000.0)]
    if clock == "explicit":
        plane.tick(now_s=5.0)
        with pytest.raises(ValueError, match="explicit clock"):
            plane.restore_pending(entry_)
        assert plane.restore_pending(entry_, now_s=5.1) == 1
    else:
        plane.tick()
        with pytest.raises(ValueError, match="monotonic"):
            plane.restore_pending(entry_, now_s=100.0)
        assert plane.restore_pending(entry_, now_s=time.monotonic()) == 1
    # both attempts ran under the tick lock and the pause ledger, the
    # refused one included (its pause is recorded as it unwinds)
    assert plane.pauses.snapshot()["causes"]["checkpoint_load"]["count"] \
        == 2


def test_partial_release_keeps_export_slots(tmp_path):
    """A batch released in part (TBF spacing on a 1 Mbit link) exports
    only its frames still in flight, each with its own deadline."""
    sc = tp.build("torch", [dict(rate="1Mbit")])
    # 1000 B frames: the 5,000 B burst passes 5, the rest leave 8 ms
    # apart until the 50 ms queue overflows
    frames = [bytes([9, j]) * 500 for j in range(14)]
    sc.win[0].ingress.extend(frames)
    sc.plane.tick(now_s=0.01)
    sc.plane.tick(now_s=0.02)
    out = list(sc.wout[0].egress)
    ex = sc.plane.export_pending()
    assert 0 < len(out) < len(frames) - 1
    assert out == frames[:len(out)]               # FIFO on the TBF row
    assert [e[2] for e in ex] == frames[len(out):len(out) + len(ex)]
    rem = [e[3] for e in ex]
    assert rem == sorted(rem) and rem[0] > 0


# -- the directory's crash consistency -------------------------------------

def test_atomic_layout_and_resave(tmp_path):
    store, engine = small_cluster("torch")
    path = str(tmp_path / "ckpt")
    tck.save(path, store, engine)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format_version"] == tck.FORMAT_VERSION == \
        jck.FORMAT_VERSION
    assert "edge_state.npz" in manifest["checksums"]
    assert [d for d in os.listdir(tmp_path)
            if d.startswith(".ckpt-tmp-") or d.endswith(".prev")] == []
    tck.save(path, store, engine)
    _s, e2 = tck.load(path, device="cpu")
    assert e2._rows == engine._rows


def test_missing_is_not_corrupt(tmp_path):
    """A fresh start raises the MISSING subtype and the readers report
    nothing to restore; a newer format raises the base error."""
    path = str(tmp_path / "never-written")
    with pytest.raises(tck.CheckpointMissingError):
        tck.load(path, device="cpu")
    store, engine = small_cluster("torch")
    sc = tp.build("torch", [])
    assert tck.load_pending(path, sc.plane) == 0
    assert tck.load_sim(path, engine, device="cpu") is None
    assert tck.load_wires(path, sc.daemon) == 0
    assert tck.load_plane_counters(path) is None
    assert tck.plane_meta(path) == {}
    tck.save(path, store, engine)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["format_version"] = tck.FORMAT_VERSION + 1
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    for fn in (lambda: tck.load(path, device="cpu"),
               lambda: tck.load_pending(path, sc.plane)):
        with pytest.raises(tck.CheckpointError, match="unsupported"):
            fn()


def test_refuses_a_non_checkpoint_dir_replaces_debris(tmp_path):
    store, engine = small_cluster("torch")
    precious = str(tmp_path / "precious")
    os.makedirs(precious)
    with open(os.path.join(precious, "notes.txt"), "w") as f:
        f.write("not a checkpoint")
    with pytest.raises(tck.CheckpointError, match="refusing"):
        tck.save(precious, store, engine)
    path = str(tmp_path / "ckpt")
    tck.save(path, store, engine)
    os.remove(os.path.join(path, "manifest.json"))
    with pytest.raises(tck.CheckpointCorruptError, match="no manifest"):
        tck.load(path, device="cpu")
    tck.save(path, store, engine)  # debris replaced, not refused
    tck.load(path, device="cpu")


def test_save_sweeps_leaked_staging_dirs(tmp_path):
    store, engine = small_cluster("torch")
    path = str(tmp_path / "ckpt")
    proc = subprocess.Popen([sys.executable, "-c", ""])
    proc.wait()  # a pid guaranteed dead
    leaked = str(tmp_path / f".ckpt-tmp-ckpt-{proc.pid}")
    os.makedirs(leaked)
    with open(os.path.join(leaked, "edge_state.npz"), "w") as f:
        f.write("junk from a crashed save")
    sibling = str(tmp_path / f".ckpt-tmp-ckpt-b-{proc.pid}")
    os.makedirs(sibling)
    live = str(tmp_path / f".ckpt-tmp-ckpt-{os.getppid()}")
    os.makedirs(live)
    tck.save(path, store, engine)
    assert not os.path.exists(leaked)
    assert os.path.exists(sibling) and os.path.exists(live)
    tck.load(path, device="cpu")


def _truncate_manifest(path):
    with open(os.path.join(path, "manifest.json"), "r+b") as f:
        f.truncate(25)


def _truncate_edges(path):
    ChaosInjector(seed=1).truncate_file(os.path.join(path,
                                                     "edge_state.npz"))


def _flip_edges(path):
    ChaosInjector(seed=2).corrupt_file(os.path.join(path, "edge_state.npz"),
                                       n_bytes=1)


def _truncate_pending(path):
    ChaosInjector(seed=3).truncate_file(
        os.path.join(path, "pending_frames.npz"), keep_fraction=1 / 3)


@pytest.mark.parametrize("damage,reader,match", [
    (_truncate_manifest, "load", "manifest"),
    (_truncate_edges, "load", "edge_state"),
    (_flip_edges, "load", "checksum mismatch"),
    (_truncate_pending, "load_pending", "pending_frames")])
def test_damage_raises_typed_errors(tmp_path, damage, reader, match):
    """Truncated manifest / npz and a flipped byte are typed
    CheckpointCorruptErrors, never a silent partial restore."""
    sc = tp.build("torch", tp.DET_PROPS[:1])
    sc.plane.restore_pending([("default/b0", 1, b"\xbb" * 64, 40_000.0)],
                             now_s=0.0)
    path = str(tmp_path / "ckpt")
    tck.save(path, sc.store, sc.engine, dataplane=sc.plane)
    damage(path)
    plane2 = tp.build("torch", []).plane
    read = {"load": lambda: tck.load(path, device="cpu"),
            "load_pending": lambda: tck.load_pending(path, plane2,
                                                     now_s=1.0)}[reader]
    with pytest.raises(tck.CheckpointCorruptError, match=match):
        read()


def test_load_or_rebuild_falls_back_and_logs(tmp_path, caplog):
    store, engine = small_cluster("torch")
    path = str(tmp_path / "ckpt")
    tck.save(path, store, engine)
    assert tck.load_or_rebuild(path, store, device="cpu")[2] == \
        "checkpoint"
    _truncate_edges(path)
    with caplog.at_level("WARNING"):
        _s, e2, src = tck.load_or_rebuild(path, store, capacity=64,
                                          device="cpu")
    assert src == "rebuild"
    assert "CheckpointCorruptError" in caplog.text
    assert e2.link_row("default/a0", 1)["latency_us"] == 10_000.0
    with pytest.raises(tck.CheckpointError):
        tck.load_or_rebuild(path, device="cpu")


def test_crash_between_renames_restores_previous_generation(tmp_path):
    sc = tp.build("torch", tp.DET_PROPS[:1])
    sc.plane.restore_pending([("default/b0", 1, b"\xaa" * 40, 80_000.0)],
                             now_s=0.0)
    path = str(tmp_path / "ckpt")
    tck.save(path, sc.store, sc.engine, dataplane=sc.plane)
    os.rename(path, path + ".prev")  # the window between the renames
    _s, e2 = tck.load(path, device="cpu")
    assert e2._rows == sc.engine._rows
    plane2 = tp.build("torch", []).plane
    assert tck.load_pending(path, plane2, now_s=100.0) == 1
    assert len(plane2.export_pending()) == 1
    tck.save(path, sc.store, sc.engine)
    assert not os.path.exists(path + ".prev")


def test_resave_without_sim_drops_stale_sim_state(tmp_path):
    store, engine = small_cluster("torch")
    sim = tck.unflatten_sim_arrays(sim_flat(9), device="cpu")
    path = str(tmp_path / "ckpt")
    tck.save(path, store, engine, sim=sim)
    _s, e2 = tck.load(path, device="cpu")
    assert tck.load_sim(path, e2, device="cpu") is not None
    tck.save(path, store, engine)
    assert not os.path.exists(os.path.join(path, "sim_state.npz"))
    _s, e3 = tck.load(path, device="cpu")
    assert tck.load_sim(path, e3, device="cpu") is None


KILL_SRC = """
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import test_torch_plane as tp
from kubedtn_tpu_torch import checkpoint
sc = tp.build("torch", tp.DET_PROPS[:1])
print("READY", flush=True)
while True:
    checkpoint.save({path!r}, sc.store, sc.engine)
"""


def test_kill9_mid_save_never_yields_torn_state(tmp_path):
    """A subprocess saves in a tight loop and is killed -9 at an
    arbitrary instant: load either returns a complete generation or
    raises the typed error, and load_or_rebuild always gives a working
    engine."""
    path = str(tmp_path / "ckpt")
    src = KILL_SRC.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                          path=path)
    store, _engine = small_cluster("torch")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for delay_s in (0.2, 0.5):
        proc = subprocess.Popen([sys.executable, "-c", src], env=env,
                                stdout=subprocess.PIPE, text=True)
        try:
            line = [None]
            t = threading.Thread(
                target=lambda: line.__setitem__(0, proc.stdout.readline()))
            t.start()
            t.join(timeout=60)
            assert (line[0] or "").strip() == "READY"
            time.sleep(delay_s)  # several saves deep, mid-save likely
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=10)
        _s, e2, _src = tck.load_or_rebuild(path, store, capacity=64,
                                           device="cpu")
        assert e2.link_row("default/a0", 1)["latency_us"] == 10_000.0
        try:
            _s3, e3 = tck.load(path, device="cpu")
        except tck.CheckpointError:
            pass
        else:
            assert e3.link_row("default/a0", 1) is not None


def test_autosaver_start_stop(tmp_path):
    """The Autosaver saves at its interval through save_live (cause
    checkpoint_save on the plane's ledger), and stop() joins its
    thread."""
    sc = tp.build("torch", tp.DET_PROPS[:1])
    path = str(tmp_path / "ckpt")
    saver = tck.Autosaver(path, sc.store, sc.engine, sc.plane,
                          interval_s=0.02)
    saver.start()
    deadline = time.monotonic() + 30.0
    while saver.saves < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    thread = saver._thread
    saver.stop()
    assert saver.saves >= 2 and saver.errors == 0
    assert not thread.is_alive() and saver._thread is None
    assert sc.plane.pauses.snapshot()["causes"]["checkpoint_save"][
        "count"] >= 2
    _s, e2 = tck.load(path, device="cpu")
    assert e2._rows == sc.engine._rows


# -- restart end to end -----------------------------------------------------

def test_restore_daemon_resumes_byte_for_byte(tmp_path):
    """save_live mid-run with frames pending, ingress queued and a
    seq-slots holdback, then entry.restore_daemon at the cut's clock:
    the restored daemon's per-wire egress (bytes and order) equals the
    uninterrupted daemon's on deterministic links, and so does every
    release tick on the wires with no holdback at the cut; every frame
    pending at the cut is delivered exactly once, and the state, wires
    and counters come back. (The held frames return as the wire's
    ingress — the format has no holdback mark — so the capped wire
    shapes them on the plane's usual schedule from there.)"""
    cut_tick, more = 3, 30
    ctl = tp.build("torch", tp.DET_PROPS)
    rng = np.random.default_rng(11)
    for t in range(cut_tick):
        feed(ctl, t, rng)
        ctl.plane.tick(now_s=(t + 1) * tp.DT)
        for w in ctl.wout:
            w.egress.clear()
    feeds = [[tp.frames_for(k, t, tp.DET_COUNTS[k], rng)
              for k in range(len(ctl.win))]
             for t in range(cut_tick, cut_tick + 4)]
    for k, w in enumerate(ctl.win):
        w.ingress.extend(feeds[0][k])   # queued at the cut
    path = str(tmp_path / "ckpt")
    cut_s = cut_tick * tp.DT
    state_at_cut = edge_cols(ctl.engine)
    pending_at_cut = ctl.plane.export_pending()
    held = {h[0].wire_id: len(h[2]) for h in ctl.plane._holdback.values()}
    assert held  # the seq wire's 70 > 64 frames a tick
    tck.save_live(path, ctl.store, ctl.engine, ctl.plane)
    counters_at_cut = {f.name: np.array(getattr(ctl.plane.counters, f.name))
                       for f in dataclasses.fields(type(ctl.plane.counters))}
    assert pending_at_cut and sum(len(f) for f in feeds[0]) > 0

    r = entry.restore_daemon(path, device="cpu", capacity=64, now_s=cut_s,
                             plane_kwargs=dict(dt_us=tp.DT * 1e6, seed=99))
    assert r["source"] == "checkpoint"
    assert r["pending"] == len(pending_at_cut)
    assert r["ingress"] == sum(len(f) for f in feeds[0]) + sum(
        held.values())
    assert not os.path.exists(os.path.join(path, "pending_frames.npz"))
    for name, col in edge_cols(r["engine"]).items():
        np.testing.assert_array_equal(col, state_at_cut[name],
                                      err_msg=name)
    assert wire_view(r["daemon"]) == wire_view(ctl.daemon)
    for name, col in counters_at_cut.items():
        np.testing.assert_array_equal(getattr(r["plane"].counters, name),
                                      col, err_msg=name)
    res = types.SimpleNamespace(
        daemon=r["daemon"], plane=r["plane"],
        win=[r["daemon"].wires.get_by_key(w.pod_key, w.uid)
             for w in ctl.win],
        wout=[r["daemon"].wires.get_by_key(w.pod_key, w.uid)
              for w in ctl.wout])
    res.plane.pipeline_explicit_clock = True
    got = {}
    for name, sc in (("control", ctl), ("restored", res)):
        out = [[] for _ in sc.wout]
        for i in range(more):
            t = cut_tick + i
            if 0 < i < len(feeds):
                for k, w in enumerate(sc.win):
                    w.ingress.extend(feeds[i][k])
            sc.plane.tick(now_s=(t + 1) * tp.DT)
            for k, w in enumerate(sc.wout):
                while w.egress:
                    out[k].append((t, w.egress.popleft()))
        assert not sc.plane._pending and len(sc.plane._wheel) == 0
        got[name] = out
    for k, w in enumerate(ctl.wout):
        a, b = got["control"][k], got["restored"][k]
        assert [f for _t, f in a] == [f for _t, f in b]
        if ctl.win[k].wire_id not in held:
            assert a == b  # release ticks too
    delivered = [f for w in got["restored"] for _t, f in w]
    for _pk, _uid, frame, _rem in pending_at_cut:
        assert delivered.count(frame) == 1


def test_restore_daemon_serves_metrics_and_defaults_to_the_card(tmp_path):
    """restore_daemon with metrics_port: the exporter is up on a port of
    its own and counts the engine's ops; device=None means the card and
    raises without one, never falling back to the CPU."""
    import urllib.request

    store, engine = small_cluster("torch")
    path = str(tmp_path / "ckpt")
    tck.save(path, store, engine)
    r = entry.restore_daemon(path, device="cpu", capacity=64,
                             metrics_port=0)
    try:
        topo = r["store"].get("default", "a0")
        r["engine"].update_links(topo, topo.spec.links)
        url = f"http://127.0.0.1:{r['metrics']['port']}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert ('kubedtnd_request_duration_milliseconds_count'
                '{method="update"} 1.0') in body
        assert r["engine"].stats.observer is r["daemon"].hist
    finally:
        r["metrics"]["server"].stop()
    if not torch.cuda.is_available():
        for call in (lambda: entry.restore_daemon(path),
                     lambda: tck.load(path),
                     lambda: tck.load_or_rebuild(path, store),
                     lambda: tck.load_sim(path, engine),
                     lambda: tck.rebuild_engine(store),
                     lambda: tck.unflatten_sim_arrays(sim_flat(1)),
                     lambda: tsnap.load_snapshot(os.path.join(path,
                                                              "x.npz"))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


# -- faults of the JAX package found here (ROADMAP §3) ----------------------

def _cut(pkg, cut_tick=3, seed=11):
    """DET_PROPS fed for `cut_tick` ticks (the seq wire's 70 > 64 frames
    a tick leave a holdback), egress emptied; returns (cluster, rng)."""
    sc = tp.build(pkg, tp.DET_PROPS)
    rng = np.random.default_rng(seed)
    for t in range(cut_tick):
        feed(sc, t, rng)
        sc.plane.tick(now_s=(t + 1) * tp.DT)
        for w in sc.wout:
            w.egress.clear()
    return sc, rng


def test_jax_capture_drops_the_holdback_fault(tmp_path):
    """kubedtn_tpu.checkpoint._capture saves queued ingress but not the
    plane's seq-slots holdback (frames drained, deferred to the next
    tick): a JAX restart loses them. The port's capture keeps them."""
    got, held = {}, {}
    for pkg in ("jax", "torch"):
        sc, _rng = _cut(pkg)
        (wire, _lens, parts), = sc.plane._holdback.values()
        assert wire.uid == 3   # the seq wire
        held[pkg] = len(parts)
        queued = len(wire.ingress)
        path = str(tmp_path / pkg)
        CK[pkg].save(path, sc.store, sc.engine, dataplane=sc.plane)
        got[pkg] = [f for _pk, uid, f in CK[pkg].read_ingress_entries(path)
                    if uid == 3]
        assert len(got[pkg]) == queued + (held[pkg] if pkg == "torch"
                                          else 0)
    assert held["jax"] == held["torch"] > 0
    # the port's file holds the held frames first, then the queue
    assert got["torch"][held["torch"]:] == got["jax"]


def test_jax_restore_rolls_the_restored_clocks_by_zero_fault(tmp_path):
    """The JAX CLI's restore order (kubedtn_tpu/cli.py cmd_daemon) leaves
    the plane's shaping epoch unset and starts a new wheel origin: the
    first tick after the restart rolls the restored token buckets by 0
    instead of the time since the last shaped tick, so the 1 Mbit TBF
    wire releases on other ticks than the uninterrupted plane.
    entry.restore_daemon resumes the clock and releases as it would."""
    import kubedtn_tpu.runtime as jrt
    import kubedtn_tpu.wire.server as jsrv

    sc, rng = _cut("jax")
    feeds = [[tp.frames_for(k, t, tp.DET_COUNTS[k], rng)
              for k in range(len(sc.win))] for t in range(3, 6)]
    path = str(tmp_path / "ckpt")
    jck.save(path, sc.store, sc.engine, dataplane=sc.plane)
    _store, engine = jck.load(path)
    daemon = jsrv.Daemon(engine)
    ensure_jax_native()
    plane = jrt.WireDataPlane(daemon, dt_us=tp.DT * 1e6)
    plane.pipeline_explicit_clock = True
    jck.load_wires(path, daemon)
    jck.load_ingress(path, daemon)
    jck.restore_plane_counters(path, plane)
    jck.load_pending(path, plane, now_s=0.03)
    jck.consume_pending(path)
    r = types.SimpleNamespace(
        plane=plane, win=[daemon.wires.get_by_key(w.pod_key, w.uid)
                          for w in sc.win],
        wout=[daemon.wires.get_by_key(w.pod_key, w.uid) for w in sc.wout])
    got = {}
    for name, run in (("control", sc), ("restored", r)):
        out = [[] for _ in run.wout]
        for t in range(3, 30):
            if t - 3 < len(feeds):
                for k, w in enumerate(run.win):
                    w.ingress.extend(feeds[t - 3][k])
            run.plane.tick(now_s=(t + 1) * tp.DT)
            for k, w in enumerate(run.wout):
                while w.egress:
                    out[k].append((t, w.egress.popleft()))
        got[name] = out
    tbf = 1   # DET_PROPS[1]: rate 1 Mbit
    assert got["restored"][tbf] != got["control"][tbf]
    # the latency-only wire does not depend on the clocks' roll
    assert got["restored"][3][:5] == got["control"][3][:5]
