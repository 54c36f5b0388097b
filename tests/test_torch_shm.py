"""The port's shared-memory ingest plane (kubedtn_tpu_torch.shm over the
port's build of the native ring) on the CPU, and against the JAX
package's.

- the ring protocol: FIFO round trip with exact wire / length / trace
  columns and pending counts, wraparound against a FIFO model
  (hypothesis), ring-full refusals that never drop, oversize rejection,
  a torn reservation never surfaced and crossed only on request, and
  the producer-death proof;
- one segment format: a ring written by the JAX package's ShmRing is
  dequeued by the port's, and the reverse, byte for byte;
- transport equivalence in the port: the same frames fed through a ring
  and through the SendToStream RPC give the same per-wire egress and
  telemetry totals, at depths 1 and 2 (deterministic links);
- the port's plane fed through a ring equals JAX's plane fed through a
  ring (deterministic links, depths 1 and 2);
- admission at the ring head: an over-budget tenant's frames stay in
  its ring with typed verdicts, none dropped; the ring's residue folds
  into the drain's backlog signal, a throttled ring's does not;
- the producer side: the sender's outage buffer accounts every frame
  exactly (pushed or buffered, in order), and the producer subprocess
  (`python -m kubedtn_tpu_torch.shm.producer`) delivers its indexed
  frames end to end, its sampled trace ids too.

Everything here needs the port's native library; without a C++
toolchain the module skips, naming the build error. Every plane ticks
on an explicit clock; only the subprocess waits on wall time, bounded.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kubedtn_tpu_torch import native as tnative

from _torch_tenant_harness import mods, wire_def

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT_S = 0.002


@pytest.fixture(autouse=True, scope="module")
def _native():
    try:
        tnative._load()
    except tnative.NativeUnavailable as e:
        pytest.skip(f"the port's native library does not build here: {e}")


def shm_mods(pkg):
    """(ShmRing, ShmSender, ShmIngest, ShmRingError) of one package."""
    if pkg == "jax":
        from _torch_native_guard import ensure_jax_native

        ensure_jax_native()
        from kubedtn_tpu import shm
    else:
        from kubedtn_tpu_torch import shm
    return shm.ShmRing, shm.ShmSender, shm.ShmIngest, shm.ShmRingError


def frames_of(blob, offs, lens):
    return [blob[int(o):int(o + n)] for o, n in zip(offs, lens)]


def tagged(wire_i: int, n: int, size: int = 64, first: int = 0):
    return [bytes([wire_i]) + i.to_bytes(4, "big") + b"\x00" * (size - 5)
            for i in range(first, first + n)]


# -- the ring protocol ----------------------------------------------------

def test_ring_roundtrip_columns(tmp_path):
    """Push (single + batch) then batch-dequeue: FIFO bytes, exact wire,
    length and trace columns, exact pending accounting."""
    Ring, *_ = shm_mods("torch")
    ring = Ring.create(str(tmp_path / "r.ring"), slots=64, slot_size=256,
                       namespace="teamx")
    assert ring.namespace == "teamx" and ring.producer_pid() == os.getpid()
    assert ring.push(b"hello", 7, trace_id=0xABC) == 1
    frames = [bytes([i]) * (i + 1) for i in range(10)]
    assert ring.push_batch(frames, 9) == 10
    assert ring.pending() == 11 == len(ring) == ring.committed()
    blob, wires, offs, lens, traces, skipped = ring.dequeue(100)
    assert skipped == 0 and ring.pending() == 0
    assert frames_of(blob, offs, lens) == [b"hello"] + frames
    assert wires.tolist() == [7] + [9] * 10
    assert traces.tolist() == [0xABC] + [0] * 10
    blob, wires, *_rest, skipped = ring.dequeue(10)
    assert blob == b"" and wires is None and skipped == 0
    ring.close()


def test_ring_full_never_drops_and_oversize_rejected(tmp_path):
    Ring, _s, _i, RingError = shm_mods("torch")
    ring = Ring.create(str(tmp_path / "r.ring"), slots=8, slot_size=128)
    for i in range(8):
        assert ring.push(bytes([i]) * 16, 1) == 1
    assert ring.push(b"x", 1) == 0          # full: refused, not dropped
    assert ring.push_batch([b"a", b"b"], 1) == 0
    assert ring.full_failures() >= 2 and ring.pending() == 8
    assert ring.push(b"z" * 1000, 1) == -1  # over the slot payload
    with pytest.raises(RingError):
        ring.push_batch([b"z" * 1000], 1)
    _b, wires, *_ = ring.dequeue(1)
    assert len(wires) == 1
    assert ring.push(b"y", 1) == 1 and ring.push(b"y", 1) == 0
    ring.close()


_OPS = st.lists(st.one_of(
    st.tuples(st.just("batch"), st.integers(1, 6), st.integers(1, 3),
              st.lists(st.integers(0, 60), min_size=6, max_size=6)),
    st.tuples(st.just("push"), st.integers(0, 60)),
    st.tuples(st.just("deq"), st.integers(1, 10))),
    min_size=20, max_size=300)


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(ops=_OPS)
def test_ring_wraparound_against_a_fifo_model(tmp_path, ops):
    """Random push / push_batch / dequeue sequences on a 32-slot ring,
    many wrap generations: byte-exact order, exact columns, pending ==
    the model's length after every step."""
    Ring, *_ = shm_mods("torch")
    path = str(tmp_path / "w.ring")
    if os.path.exists(path):
        os.remove(path)
    ring = Ring.create(path, slots=32, slot_size=96)
    model, seq = [], 0
    for op in ops:
        if op[0] == "batch":
            _k, k, wid, sizes = op
            batch = [struct.pack("<I", seq + j) + bytes([(seq + j) & 0xFF])
                     * sizes[j] for j in range(k)]
            tids = [(seq + j) & 0xFFFF for j in range(k)]
            pushed = ring.push_batch(batch, wid, tids)
            assert pushed == min(k, 32 - len(model))
            model.extend(zip(batch[:pushed], [wid] * pushed,
                             tids[:pushed]))
            seq += k
        elif op[0] == "push":
            f = struct.pack("<I", seq) + b"\x01" * op[1]
            r = ring.push(f, 5, trace_id=seq)
            assert r == (1 if len(model) < 32 else 0)
            if r == 1:
                model.append((f, 5, seq))
            seq += 1
        else:
            blob, wires, offs, lens, traces, skipped = ring.dequeue(op[1])
            n = 0 if wires is None else len(wires)
            assert skipped == 0 and n == min(op[1], len(model))
            for j in range(n):
                ef, ew, et = model.pop(0)
                assert blob[int(offs[j]):int(offs[j] + lens[j])] == ef
                assert (int(wires[j]), int(traces[j])) == (ew, et)
        assert ring.pending() == len(model)
    ring.close()


def test_torn_reservation_and_producer_death(tmp_path):
    """A reserved-but-uncommitted slot stalls the dequeue at the gap and
    is never surfaced; crossing it needs skip_uncommitted, which the
    ingest passes only once producer_dead() proves the pid gone (a
    reaped child is dead, this process is not)."""
    Ring, *_ = shm_mods("torch")
    ring = Ring.create(str(tmp_path / "t.ring"), slots=64, slot_size=128)
    ring.push_batch([b"a", b"b"], 1)
    assert ring.push_torn(1)
    ring.push_batch([b"c", b"d"], 1)
    assert (ring.pending(), ring.committed()) == (5, 4)
    blob, wires, offs, lens, _t, skipped = ring.dequeue(100)
    assert frames_of(blob, offs, lens) == [b"a", b"b"] and skipped == 0
    _b, wires, *_rest, skipped = ring.dequeue(100)
    assert wires is None and skipped == 0 and ring.pending() == 3
    blob, wires, offs, lens, _t, skipped = ring.dequeue(
        100, skip_uncommitted=True)
    assert skipped == 1 and frames_of(blob, offs, lens) == [b"c", b"d"]
    assert not ring.producer_dead()        # it is this process
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    tnative._load().kdt_shm_set_pid(ring._buf, proc.pid)
    assert ring.producer_pid() == proc.pid and ring.producer_dead()
    ring.close()


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_ring_crosses_packages(tmp_path, src, dst):
    """A segment created and filled by one package's sender (frames on
    two wires, every 3rd carrying a sampled trace id) is attached and
    dequeued by the other package's ring: the same bytes, columns,
    namespace and counts as the writer's own reader sees."""
    SRing, SSender, *_ = shm_mods(src)
    DRing, *_ = shm_mods(dst)
    sender = SSender(str(tmp_path / "x.ring"), slots=256, slot_size=300,
                     namespace="tenant-a", sample_period=3, trace_seed=7)
    sender.send(4, tagged(1, 70, size=200))
    sender.send(9, tagged(2, 50, size=90))
    reader = DRing.attach(sender.ring.path)
    twin = SRing.attach(sender.ring.path)
    assert (reader.namespace, reader.slots, reader.slot_size) \
        == ("tenant-a", 256, 300)
    assert reader.pending() == twin.pending() == 120
    assert reader.committed() == 120
    blob, wires, offs, lens, traces, skipped = reader.dequeue(1000)
    assert skipped == 0 and reader.pending() == twin.pending() == 0
    assert frames_of(blob, offs, lens) == (tagged(1, 70, size=200)
                                           + tagged(2, 50, size=90))
    assert wires.tolist() == [4] * 70 + [9] * 50
    assert [int(x) for x in traces if x] == list(sender.minted)
    for r in (reader, twin):
        r.close()
    sender.close()


# -- planes fed through rings ----------------------------------------------

DET = [dict(latency="3ms"), dict(rate="2Gbit")]


def shm_daemon(pkg, props_list, namespaces=None, depth=1):
    """pairs of pods a_i -> b_i, one link each (props_list[i]), in
    `namespaces[i]` (default "default"); returns (plane, win, wout)."""
    m = mods(pkg)
    store = m.st.TopologyStore()
    kw = {"device": "cpu"} if pkg == "torch" else {}
    n = len(props_list)
    engine = m.eng.SimEngine(store, capacity=4 * n + 8, **kw)
    nss = namespaces or ["default"] * n
    for i, p in enumerate(props_list):
        lp = m.ty.LinkProperties(**p)
        for a, b in ((f"a{i}", f"b{i}"), (f"b{i}", f"a{i}")):
            store.create(m.ty.Topology(
                name=a, namespace=nss[i], spec=m.ty.TopologySpec(links=[
                    m.ty.Link(local_intf="eth1", peer_intf="eth1",
                              peer_pod=b, uid=i + 1, properties=lp)])))
        engine.setup_pod(f"a{i}", nss[i])
        engine.setup_pod(f"b{i}", nss[i])
    m.rec.Reconciler(store, engine).drain()
    daemon = m.srv.Daemon(engine)
    if pkg == "jax":
        from _torch_native_guard import assert_jax_wheel, ensure_jax_native

        ensure_jax_native()
    plane = m.rt.WireDataPlane(daemon, dt_us=DT_S * 1e6,
                               pipeline_depth=depth)
    if pkg == "jax":
        assert_jax_wheel(plane)
    plane.pipeline_explicit_clock = True
    win = [daemon._add_wire(wire_def(f"a{i}", nss[i], i + 1))
           for i in range(n)]
    wout = [daemon._add_wire(wire_def(f"b{i}", nss[i], i + 1))
            for i in range(n)]
    return plane, win, wout


def run_transport(pkg, transport, depth, tmp_path, n_per_wire=120,
                  ticks=30, feed_every=5):
    """Identical schedule over either transport, bursts below the
    explicit-clock drain budget so arrival ticks are transport-blind.
    Returns (per-wire egress, telemetry totals, plane)."""
    plane, win, wout = shm_daemon(pkg, DET, depth=depth)
    plane.enable_telemetry(window_s=0.01, sample_period=4)
    sender = ingest = None
    if transport == "shm":
        Ring, Sender, Ingest, _e = shm_mods(pkg)
        d = tmp_path / f"{pkg}-{transport}-{depth}"
        d.mkdir()
        sender = Sender(str(d / "prod.ring"), namespace="default")
        ingest = Ingest(str(d))
        ingest.attach_ring(Ring.attach(sender.ring.path))
        plane.attach_shm(ingest, watcher=False)
    pb = mods(pkg).srv._pb() if pkg == "torch" else None
    if pb is None:
        from kubedtn_tpu.wire import proto as pb
    per_feed = -(-n_per_wire // (1 + (ticks - 1) // feed_every))
    fed, t = 0, 100.0
    for j in range(ticks):
        if j % feed_every == 0 and fed < n_per_wire:
            burst = min(per_feed, n_per_wire - fed)
            for k, w in enumerate(win):
                frames = tagged(k, burst, first=fed)
                if sender is not None:
                    sender.send(w.wire_id, frames)
                else:
                    plane.daemon.SendToStream(iter(
                        [pb.Packet(remot_intf_id=w.wire_id, frame=f)
                         for f in frames]), None)
            fed += burst
        t += DT_S
        plane.tick(now_s=t)
    plane.flush()
    plane.tick(now_s=t + 10.0)
    assert plane.tick_errors == 0
    if ingest is not None:
        assert sender.buffered() == 0 and ingest.pending_total() == 0
        assert ingest.stats()["frames_in"] == len(win) * n_per_wire
        sender.close()
        ingest.close()
    totals, _s = plane.telemetry.window_sum()
    return [list(w.egress) for w in wout], totals, plane


@pytest.mark.parametrize("depth", [1, 2])
def test_shm_matches_grpc_stream_in_the_port(tmp_path, depth):
    """The same frames through a ring and through SendToStream: equal
    per-wire egress (every frame, in order) and telemetry totals."""
    g, tg, pg = run_transport("torch", "grpc", depth, tmp_path)
    s, ts, ps = run_transport("torch", "shm", depth, tmp_path)
    assert g == s and sum(len(w) for w in s) == 2 * 120
    assert (pg.shaped, pg.dropped) == (ps.shaped, ps.dropped)
    np.testing.assert_array_equal(tg, ts)
    assert s[0] == tagged(0, 120)


@pytest.mark.parametrize("depth", [1, 2])
def test_port_plane_fed_by_shm_equals_jax(tmp_path, depth):
    """The port's plane and JAX's, each fed through its own package's
    ring: equal per-wire egress, shaped / dropped counts and telemetry
    totals."""
    s_t, tt, pt = run_transport("torch", "shm", depth, tmp_path)
    s_j, tj, pj = run_transport("jax", "shm", depth, tmp_path)
    assert s_t == s_j
    assert (pt.shaped, pt.dropped) == (pj.shaped, pj.dropped)
    np.testing.assert_array_equal(tt, tj)


def test_admission_parks_frames_in_the_ring(tmp_path):
    """A tenant at 50 frames/s fed 20 frames a tick through its ring:
    throttled at the ring head with typed frame-budget verdicts that
    carry the ring's depth; frames_in + pending == pushed every tick
    (nothing leaves the ring over budget, nothing is dropped); once the
    budget refills on the clock every frame delivers, in order."""
    from kubedtn_tpu_torch.tenancy import TenantRegistry

    Ring, Sender, Ingest, _e = shm_mods("torch")
    plane, win, wout = shm_daemon("torch", DET[:1], namespaces=["busy"])
    reg = TenantRegistry(plane.engine)
    reg.create("busy", frame_budget_per_s=50.0)
    plane.attach_tenancy(reg)
    sender = Sender(str(tmp_path / "busy.ring"), namespace="busy")
    ingest = Ingest(str(tmp_path))
    ingest.attach_ring(Ring.attach(sender.ring.path))
    plane.attach_shm(ingest, watcher=False)
    frames = tagged(0, 200)
    pushed, t, parked = 0, 50.0, 0
    for j in range(30):
        if j < 10:
            sender.send(win[0].wire_id, frames[pushed:pushed + 20])
            pushed += 20
        t += DT_S
        plane.tick(now_s=t)
        stats = ingest.stats()
        parked = max(parked, stats["throttled_frames_last"])
        assert stats["frames_in"] + stats["pending"] == pushed
    assert parked > 0 and ingest.stats()["throttled_events"] > 0
    assert ingest.stats()["pending"] > 0
    verdicts = [v for v in reg.admission.recent() if v.tenant == "busy"]
    assert verdicts and verdicts[-1].reason == "frame-budget"
    assert verdicts[-1].queued_frames > 0
    assert reg.admission.stats_for("busy")["throttle_events"] \
        == len(verdicts)
    for _ in range(80):
        t += 0.05
        plane.tick(now_s=t)
        if ingest.pending_total() == 0:
            break
    plane.flush()
    plane.tick(now_s=t + 10.0)
    assert list(wout[0].egress) == frames
    assert reg.get("busy").admitted_frames == 200
    sender.close()
    ingest.close()
    plane.stop()


def test_ring_residue_folds_into_the_backlog_signal(tmp_path):
    """Budget residue left in a ring counts in last_drain_backlog,
    entry-denominated (256 frames an entry); a throttled ring counts
    nothing; frames for an unknown wire count as bulk-unresolved."""
    Ring, Sender, Ingest, _e = shm_mods("torch")
    plane, win, _wout = shm_daemon("torch", DET[:1])
    daemon = plane.daemon
    sender = Sender(str(tmp_path / "p.ring"), namespace="default")
    ingest = Ingest(str(tmp_path))
    ingest.attach_ring(Ring.attach(sender.ring.path))
    daemon.shm = ingest
    sender.send(win[0].wire_id, tagged(0, 600, size=32))
    out = daemon.drain_ingress(max_per_wire=8)
    assert sum(len(p) for _w, _r, _l, parts in out for p in parts) == 8
    assert daemon.last_drain_backlog == 2     # 592 frames / 256
    assert daemon.drain_ingress(max_per_wire=8, admit=lambda w: 0) == []
    assert daemon.last_drain_backlog == 0
    assert ingest.stats()["throttled_events"] == 1
    sender.send(0x5FFFFF, [b"lost"] * 3)
    daemon.drain_ingress(max_per_wire=4096)
    assert ingest.stats()["unresolved_frames"] == 3
    assert daemon.bulk_unresolved == 3
    sender.close()
    ingest.close()


# -- the producer side ------------------------------------------------------

def test_sender_outage_buffer_exact_accounting(tmp_path):
    """Ring-full parks frames in the sender's outage buffer: accepted ==
    pushed + buffered after every send; the consumer gets every frame
    exactly once, in order; a full buffer with no consumer blocks (up to
    its timeout), then raises with every frame still accounted for."""
    Ring, Sender, *_ = shm_mods("torch")
    sender = Sender(str(tmp_path / "p.ring"), slots=16, slot_size=96)
    consumer = Ring.attach(sender.ring.path)
    frames = [struct.pack("<I", i) for i in range(400)]
    got = []
    for i in range(0, 400, 40):
        sender.send(3, frames[i:i + 40])
        s = sender.stats()
        assert s["accepted"] == s["pushed"] + s["buffered"]
        blob, wires, offs, lens, *_ = consumer.dequeue(16)
        if wires is not None:
            got.extend(frames_of(blob, offs, lens))
    assert sender.stats()["ring_full_failures"] > 0
    assert sender.buffered_peak > 0
    while True:
        done = sender.flush(timeout_s=0.0)
        blob, wires, offs, lens, *_ = consumer.dequeue(64)
        if wires is not None:
            got.extend(frames_of(blob, offs, lens))
        elif done:
            break
    assert got == frames
    assert sender.stats()["pushed"] == 400 and sender.buffered() == 0
    consumer.close()
    sender.close()
    full = Sender(str(tmp_path / "q.ring"), slots=8, slot_size=96,
                  max_buffered=8)
    with pytest.raises(TimeoutError):
        full.send(1, [b"f"] * 64, block_timeout_s=0.05)
    s = full.stats()
    assert (s["pushed"], s["buffered"]) == (8, 8)
    full.close()


def test_producer_subprocess_end_to_end(tmp_path):
    """`python -m kubedtn_tpu_torch.shm.producer` pushes 300 indexed
    frames in batches of 100 into a 512-slot ring, every 10th stamped
    with a trace id, plus 2 torn slots, and exits; the plane, scanning the directory, delivers
    frames 0..299 once each, in order, crosses the torn tail only
    because the producer is dead, and the sampled ids reach delivery
    under the same id; the dead producer's ring then retires."""
    from kubedtn_tpu_torch import telemetry as tele

    plane, win, wout = shm_daemon("torch", DET[:1])
    plane.enable_telemetry(window_s=0.01, sample_period=1 << 20)
    ring_path = str(tmp_path / "live.ring")
    proc = subprocess.run(
        [sys.executable, "-m", "kubedtn_tpu_torch.shm.producer", ring_path,
         str(win[0].wire_id), "300", "--frame-size", "64", "--slots", "512",
         "--batch", "100", "--sample-period", "10", "--torn", "2"],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "done pushed=300"
    _Ring, _Sender, Ingest, _e = shm_mods("torch")
    ingest = Ingest(str(tmp_path), scan_interval_s=0.0)
    plane.attach_shm(ingest, watcher=False)
    ingest.scan(force=True)
    t = 10.0
    for _ in range(12):
        t += DT_S
        plane.tick(now_s=t)
    plane.flush()
    plane.tick(now_s=t + 10.0)
    idx = [struct.unpack("<Q", f[:8])[0] for f in wout[0].egress]
    assert idx == list(range(300))
    stats = ingest.stats()
    assert stats["skipped_uncommitted"] == 2 and stats["frames_in"] == 300
    assert stats["rings_retired"] == 1 and stats["rings"] == 0
    rec = plane.recorder
    carried = {e[0] for e in list(rec.events) if e[3] == tele.ST_RECEIVED}
    assert len(carried) == 30            # frames 0, 10, ..., 290
    for tid in carried:
        stages = [e[3] for e in rec.events_for(tid)]
        assert tele.ST_INGRESS in stages and tele.ST_DELIVERED in stages
    ingest.close()
    plane.stop()



def test_build_daemon_attaches_tenancy_and_shm(tmp_path):
    """entry.build_daemon(tenancy=, shm_dir=) as cmd_daemon wires them:
    the reconciler registers the CRs' namespace as a tenant, the
    ingest scans the directory, build_plane attaches both, and frames a
    ring holds for a wire reach its peer through the plane."""
    from kubedtn_tpu_torch import entry

    d = entry.build_daemon("cpu", n_spine=2, n_leaf=3, links_per_pair=1,
                           capacity=64, tenancy={"default": {
                               "qos": "silver"}},
                           shm_dir=str(tmp_path / "rings"))
    daemon, reg, ingest = d["daemon"], d["tenancy"], d["shm"]
    assert daemon.tenancy is reg and daemon.shm is ingest
    assert [t.name for t in reg.list()] == ["default"]
    assert reg.get("default").qos == "silver"
    assert reg.rows_of("default").size == d["engine"].num_active == 12
    plane = entry.build_plane(daemon, dt_us=DT_S * 1e6, pipeline_depth=1)
    assert plane.tenancy is reg
    plane.pipeline_explicit_clock = True
    ingest.stop_watcher()
    win = daemon._add_wire(wire_def("spine0", "default", 1))
    wout = daemon._add_wire(wire_def("leaf0", "default", 1))
    _R, Sender, *_ = shm_mods("torch")
    sender = Sender(str(tmp_path / "rings" / "p.ring"),
                    namespace="default")
    sender.send(win.wire_id, tagged(0, 50))
    ingest.scan(force=True)
    t = 1.0
    for _ in range(5):
        t += 0.01
        plane.tick(now_s=t)
    assert list(wout.egress) == tagged(0, 50)
    assert reg.get("default").admitted_frames == 50
    sender.close()
    ingest.close()


def test_scan_skips_a_ring_file_still_being_created(tmp_path):
    """A producer creates its ring file, then sizes and maps it: a scan
    between the two finds an empty `*.ring`. The port's scan skips it
    and attaches the segment once it is written; the JAX package's
    attach raises mmap's ValueError, which its scan does not catch, so
    the drain that scans fails (ROADMAP §3)."""
    from _torch_native_guard import ensure_jax_native

    from kubedtn_tpu_torch.shm import ShmIngest, ShmSender

    path = tmp_path / "p.ring"
    path.write_bytes(b"")
    ingest = ShmIngest(str(tmp_path))
    ingest.scan(force=True)
    assert ingest.stats()["rings"] == 0
    ensure_jax_native()
    from kubedtn_tpu.shm import ShmIngest as JIngest

    with pytest.raises(ValueError, match="empty file"):
        JIngest(str(tmp_path)).scan(force=True)
    sender = ShmSender(str(path), namespace="x")
    sender.send(1, [b"f"] * 3)
    ingest.scan(force=True)
    assert ingest.stats()["rings"] == 1 and ingest.pending_total() == 3
    sender.close()
    ingest.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_wire_drained_in_several_spans_counts_once_fault(tmp_path,
                                                           monkeypatch,
                                                           pkg):
    """One drain that takes a wire's frames from its gRPC ingress and in
    several ring spans (a producer's commit landing between two
    dequeues; here every dequeue is capped at 3 frames): the JAX plane
    gets a batch per span, so the wire's row appears five times in one
    shaping group and its counters keep the last batch only (tx 1 of 12
    frames); the port merges a wire's batches into one (12). Both
    deliver every frame, in order (deterministic 1 ms rows)."""
    Ring, Sender, Ingest, _e = shm_mods(pkg)
    plane, win, wout = shm_daemon(pkg, [dict(latency="1ms")])
    sender = Sender(str(tmp_path / "p.ring"), namespace="default")
    ingest = Ingest(str(tmp_path))
    ingest.attach_ring(Ring.attach(sender.ring.path))
    plane.attach_shm(ingest, watcher=False)
    real = Ring.dequeue
    monkeypatch.setattr(Ring, "dequeue", lambda self, n, **kw: real(
        self, min(n, 3), **kw))
    sender.send(win[0].wire_id, tagged(0, 10))
    win[0].ingress.extend(tagged(0, 2, first=100))
    t = 100.0
    plane.tick(now_s=t)
    monkeypatch.setattr(Ring, "dequeue", real)
    for _ in range(10):
        t += DT_S
        plane.tick(now_s=t)
    plane.flush()
    plane.tick(now_s=t + 10.0)
    assert plane.tick_errors == 0 and plane.shaped == 12
    assert list(wout[0].egress) == tagged(0, 2, first=100) + tagged(0, 10)
    row = plane.daemon.engine.row_of(win[0].pod_key, win[0].uid)
    tx = float(np.asarray(plane.counters.tx_packets)[row])
    rx = float(np.asarray(plane.counters.rx_packets)[row])
    assert (tx, rx) == ((12.0, 12.0) if pkg == "torch" else (1.0, 1.0))
    sender.close()
    ingest.close()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_closed_ring_reads_as_empty_fault(tmp_path, pkg):
    """The ingest's watcher and the metrics scrape read rings on their
    own threads while the drain retires (closes) them: a read after the
    close hands JAX's native side a NULL segment and the process dies of
    SIGSEGV (a full-width daemon did, its watcher in `pending()`); the
    port's ring reads as empty. In a subprocess, so the fault cannot
    take the test run down."""
    if pkg == "jax":
        from _torch_native_guard import ensure_jax_native

        ensure_jax_native()
    root = "kubedtn_tpu_torch" if pkg == "torch" else "kubedtn_tpu"
    code = (f"import sys; sys.path.insert(0, {REPO!r})\n"
            f"from {root}.shm import ShmRing\n"
            f"r = ShmRing.create({str(tmp_path / 'x.ring')!r}, slots=8)\n"
            f"r.close()\n"
            f"print(r.pending(), r.committed(), r.full_failures(), "
            f"r.producer_dead(), len(r), flush=True)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if pkg == "torch":
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["0", "0", "0", "False", "0"]
    else:
        assert out.returncode == -11, (out.returncode, out.stderr[-500:])
