"""The port's pcap tap (utils/pcap.py) against the JAX package's: the
same frames and timestamps give the same file bytes, the reader and the
filtered fan-out agree, and on the same deterministic plane run the
Daemon's and the plane's capture points record the same (pod, uid,
direction, frame) sequence as the JAX package's."""

import types

import numpy as np
import pytest

import kubedtn_tpu.utils.pcap as jpcap
import kubedtn_tpu.wire.proto as jpb
import kubedtn_tpu_torch.utils.pcap as tpcap
import kubedtn_tpu_torch.wire.proto as tpb

from test_torch_plane import DET_PROPS, DT, build, frames_for

PCAP = {"jax": jpcap, "torch": tpcap}
PB = {"jax": jpb, "torch": tpb}


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, int(s), dtype=np.uint8))
            for s in rng.integers(14, 1600, n)]


@pytest.mark.parametrize("snaplen", [65535, 96])
def test_writer_bytes_equal_jax(tmp_path, snaplen):
    frames = _frames(12)
    ts = [1_700_000_000.0 + 0.0123457 * i for i in range(len(frames))]
    out = {}
    for pkg, mod in PCAP.items():
        path = tmp_path / f"{pkg}.pcap"
        w = mod.PcapWriter(str(path), snaplen=snaplen)
        for f, t in zip(frames, ts):
            w.write(f, t)
        w.close()
        w.write(b"late", 1.0)  # after close: dropped, not raised
        out[pkg] = (path.read_bytes(), w.frames_written,
                    [(c.ts, c.orig_len, c.frame)
                     for c in mod.read_pcap(str(path))])
    assert out["torch"] == out["jax"]
    data, n, recs = out["torch"]
    assert n == len(frames) and data[:4] == b"\xd4\xc3\xb2\xa1"
    assert [r[2] for r in recs] == [f[:snaplen] for f in frames]
    assert [r[1] for r in recs] == [len(f) for f in frames]


@pytest.mark.parametrize("cut", [10, 30, 45])
def test_reader_rejects_truncated_like_jax(tmp_path, cut):
    path = tmp_path / "t.pcap"
    w = tpcap.PcapWriter(str(path))
    w.write(b"x" * 40, 5.0)
    w.close()
    path.write_bytes(path.read_bytes()[:cut])
    errs = {}
    for pkg, mod in PCAP.items():
        with pytest.raises(ValueError) as e:
            list(mod.read_pcap(str(path)))
        errs[pkg] = str(e.value)
    assert errs["torch"] == errs["jax"]


def test_capture_manager_filters_equal_jax(tmp_path):
    seq = [("default/a", 1, "in"), ("default/a", 1, "out"),
           ("default/b", 1, "out"), ("default/a", 2, "in"),
           ("default/b", 2, "in")] * 3
    frames = _frames(len(seq), seed=1)
    taps = [dict(), dict(pod_key="default/a"), dict(uid=2),
            dict(direction="out"), dict(pod_key="default/b", uid=1,
                                        direction="out")]
    out = {}
    for pkg, mod in PCAP.items():
        cm = mod.CaptureManager()
        paths = [tmp_path / f"{pkg}-{i}.pcap" for i in range(len(taps))]
        for p, kw in zip(paths, taps):
            cm.open(str(p), **kw)
        for i, ((pod, uid, d), f) in enumerate(zip(seq, frames)):
            cm.record(pod, uid, f, d, ts=100.0 + i)
        cm.close_all()
        cm.record("default/a", 1, b"gone", "in")  # no tap left
        out[pkg] = [p.read_bytes() for p in paths]
        with pytest.raises(ValueError):
            cm.open(str(tmp_path / "x.pcap"), direction="both")
    assert out["torch"] == out["jax"]
    counts = [len(list(tpcap.read_pcap(str(tmp_path / f"torch-{i}.pcap"))))
              for i in range(len(taps))]
    assert counts == [15, 9, 6, 6, 3]


class ListCapture:
    """A capture tap that keeps what it is given."""

    def __init__(self) -> None:
        self.seen: list = []

    def record(self, pod_key, uid, frame, direction, ts=None):
        self.seen.append((pod_key, uid, direction, bytes(frame)))


CAP_COUNTS = (5, 9, 70, 12)
CAP_FEED, CAP_DRAIN = 4, 20


def capture_run(pkg, depth):
    """DET_PROPS pairs; pod-origin frames through the Daemon's InjectBulk
    (a parsed PacketBatch per wire and tick) and InjectFrame; frames from
    a peer daemon through SendToOnce and SendToBulk on a cross wire;
    every capture point recorded in order."""
    sc = build(pkg, DET_PROPS, depth=depth)
    pb = PB[pkg]
    cap = ListCapture()
    sc.daemon.capture = cap
    cross = sc.daemon._add_wire(types.SimpleNamespace(
        local_pod_name="a0", kube_ns="default", link_uid=99,
        intf_name_in_pod="eth9", veth_name_local_host="",
        peer_intf_id=5, peer_ip="10.9.9.9"))
    rng = np.random.default_rng(4)
    for t in range(CAP_FEED + CAP_DRAIN):
        if t < CAP_FEED:
            for k, w in enumerate(sc.win):
                fr = frames_for(k, t, CAP_COUNTS[k], rng)
                assert sc.daemon.InjectBulk(iter([pb.PacketBatch(packets=[
                    pb.Packet(remot_intf_id=w.wire_id, frame=f)
                    for f in fr])]), None).response
            sc.daemon.InjectFrame(pb.Packet(remot_intf_id=sc.win[0].wire_id,
                                            frame=bytes([9, t]) * 30), None)
            sc.daemon.SendToOnce(pb.Packet(remot_intf_id=cross.wire_id,
                                           frame=bytes([7, t]) * 30), None)
            sc.daemon.SendToBulk(iter([pb.PacketBatch(packets=[
                pb.Packet(remot_intf_id=cross.wire_id,
                          frame=bytes([8, t, i]) * 20)
                for i in range(3)])]), None)
        sc.plane.tick(now_s=(t + 1) * DT)
    sc.plane.flush()
    assert sc.plane.tick_errors == 0 and not sc.plane._pending
    return cap.seen, sc


@pytest.mark.parametrize("depth", [1, 2])
def test_plane_capture_points_equal_jax(depth):
    jseen, _ = capture_run("jax", depth)
    tseen, sc = capture_run("torch", depth)
    assert len(tseen) == len(jseen)
    assert tseen == jseen
    dirs = {d for _p, _u, d, _f in tseen}
    assert dirs == {"in", "out"}
    # every released frame was captured "out" at its pod-side wire
    outs = [x for x in tseen if x[2] == "out" and x[1] != 99]
    assert len(outs) == sc.plane.shaped
    assert sum(1 for x in tseen if x[1] == 99) == 4 * CAP_FEED
