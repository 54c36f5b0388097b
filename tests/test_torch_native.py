"""The port's own build and bindings of the native runtime library
(kubedtn_tpu_torch/native.py: native/kubedtn_native.cc built with g++
into kubedtn_tpu_torch/_build/) against the JAX package's bindings of
the same source, on the same inputs: the TimingWheel, the FlowTable's
fused bypass + classify verdict, the FrameRing, and the frame and
PacketBatch decoders."""

import struct

import numpy as np
import pytest

import kubedtn_tpu.native as jnat
import kubedtn_tpu_torch.native as tnat

from _torch_native_guard import ensure_jax_native


@pytest.fixture(autouse=True, scope="module")
def jax_native_loaded():
    """The JAX bindings these tests compare against, loaded: a worker
    that raced another's in-place build of the JAX package's library
    has latched its build error (tests/_torch_native_guard.py)."""
    err = ensure_jax_native()
    assert err is None, f"kubedtn_tpu.native did not load: {err}"


def tcp_frame(sip, sport, dip, dport, payload=b"", vlan=False, frag=0):
    eth = b"\x02" * 6 + b"\x04" * 6
    if vlan:
        eth += b"\x81\x00\x00\x05"
    eth += b"\x08\x00"
    ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 40 + len(payload), 1, frag,
                     64, 6, 0, bytes(sip), bytes(dip))
    tcp = struct.pack(">HHIIHHHH", sport, dport, 1, 0, 0x5018, 512, 0, 0)
    return eth + ip + tcp + payload


def udp_frame(sport, dport):
    eth = b"\x02" * 6 + b"\x04" * 6 + b"\x08\x00"
    ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, 28, 1, 0, 64, 17, 0,
                     bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2]))
    return eth + ip + struct.pack(">HHHH", sport, dport, 8, 0)


ARP = (b"\xff" * 6 + b"\x02" * 6 + b"\x08\x06" + b"\x00\x01\x08\x00\x06\x04"
       + b"\x00\x01" + b"\x02" * 6 + bytes([10, 0, 0, 1]) + b"\x00" * 6
       + bytes([10, 0, 0, 2]))
IPV6 = b"\x02" * 6 + b"\x04" * 6 + b"\x86\xdd" + b"\x60" + b"\x00" * 39


def frames_mix(rng, n):
    kinds = [
        lambda: tcp_frame([10, 0, 0, 1], int(rng.integers(1000, 1010)),
                          [10, 0, 0, 2], 80, b"x" * int(rng.integers(0, 40))),
        lambda: tcp_frame([10, 0, 0, 3], 179, [10, 0, 0, 4], 179),  # BGP
        lambda: tcp_frame([10, 0, 0, 1], 5, [10, 0, 0, 2], 6, vlan=True),
        lambda: tcp_frame([10, 0, 0, 1], 5, [10, 0, 0, 2], 6, frag=0x2000),
        lambda: udp_frame(53, 53),
        lambda: ARP, lambda: IPV6, lambda: b"\x01\x02",
    ]
    return [kinds[int(rng.integers(0, len(kinds)))]() for _ in range(n)]


def test_build_lands_in_the_port_build_dir():
    path = tnat.library_path()
    assert tnat.have_native()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "kubedtn_tpu_torch"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timing_wheel_matches_jax(seed):
    rng = np.random.default_rng(seed)
    wheels = [jnat.TimingWheel(tick_us=1000), tnat.TimingWheel(tick_us=1000)]
    now = 0
    for _step in range(30):
        n = int(rng.integers(0, 200))
        when = now + rng.uniform(-500, 300_000, n)
        toks = rng.integers(0, 1 << 40, n).astype(np.uint64)
        outs = []
        for w in wheels:
            w.schedule_batch(when, toks)
            outs.append((w.advance_np(now).tolist(), w.next_due_us(),
                         len(w)))
        assert outs[0] == outs[1]
        now += int(rng.integers(0, 40_000))
    final = [w.advance_np(now + 10**9).tolist() for w in wheels]
    assert final[0] == final[1] and len(wheels[1]) == 0


def test_timing_wheel_single_schedule_and_negative_clock():
    for mod in (jnat, tnat):
        w = mod.TimingWheel(tick_us=1000)
        w.schedule(-5, 1)
        w.schedule(2500, 2)
        assert w.advance_np(-100).tolist() == [1]
        assert w.next_due_us() is not None
        assert w.advance(3000) == [2]
        assert w.next_due_us() is None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flowtable_decide_classify_matches_jax(seed):
    rng = np.random.default_rng(seed)
    tables = [jnat.FlowTable(), tnat.FlowTable()]
    for _batch in range(4):
        frames = frames_mix(rng, 64)
        elig = rng.random(64) < 0.7
        shaped = rng.random(64) < 0.2
        count = rng.random(64) < 0.8
        outs = [t.decide_classify_batch(frames, elig, shaped, count)
                for t in tables]
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        assert outs[0][1] == outs[1][1]
        assert [len(t) for t in tables][0] == len(tables[1])
        assert tables[0].bypassed == tables[1].bypassed
        assert tables[0].passed == tables[1].passed
    assert tables[1].bypassed > 0


def test_flowtable_per_flow_state_machine_matches_jax():
    a, b = "10.0.0.1", "10.0.0.2"
    res = []
    for mod in (jnat, tnat):
        ft = mod.FlowTable()
        ft.active_established(a, 1000, b, 80)
        ft.passive_established(b, 80, a, 1000)
        r = [ft.flag(a, 1000, b, 80), ft.msg_redirect(a, 1000, b, 80)]
        ft.shaped_egress(a, 1000, b, 80)
        r += [ft.flag(a, 1000, b, 80), ft.msg_redirect(a, 1000, b, 80)]
        ft.on_close(a, 1000, b, 80)
        r += [ft.flag(a, 1000, b, 80), len(ft), ft.flag(a, 1, b, 2)]
        res.append(r)
    assert res[0] == res[1]


def test_frame_ring_matches_jax():
    rng = np.random.default_rng(5)
    rings = [jnat.FrameRing(4096), tnat.FrameRing(4096)]
    for _ in range(200):
        if rng.random() < 0.6:
            f = bytes(rng.integers(0, 256, int(rng.integers(1, 300)),
                                   dtype=np.uint8))
            assert rings[0].push(f) == rings[1].push(f)
        else:
            assert rings[0].pop() == rings[1].pop()
        assert len(rings[0]) == len(rings[1])
        assert rings[0].dropped == rings[1].dropped
    assert rings[1].dropped > 0


@pytest.mark.parametrize("i", range(8))
def test_frame_decoders_match_jax(i):
    frame = frames_mix(np.random.default_rng(i), 8)[i]
    assert tnat.decode_frame(frame) == jnat.decode_frame(frame)
    assert tnat.classify_frame(frame) == jnat.classify_frame(frame)


def test_batch_classifiers_match_jax():
    frames = frames_mix(np.random.default_rng(9), 100)
    assert tnat.classify_batch(frames) == jnat.classify_batch(frames)
    assert tnat.classify_counts(frames) == jnat.classify_counts(frames)


def test_packet_batch_parsers_match_jax():
    from kubedtn_tpu_torch.wire import proto as tpb

    pkts = [tpb.Packet(remot_intf_id=1000 + i % 3, frame=bytes([i]) * (i + 1),
                       trace_id=(7 * i if i % 2 else 0))
            for i in range(40)]
    blob = tpb.PacketBatch(packets=pkts).SerializeToString()
    for a, b in zip(tnat.parse_packet_batch(blob),
                    jnat.parse_packet_batch(blob)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tnat.parse_packet_batch_traced(blob),
                    jnat.parse_packet_batch_traced(blob)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tnat.parse_packet_batch(b"\x0a\xff\xff\xff")


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a source that does not compile raises
    NativeUnavailable (on a fresh build directory)."""
    bad = tmp_path / "kubedtn_native.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnat, "SOURCE", bad)
    monkeypatch.setattr(tnat, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnat, "_lib", None)
    with pytest.raises(tnat.NativeUnavailable, match="build failed"):
        tnat._load()
