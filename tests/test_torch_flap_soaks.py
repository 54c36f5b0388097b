"""The live fault soaks of kubedtn_tpu_torch.scenarios on the CPU:
`chaos_soak` (two real gRPC daemons, the A→B peer flapped at 1 Hz under
paced load: zero frames lost, the breaker cycling, a sampled cross-node
trace through the whole fault path) and `update_under_flap` (a planned
update gated and staged while the breaker cycles: complete, roll back
cleanly or be rejected, with zero loss). The sizes and every assertion
are those of the JAX package's tests/test_chaos_smoke.py; the keys
returned are the JAX scenario's plus "device".

Also the JAX `live_plane` fault that the port does not copy: at a
latency far above its 5 ms poll, its warm round counts the warm-up's
frames as its own.
"""

import logging
from collections import deque

import pytest

from kubedtn_tpu import scenarios as jsc
from kubedtn_tpu_torch import scenarios as tsc
from kubedtn_tpu_torch.scenarios import chaos_soak, update_under_flap

from _torch_native_guard import assert_jax_wheel, ensure_jax_native
from test_torch_live_soaks import assert_jax_keys


@pytest.mark.chaos
def test_chaos_soak_smoke_no_frames_lost():
    logging.disable(logging.WARNING)  # rate-limited peer-send warnings
    try:
        r = chaos_soak(pairs=2, seconds=3.0, flap_period_s=1.0,
                       offered_frames_per_s=6_000, seed=11, device="cpu")
    finally:
        logging.disable(logging.NOTSET)
    assert_jax_keys(r, "chaos_soak")
    assert r["frames_fed"] > 0
    # the flap fired and the peer link broke
    assert r["injected_faults"]["peer_blackhole"] > 0
    assert r["peer_retries"] > 0
    # zero loss, zero tick errors, at least one full open -> half-open ->
    # closed cycle, nothing dropped at the buffer
    assert r["frames_lost"] == 0, r
    assert r["tick_errors"] == 0, r
    assert r["breaker_cycles"] >= 1, r["breaker"]
    assert r["peer_buffer_dropped"] == 0
    assert r["shaping_dropped"] == 0
    # a sampled cross-node trace rode the fault path: ingress ->
    # outage-buffered -> retried -> peer-sent on A, received on B
    assert r["trace_ok"], r
    assert r["trace_hops"] >= 5
    for stage in ("ingress", "outage-buffered", "retried", "peer-sent",
                  "received"):
        assert stage in r["trace_stages"], r["trace_stages"]
    assert len(r["trace_nodes"]) == 2  # both daemons contributed
    assert r["sampled_frames"] > 0


@pytest.mark.chaos
def test_update_under_flap_smoke():
    logging.disable(logging.WARNING)
    try:
        r = update_under_flap(pairs=2, seconds=3.0, flap_period_s=1.0,
                              offered_frames_per_s=4_000, gate_ticks=60,
                              seed=13, device="cpu")
    finally:
        logging.disable(logging.NOTSET)
    assert_jax_keys(r, "update_under_flap")
    assert r["frames_fed"] > 0
    # the flap fired while the update staged
    assert r["injected_faults"]["peer_blackhole"] > 0
    assert r["breaker_cycles"] >= 1, r["breaker"]
    # every update landed, rolled back cleanly or was rejected, and at
    # least one went through the gate and the stager
    assert r["stage_results"], r
    assert r["stages_clean"], r["stage_results"]
    assert r["frames_lost"] == 0, r
    assert r["tick_errors"] == 0, r


class EgressLog(deque):
    """A wire's egress deque that logs, into a list shared by the wires
    of one plane, each clear() as None and each delivered frame as its
    length: the warm-up's frames are 60 bytes, the injector's 200."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def append(self, frame):
        self.log.append(len(frame))
        super().append(frame)

    def extend(self, frames):
        frames = list(frames)
        self.log.extend(len(f) for f in frames)
        super().extend(frames)

    def clear(self):
        self.log.append(None)
        super().clear()


def round_windows(log) -> list[tuple[int, int]]:
    """(warm-up frames, injector frames) delivered between one clear of
    the egress and the next: one entry a round, the warm round first.
    Every wire's egress is cleared at a round's start, so a round's
    first clear opens its window."""
    wins, cleared = [], 0
    for x in log:
        if x is None:
            cleared += 1
            if cleared % 2 == 1:      # 2 pairs: two clears a round
                wins.append([0, 0])
        elif wins:
            wins[-1][0 if x == 60 else 1] += 1
    return [tuple(w) for w in wins]


def test_live_plane_rounds_count_one_anothers_frames_fault(monkeypatch):
    """JAX's `live_plane` waits for its warm-up's frames to leave
    ingress, not to land; each round then clears the egress and counts
    whatever lands until its total. At a latency far above the 5 ms poll
    the warm round counts warm-up frames as its own and closes before
    its own have landed. The port waits for the warm-up to land: every
    round's window holds its own 2 x 1,024 frames and no others."""
    assert ensure_jax_native() is None
    logs = {}
    for name, mod, kw in (("jax", jsc, {}), ("port", tsc, {"device": "cpu"})):
        log = logs[name] = []
        real = mod._live_plane_setup

        def setup(*a, _real=real, _log=log, _name=name, **k):
            parts = _real(*a, **k)
            if _name == "jax":
                assert_jax_wheel(parts[3])
            for w in parts[5]:
                w.egress = EgressLog(_log)
            return parts

        monkeypatch.setattr(mod, "_live_plane_setup", setup)
        r = mod.live_plane(pairs=2, frames_per_wire=1_000, rounds=2,
                           latency="500ms", timeout_s=120.0, **kw)
        assert r["tick_errors"] == 0 and r["dropped"] == 0
        if name == "port":
            assert r["frames_delivered"] == 2 * 1024
    jw, tw = round_windows(logs["jax"]), round_windows(logs["port"])
    assert len(jw) == len(tw) == 3          # the warm round + 2
    # JAX: the warm round's window holds warm-up frames, which it counts
    # towards its own total of 2 x 1,024
    assert jw[0][0] > 0, jw
    # the port: each round counts exactly its own frames
    assert tw == [(0, 2 * 1024)] * 3, tw
