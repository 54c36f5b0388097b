"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives kubedtn_tpu_torch's main path at the BASELINE size — the
100k-link Clos (200,000 directed rows in capacity 2^18), churned by
batched UpdateLinks and shaped through netem -> TBF by the drop-in step
(kernel K1) and the fused steady-state steps (kernels K2 and K3) — then
the live tick's device program on the same Clos, unsharded and sharded
(its mailbox ring steps are kernel K4), then the K-slot simulator and
the routed fabric (each shaping slot one launch of K1), and holds every
kernel against its plain torch version on the card at those shapes and
times both.

Phases, each fatal on failure:
  1. the card (nvidia-smi) and the kernels' build (set-up time);
  2. the Clos on the card;
  3. the main path, with the launch counts set to 0 just before it and
     read just after: UpdateLinks (contiguous and scattered), drop-in
     steps, fused steps with given and with in-kernel uniforms;
  4. K1 and K2 against their plain versions; K3 bit for bit against K2
     fed the same Philox draws, its loss share against the configured
     loss, flag_counts against a host count; K3 timed at S = 10 and 1;
  5. the fat-tree entry step against known one-way delays;
  6. the live tick, unsharded: a fresh Clos reshaped into the three
     kernel classes, 4,000 busy rows per class (padded to 4,096), K = 64
     slots; 8 chained ticks through fused_tick and the same 8 through
     the per-class ladder, bit for bit equal;
  7. the sharded tick on S = 2 and 4 virtual shards of the one card,
     with the launch counts set to 0 just before and read just after:
     bit for bit the unsharded tick; K4 must have launched;
  8. the sharded tick over two cards when there are two or more (a line
     says so when there are not);
  9. K4 alone against its plain version, bit for bit, at R = 4,096 and
     32,768, one launch per ring step on the card, timed against its byte
     bound and torch.roll;
 10. the K-slot simulator (sim.run) on the churned Clos, CBR on all
     200,000 rows, 4 slots and a 128-slot delay line per edge, 200 steps
     of 1 ms, the launch counts set to 0 just before: K1 launched once
     per slot and step; per edge the books close exactly (offered +
     duplicates == delivered + lost + queue-dropped + ring-dropped + in
     flight); the same run over the plain step is bit for bit the same
     state; 10 steps equal the port's CPU run on the same draws; every
     drop class is raised; wall and device time per step, K1's share;
 11. the routed fabric: recompute_routes and its ECMP form equal the
     port's CPU result bit for bit, every next hop realises its
     distance, leaves reach leaves; an event on the 10 links that carry
     the most routes (down, then up again) through
     update_routes_incremental equals a full recompute and restores the
     first distances; run_routed for 50 steps (each
     leaf's uplink rows bound for another leaf), the launch counts set
     to 0 just before: K1 once per slot and step, the per-edge books and
     the fabric's transit balance close, no packet without a route, a
     rerun gives the same bits, and so does the same run over the plain
     step (K1 on 12 slots a step, pending lanes included);
 12. the host live plane, with the launch counts set to 0 just before:
     (a) 600 Topology CRs through the store, the reconciler and the
     SimEngine on the card (reconcile-to-steady timed), the realized
     columns == a CPU engine's from the same CRs, then one 1,000-link
     UpdateLinks through the Daemon's Local handler (state == the CPU
     engine's again); (d) ping on a 10 ms link (K1): one-way == 10 ms and
     == the plain step; (b) 3 x 4,096 links re-shaped into the three
     kernel classes by UpdateLinks, wires on both ends, 1-64 tagged
     frames per ingress wire and tick for 16 ticks of 10 ms, drained:
     depth 1 (telemetry off) == depth 2 (telemetry on), byte for byte
     per wire (digests),
     the books close per edge, the window totals == the counters, the
     TBF fallback ran; wall and device time per tick, the busy share,
     frames shaped per second; (c) the same on 2 virtual shards (K4) and
     on two cards where there are two: == unsharded; (e) where grpc and
     protobuf import: the real-time runner behind a gRPC server, 8 pairs
     at 5 ms, 20,000 frames per wire over SendToBulk from a client
     process, all delivered in order, median frames/s of 3 rounds.

The line before the last lists the kernels with their launches, errors,
times and bounds; the last line is {"ok": true, "device": {...}}. It
exits non-zero, printing neither, when there is no CUDA device or the
package is missing.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks at its 700 W limit: HBM bandwidth and
# non-tensor-core float32 rate (integer work is counted against it too).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per edge: SASS instructions of csrc/shaping.cu as nvcc 12.9
# builds it (cuobjdump -sass, counted by kubedtn_tpu_torch/kernel_bench.py):
# K1's straight-line body to EXIT; for an active edge, K2's and K3's code
# outside the step loop once plus the loop's body per step (an inactive
# edge runs no step). Each thread instruction counts as one operation
# against the float32 rate.
OPS_K1 = 262
OPS_K2 = (183, 165)      # (per active edge, per active edge and step)
OPS_K3 = (283, 226)

STEPS = 10                  # fused steps per K2/K3 launch, as bench.py
PROFILE_CALLS = 4
UPDATE_ITERS = 20           # UpdateLinks per timing sample
DROPIN_STEPS = 20
FUSED_CALLS = 10
TIME_REPS = 15
SRC = "kubedtn_tpu_torch/ops/cuda/csrc/shaping.cu"
PALLAS = "kubedtn_tpu/ops/pallas/shaping.py"
STATE_TOL = dict(rtol=1e-6, atol=1e-3)   # the repo's Pallas parity
DEPART_TOL = dict(rtol=1e-5, atol=1e-2)  # tolerances

# The live tick (runtime.fused_tick) at the Clos's full width.
LIVE_ROWS = 4000            # busy rows per class and tick, padded to 4096
LIVE_SLOTS = 64             # K, runtime's seq_slots default
LIVE_TICKS = 8
LIVE_ELAPSED_US = 1000.0    # wall time between two ticks
LIVE_SHARDS = (2, 4)        # virtual shards of the one card
LIVE_TIMED_TICKS = 3
LIVE_JAMMED = 40            # TBF busy rows that start with a full queue
K4_SRC = "kubedtn_tpu_torch/ops/cuda/csrc/exchange.cu"
K4_REPLACES = "kubedtn_tpu/parallel/exchange.py:70"
K4_SHARDS = 4
K4_ROWS = (4096, 32768)     # the live tick's R, and the byte regime
MAIL_WORDS = 24             # 21 float + 3 int payload words per row

# The K-slot simulator and the routed fabric on the churned Clos. The
# churn's link rates start at 20 Mbit/s, so 36 Mbit/s of 1,500-byte
# packets (three per edge and 1 ms step) is what overflows the slowest
# links' TBF queues, and with latencies up to 100 ms the 128-slot delay
# lines too: every drop class is raised inside SIM_STEPS.
SIM_RATE_BPS = 36e6
SIM_PKTS_PER_STEP = 3
SIM_K = 4                   # k_slots
SIM_Q = 128                 # delay-line slots per edge
SIM_DT_US = 1000.0
SIM_STEPS = 200
SIM_CPU_STEPS = 10          # steps repeated on the CPU on the same draws
SIM_TIMED_STEPS = 20
ROUTE_HOPS = 4              # max_hops of the full recompute
ROUTE_K_PATHS = 4
EVENT_LINKS = 10
ROUTED_RATE_BPS = 12e6      # one packet per sourcing row and step
ROUTED_K_FWD = 8
ROUTED_STEPS = 50
ROUTED_ECMP_STEPS = 10
ROUTED_TIMED_STEPS = 5


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing ----------------------------------------------------------------

def timed(run, n: int) -> float:
    """Median host seconds of run(n), ended by a device sync, after one
    warm-up run(2) (first launches load modules)."""
    run(2)
    samples = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def section(run, n: int, prof: dict, name: str) -> float:
    """Host seconds per call of run (median of timed samples), and into
    prof[name] where its device time goes, from torch.profiler over
    PROFILE_CALLS more calls: device µs per call by launching op (and
    this package's kernels by name), and the device's busy share, device
    time over the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    wall = timed(run, n) / n
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        run(PROFILE_CALLS)
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in p.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    # torch's kernels are charged to the aten op that launched them; this
    # package's kernels have no aten op and are listed by name
    cpu = torch.autograd.DeviceType.CPU
    by_op = sorted(((a.key, a.self_device_time_total / PROFILE_CALLS)
                    for a in p.key_averages()
                    if a.self_device_time_total > 0
                    and (a.device_type == cpu or "shape_step" in a.key
                         or "ring_step" in a.key)),
                   key=lambda kv: -kv[1])
    per_call = device_us / PROFILE_CALLS
    prof[name] = {"wall_us_per_call": wall * 1e6,
                  "device_us_per_call": per_call,
                  "busy_share": per_call / (wall * 1e6),
                  "top_device_us_per_call": [[k[:48], v]
                                             for k, v in by_op[:6]],
                  "own_kernels_us_per_call": {
                      k[:48]: v for k, v in by_op
                      if "shape_step" in k or "ring_step" in k}}
    return wall


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor, tol: dict, name: str):
    """Max |a-b| over finite entries; infinities must coincide; fails
    beyond the stated tolerance."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    check(torch.equal(fa, fb), f"{name}: finite/inf pattern differs")
    check(torch.equal(a[~fa], b[~fb]), f"{name}: infinities differ")
    if not bool(fa.any()):
        return 0.0
    x, y = a[fa].double(), b[fb].double()
    err = float((x - y).abs().max())
    ok = bool(((x - y).abs() <= tol["atol"] + tol["rtol"] * y.abs()).all())
    check(ok, f"{name}: max abs error {err} beyond {tol}")
    return err


def clone_tiled(shaping, ts):
    return shaping.TiledShapeState(
        **{k: v.clone() for k, v in vars(ts).items()})


# -- phases ----------------------------------------------------------------

def run_main_path(el, state, dev):
    """UpdateLinks churn and shaping, as a user drives them. Returns
    (state, the state right after UpdateLinks, metrics)."""
    from kubedtn_tpu_torch.models.topologies import random_link_props
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping

    m = {}
    L = el.n_links
    ends = [np.arange(0, L, dtype=np.int32),
            np.arange(L, 2 * L, dtype=np.int32)]  # host: no sync
    perm = np.random.default_rng(3).permutation(2 * L)[:L]
    scat = [torch.as_tensor(np.sort(perm).astype(np.int32), device=dev),
            torch.as_tensor(np.sort((perm + L) % (2 * L)).astype(np.int32),
                            device=dev)]
    props = [torch.as_tensor(random_link_props(L, s), device=dev)
             for s in (1, 2)]
    valid = torch.ones(L, dtype=torch.bool, device=dev)

    def updates(rows, contiguous):
        def run(n):
            for i in range(n):
                es.update_links(state, rows[i % 2], props[i % 2], valid,
                                contiguous)
        return run

    prof = m["profile"] = {}
    m["link_updates_scattered_per_s"] = L / section(
        updates(scat, False), UPDATE_ITERS, prof, "updates_scattered")
    m["link_updates_per_s"] = L / section(
        updates(ends, True), UPDATE_ITERS, prof, "updates_contiguous")
    # both ends were rewritten whole; the last write of end k was props[k]
    for k in (0, 1):
        rows = torch.as_tensor(ends[k], device=dev).long()
        check(torch.equal(state.props[rows], props[k]),
              f"update_links: end {k} props not written")
        check(torch.equal(state.tokens[rows],
                          es.burst_bytes(props[k][:, es.P_RATE_BPS])),
              f"update_links: end {k} token buckets not reset")
        check(not bool(state.pkt_count[rows].any())
              and not bool(state.corr[rows].any()),
              f"update_links: end {k} counters/corr not reset")

    # fresh qdiscs after UpdateLinks: full buckets, empty queues
    fresh = clone_state(state)

    E = state.capacity
    n_act = int(state.num_active)
    sizes = torch.full((E,), 1500.0, dtype=torch.float32, device=dev)
    t0s = torch.zeros(E, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    delivered = torch.zeros((), dtype=torch.int64, device=dev)

    def dropin(n):
        nonlocal state, delivered
        for _ in range(n):
            state, res = netem.shape_step_auto(state, sizes, state.active,
                                               t0s, gen)
            delivered += res.delivered.sum()

    m["shape_dropin_pkts_per_s"] = n_act / section(
        dropin, DROPIN_STEPS, prof, "dropin")
    m["dropin_delivered"] = int(delivered)

    ts = shaping.tile_state(state)
    sizes_t = shaping.tile_vec(sizes, ts)
    act_t = shaping.tile_vec(state.active.to(torch.int32), ts)
    t_arr_t = shaping.tile_vec(t0s, ts)
    counts = torch.zeros(6, dtype=torch.int64, device=dev)
    calls = 0

    def fused(n):  # in-kernel Philox, as bench.py times the fused path
        nonlocal ts, calls
        for _ in range(n):
            ts, dep, fl = shaping.shape_steps_tiled(ts, sizes_t, act_t,
                                                    t_arr_t, calls, STEPS)
            counts.add_(torch.stack(list(shaping.flag_counts(fl).values())))
            calls += 1

    m["shape_fused_pkts_per_s"] = n_act * STEPS / section(
        fused, FUSED_CALLS, prof, "fused")
    u_t = torch.rand((STEPS * netem.NU, E), generator=gen, device=dev)
    ts, dep, fl = shaping.shape_steps_tiled(ts, sizes_t, act_t, t_arr_t, 0,
                                            STEPS, u_t)
    counts += torch.stack(list(shaping.flag_counts(fl).values()))
    calls += 1
    state = shaping.untile_state(ts, state)

    c = dict(zip((k for k, _ in shaping.COUNT_BITS), counts.tolist()))
    m["fused_counts"] = c
    offered = n_act * STEPS * calls
    check(c["delivered"] + c["drop_loss"] + c["drop_queue"] == offered,
          f"fused outcomes do not partition the offered packets: {c}")
    check(c["delivered"] > 0 and m["dropin_delivered"] > 0,
          "nothing delivered")
    for name in ("tokens", "t_last", "backlog_until", "corr"):
        check(bool(torch.isfinite(getattr(state, name)).all()),
              f"non-finite {name} after the main path")
    check(bool(torch.isfinite(dep[fl & shaping.FLAG_DELIVERED != 0]).all()),
          "a delivered packet has no finite departure")
    return state, fresh, m


def check_k1(state, dev, timer, gen):
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping

    E = state.capacity
    sizes = torch.tensor([64.0, 512.0, 1500.0], device=dev)[
        torch.randint(0, 3, (E,), generator=gen, device=dev)]
    have = torch.rand(E, generator=gen, device=dev) < 0.9
    t_arr = torch.rand(E, generator=gen, device=dev) * 1000.0
    u = torch.rand((E, netem.NU), generator=gen, device=dev)
    args = (state, sizes, have, t_arr, u)

    p_state, p_res = netem._shape_step_from_u(*args)
    k_state, dep, fl = shaping.shape_step_flags(*args, donate=False)
    torch.cuda.synchronize()
    check(torch.equal(fl, shaping.pack_flags(p_res)), "K1 flags differ")
    check(torch.equal(k_state.pkt_count, p_state.pkt_count),
          "K1 pkt_count differs")
    err = max(max_err(dep, p_res.depart_us, DEPART_TOL, "K1 depart"),
              *(max_err(getattr(k_state, n), getattr(p_state, n),
                        STATE_TOL, f"K1 {n}")
                for n in ("tokens", "t_last", "backlog_until", "corr")))
    ms = timer.ms(lambda: shaping.shape_step_flags(*args, donate=False))
    plain = timer.ms(lambda: netem._shape_step_from_u(*args), reps=5)
    moved = nbytes(state.props, state.corr, u, state.tokens, state.t_last,
                   state.backlog_until, state.pkt_count, sizes, t_arr, have,
                   state.active, dep, fl, k_state.tokens, k_state.t_last,
                   k_state.backlog_until, k_state.corr, k_state.pkt_count)
    b, by = bound_ms(moved, OPS_K1 * E)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, bytes=moved,
                delivered=int((fl & shaping.FLAG_DELIVERED != 0).sum()))


def tiled_inputs(state, dev):
    from kubedtn_tpu_torch.ops.cuda import shaping

    ts = shaping.tile_state(state)
    E = state.capacity
    g = torch.Generator(device=dev).manual_seed(11)
    sizes = shaping.tile_vec(
        torch.tensor([64.0, 512.0, 1500.0], device=dev)[
            torch.randint(0, 3, (E,), generator=g, device=dev)], ts)
    act = shaping.tile_vec(state.active.to(torch.int32), ts)
    t_arr = shaping.tile_vec(torch.zeros(E, device=dev), ts)
    return ts, sizes, act, t_arr


def compare_tiled(k, p, name):
    """(kernel ts', depart, flags) against the plain triple."""
    (kts, kdep, kfl), (pts, pdep, pfl) = k, p
    check(torch.equal(kfl, pfl), f"{name} flags differ")
    check(torch.equal(kts.count, pts.count), f"{name} count differs")
    return max(max_err(kdep, pdep, DEPART_TOL, f"{name} depart"),
               *(max_err(getattr(kts, n), getattr(pts, n), STATE_TOL,
                         f"{name} {n}")
                 for n in ("tokens", "t_last", "backlog", "corr")))


# words of one edge in the fused kernels' layout: every input of an
# active edge (props, corr, tokens, t_last, backlog, count, size, t_arr,
# act) and the state it writes back (corr, tokens, t_last, backlog, count)
EDGE_IN_WORDS = 13 + 5 + 4 + 3
EDGE_STATE_WORDS = 5 + 4


def tiled_bytes(act, dep, fl, uniforms: bool):
    """Bytes K2/K3 must move on this data: an active edge's inputs (and
    K2's uniforms for it) read once and its state written once; an
    inactive edge reads only its act word (it departs nothing and keeps
    its state); depart and flags written for every edge and step."""
    E, n = act.numel(), int((act > 0).sum())
    steps = dep.shape[0]
    words = n * (EDGE_IN_WORDS + EDGE_STATE_WORDS) + (E - n)
    if uniforms:
        words += n * 5 * steps
    return 4 * words + nbytes(dep, fl)


def tiled_ops(act, per_edge: int, per_step: int, steps: int) -> int:
    """SASS instructions K2/K3 run for the active edges of `act`."""
    return int((act > 0).sum()) * (per_edge + per_step * steps)


def check_k2(state, dev, timer, gen):
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping

    ts, sizes, act, t_arr = tiled_inputs(state, dev)
    E = ts.capacity
    u_t = torch.rand((STEPS * netem.NU, E), generator=gen, device=dev)
    plain = shaping.shape_steps_plain(ts, sizes, act, t_arr, u_t, STEPS)
    kern = shaping.shape_steps_tiled(clone_tiled(shaping, ts), sizes, act,
                                     t_arr, 0, STEPS, u_t)
    torch.cuda.synchronize()
    err = compare_tiled(kern, plain, "K2")
    work = clone_tiled(shaping, ts)
    ms = timer.ms(lambda: shaping.shape_steps_tiled(work, sizes, act, t_arr,
                                                    0, STEPS, u_t))
    plain_ms = timer.ms(lambda: shaping.shape_steps_plain(
        ts, sizes, act, t_arr, u_t, STEPS), reps=3)
    moved = tiled_bytes(act, kern[1], kern[2], uniforms=True)
    b, by = bound_ms(moved, tiled_ops(act, *OPS_K2, STEPS))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, bytes=moved)


def check_k3(state, dev, timer):
    """K3 on `state` (fresh qdiscs) against K2 fed the materialised
    Philox draws, bit for bit; its outcome shares against the configured
    loss; flag_counts against a host count."""
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops.cuda import philox, shaping

    seed = 12345
    ts, sizes, act, t_arr = tiled_inputs(state, dev)
    E = ts.capacity
    k3 = shaping.shape_steps_tiled(clone_tiled(shaping, ts), sizes, act,
                                   t_arr, seed, STEPS)
    draws = philox.uniforms(seed, E, STEPS, dev)
    k2 = shaping.shape_steps_tiled(clone_tiled(shaping, ts), sizes, act,
                                   t_arr, seed, STEPS, draws)
    torch.cuda.synchronize()
    check(torch.equal(k3[1].view(torch.int32), k2[1].view(torch.int32))
          and torch.equal(k3[2], k2[2]), "K3 outputs differ from K2 on the "
          "materialised Philox draws")
    for n in ("tokens", "t_last", "backlog", "corr", "count"):
        a, b = getattr(k3[0], n), getattr(k2[0], n)
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"K3 state {n} differs bitwise from K2's")
    plain = shaping.shape_steps_plain(ts, sizes, act, t_arr, draws, STEPS)
    err = compare_tiled(k3, plain, "K3")

    # the counters' face: flag_counts against a host count
    fl = k3[2]
    counts = {k: int(v) for k, v in shaping.flag_counts(fl).items()}
    host = fl.cpu().numpy()
    for name, bit in shaping.COUNT_BITS:
        check(counts[name] == int(((host & bit) != 0).sum()),
              f"flag_counts[{name}] differs from the host count")
    # On fresh qdiscs (full buckets: 10 packets of <= 1500 B fit every
    # burst) nothing overflows the queue, so the delivered share is one
    # minus the configured loss: random_link_props sets no correlation
    # and no duplication, so each packet drops with p = loss/100.
    offered = int((act > 0).sum()) * STEPS
    check(counts["drop_queue"] == 0, "K3 queue drops on fresh qdiscs")
    p = (ts.props[es.P_LOSS].double() / 100.0)[act > 0]
    expect = float(p.sum()) * STEPS
    sigma = float((p * (1 - p)).sum() * STEPS) ** 0.5
    for name, got, want in (("loss", counts["drop_loss"], expect),
                            ("delivered", counts["delivered"],
                             offered - expect)):
        check(abs(got - want) < 6 * sigma + 1,
              f"K3 {name} {got} vs configured {want:.0f} "
              f"(sigma {sigma:.1f})")

    work = clone_tiled(shaping, ts)
    ms = timer.ms(lambda: shaping.shape_steps_tiled(work, sizes, act, t_arr,
                                                    seed, STEPS))
    # one step per launch: the per-edge part of the time alone
    ms_s1 = timer.ms(lambda: shaping.shape_steps_tiled(work, sizes, act,
                                                       t_arr, seed, 1))
    plain_ms = timer.ms(lambda: shaping.shape_steps_plain(
        ts, sizes, act, t_arr, philox.uniforms(seed, E, STEPS, dev), STEPS),
        reps=3)
    moved = tiled_bytes(act, k3[1], k3[2], uniforms=False)
    ops = tiled_ops(act, *OPS_K3, STEPS)
    b, by = bound_ms(moved, ops)
    return dict(max_abs_err=err, ms=ms, ms_one_step=ms_s1,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, bytes=moved,
                ops=ops, ops_ms=ops / F32_OPS_PER_S * 1e3,
                delivered_share=counts["delivered"] / offered,
                loss_share=counts["drop_loss"] / offered,
                configured_loss_share=expect / offered)


def check_entry(dev):
    """The fat-tree twin of __graft_entry__.entry(): latency 10ms, jitter
    1ms, 1 Gbit, full buckets — every delivered packet departs within
    [9, 11] ms of t=0."""
    from kubedtn_tpu_torch import entry

    fn, args = entry.entry()
    _, res = fn(*args)
    d = res.depart_us[res.delivered]
    check(res.depart_us.shape == (1024,), "entry: wrong output shape")
    check(int(res.delivered.sum()) > 400, "entry: too few delivered")
    check(bool(((d >= 9000.0) & (d <= 11000.0)).all()),
          "entry: a departure lies outside latency +- jitter")
    check(not bool(res.delivered[512:].any()), "entry: padding delivered")
    return int(res.delivered.sum())


# -- the live tick ------------------------------------------------------------

def same(a, b, name: str) -> None:
    """Nested tuples / lists / dicts / dataclasses of tensors (or plain
    values), bit for bit; a tensor pair may lie on two devices."""
    if dataclasses.is_dataclass(a):
        same(vars(a), vars(b), name)
    elif isinstance(a, dict):
        check(a.keys() == b.keys(), f"{name}: keys differ")
        for k in a:
            same(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (tuple, list)):
        check(len(a) == len(b), f"{name}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{name}[{i}]")
    elif isinstance(a, torch.Tensor):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}"
              f"{tuple(b.shape)}")
        y = b.to(a.device)
        if a.dtype == torch.float32:
            a, y = a.view(torch.int32), y.view(torch.int32)
        check(torch.equal(a, y), f"{name}: differs bitwise")
    else:
        check(a == b, f"{name}: {a} vs {b}")


def tick_runs(state, groups, dev):
    """Closures running n chained ticks from `state`, returning (outs per
    tick, dyn, tel): the fused program, and the per-class ladder."""
    from kubedtn_tpu_torch import runtime
    from kubedtn_tpu_torch import telemetry as tele

    E = state.capacity
    seq, tbf, ind = groups["seq"], groups["tbf"], groups["ind"]

    def fused(n):
        key, dyn, tel = runtime.tick_key(1), None, tele.init_acc(E, dev)
        outs = []
        for _ in range(n):
            key, _sub, dyn, o, tel = runtime.fused_tick(
                state, dyn, key, LIVE_ELAPSED_US, seq, tbf, ind, tel)
            outs.append(o)
        return outs, dyn, tel

    def ladder(n):
        key, dyn, tel = runtime.tick_key(1), None, tele.init_acc(E, dev)
        outs = []
        for _ in range(n):
            key, sub = runtime.split(key)
            el, o = LIVE_ELAPSED_US, {}
            for kind in runtime.CLASS_ORDER:
                dyn, o[kind], tel = runtime.class_tick(
                    state, dyn, sub, el, groups[kind], tel, kind=kind)
                el = 0.0
            outs.append(o)
        return outs, dyn, tel

    return fused, ladder


def sharded_run(state, groups, mesh):
    """n chained sharded ticks on `mesh`: (outs, dyn, tel) with dyn and
    tel joined on the first mesh device."""
    from kubedtn_tpu_torch import convert, runtime
    from kubedtn_tpu_torch import telemetry as tele

    fn = runtime.make_sharded_fused(mesh)
    shards = convert.shard(state, mesh)
    tel0 = convert.shard(tele.init_acc(state.capacity, mesh[0]), mesh)

    def run(n):
        key, dyn, tel, outs = runtime.tick_key(1), None, tel0, []
        for _ in range(n):
            key, _sub, dyn, o, tel = fn(shards, dyn, key, LIVE_ELAPSED_US,
                                        groups["seq"], groups["tbf"],
                                        groups["ind"], tel)
            outs.append(o)
        return outs, convert.unshard(dyn), convert.unshard(tel)

    return run


def check_live_outputs(state, groups, fused_res, dev):
    """What comes out is right by the repo's own means: the outcome
    partition (delivered + loss + queue drops == offered, exactly, per
    the telemetry window), finite departures for every delivered frame,
    the TBF fallback raised, and the max-plus TBF core equal to the
    sequential core on the rows it did not flag."""
    from kubedtn_tpu_torch import runtime
    from kubedtn_tpu_torch import telemetry as tele
    from kubedtn_tpu_torch.ops import netem

    outs, dyn, tel = fused_res
    m = {}
    for name, x in zip(("tokens", "t_last", "backlog_until", "corr"), dyn):
        check(bool(torch.isfinite(x).all()), f"live tick: non-finite {name}")
    check(tuple(tel.shape) == (state.capacity, tele.KCOLS),
          "live tick: telemetry window shape")
    tot = tel.double().sum(0)
    check(float(tot[tele.T_TX]) == float(
        tot[tele.T_DELIVERED] + tot[tele.T_DROP_LOSS]
        + tot[tele.T_DROP_QUEUE]), "live tick: outcomes do not partition "
        "the offered frames")
    check(float(tot[tele.T_HIST0:].sum()) == float(tot[tele.T_DELIVERED]),
          "live tick: latency histogram does not count every delivery")
    m["tel_totals"] = {c: float(tot[i]) for i, c in enumerate(
        tele.COLUMN_NAMES[:tele.T_HIST0])}
    fallback = []
    for t, o in enumerate(outs):
        for kind, out in o.items():
            delivered, depart = out[0], out[1]
            check(tuple(depart.shape) == (runtime._pad_rows(LIVE_ROWS),
                                          LIVE_SLOTS),
                  f"live tick {t} {kind}: depart shape")
            check(bool(torch.isfinite(depart[delivered]).all()),
                  f"live tick {t} {kind}: a delivered frame has no finite "
                  "departure")
            check(bool(delivered.any()), f"live tick {t} {kind}: nothing "
                  "delivered")
        fallback.append(int(o["tbf"][5].sum()))
    m["tbf_fallback_rows_per_tick"] = fallback
    check(sum(fallback) > 0, "live tick: no TBF row raised the fallback")

    # max-plus TBF core vs the sequential core, same draws, first tick
    rows, sizes, valid, kids = groups["tbf"]
    g = lambda col: netem.gather_rows(col, rows)  # noqa: E731
    sub = runtime.split(runtime.tick_key(1))[1]
    u = netem.uniform_rows(sub, netem.CLASS_TBF, kids, *sizes.shape, dev)
    st = runtime._roll_clocks(state, LIVE_ELAPSED_US)
    res, *_rest, fbk = netem.shape_rows_tbf(
        g(st.props), g(st.active), g(st.corr), g(st.pkt_count),
        g(st.tokens), g(st.t_last), g(st.backlog_until), sizes, valid, sub,
        kids, u=u)
    _, sres = netem.shape_rows_seq(
        g(st.props), g(st.active), (g(st.tokens), g(st.t_last),
                                    g(st.backlog_until), g(st.corr),
                                    g(st.pkt_count)),
        sizes, valid, sub, kids, u=u)
    ok = ~fbk
    check(torch.equal(res.delivered[ok], sres.delivered[ok]),
          "TBF max-plus core and sequential core deliver differently")
    m["tbf_vs_seq_core_max_abs_err"] = max_err(
        res.depart_us[ok], sres.depart_us[ok], DEPART_TOL,
        "TBF max-plus core vs sequential core")
    return m


def cross_shard_rows(groups, n_links: int, E: int, S: int) -> int:
    """Busy rows of one tick whose link's other direction (row r +- L)
    lies in another shard's block."""
    from kubedtn_tpu_torch.parallel.partition import shard_of_rows

    rows = torch.cat([groups[k][0] for k in groups]).cpu().numpy()
    rows = rows[rows < E].astype(np.int64)
    peer = np.where(rows < n_links, rows + n_links, rows - n_links)
    return int((shard_of_rows(rows, E, S) != shard_of_rows(peer, E, S))
               .sum())


def run_live_tick(dev, card):
    """Phases 6-8. Returns (metrics, K4 launches on the sharded path)."""
    from kubedtn_tpu_torch import entry, runtime
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    m = {}
    el, state, _ = entry.build_clos_100k()
    groups = entry.build_live_tick(el, state, LIVE_ROWS, LIVE_SLOTS, 17)
    # congested links: some TBF rows start with a 200 ms queue, which the
    # max-plus core must flag for the fallback re-shape
    jam = groups["tbf"][0][:min(LIVE_JAMMED, LIVE_ROWS)].long()
    state.backlog_until[jam] = 2e5
    for kind, g in groups.items():
        check(tuple(g[1].shape) == (runtime._pad_rows(LIVE_ROWS),
                                    LIVE_SLOTS),
              f"{kind} group shape {tuple(g[1].shape)}")
    fused, ladder = tick_runs(state, groups, dev)
    t0 = time.perf_counter()
    want = fused(LIVE_TICKS)
    torch.cuda.synchronize()
    m["first_run_s"] = time.perf_counter() - t0
    same(ladder(LIVE_TICKS), want, "per-class ladder vs fused tick")
    log(f"live tick: fused == per-class ladder, bit for bit, over "
        f"{LIVE_TICKS} ticks (3 x {runtime._pad_rows(LIVE_ROWS)} rows x "
        f"{LIVE_SLOTS} slots, "
        f"capacity {state.capacity})")
    m.update(check_live_outputs(state, groups, want, dev))

    prof = m["profile"] = {}
    m["fused_wall_ms_per_tick"] = 1e3 * section(
        fused, LIVE_TIMED_TICKS, prof, "fused_tick")
    sub = runtime.split(runtime.tick_key(1))[1]
    for kind in runtime.CLASS_ORDER:
        def one_class(n, kind=kind):
            for _ in range(n):
                runtime.class_tick(state, None, sub, LIVE_ELAPSED_US,
                                   groups[kind], None, kind=kind)
        section(one_class, LIVE_TIMED_TICKS, prof, f"class_{kind}")
        p = prof[f"class_{kind}"]
        log(f"live tick class {kind}: device {p['device_us_per_call']:.1f} "
            f"us, wall {p['wall_us_per_call']:.1f} us, busy share "
            f"{p['busy_share']:.3f} ({card})")
    p = prof["fused_tick"]
    log(f"live tick fused: wall {p['wall_us_per_call'] / 1e3:.3f} ms/tick, "
        f"device {p['device_us_per_call'] / 1e3:.3f} ms/tick, busy share "
        f"{p['busy_share']:.3f} ({card})")

    pex.reset_launches()
    for S in LIVE_SHARDS:
        run = sharded_run(state, groups, make_mesh([dev] * S))
        same(run(LIVE_TICKS), want, f"sharded tick S={S} vs unsharded")
        xs = cross_shard_rows(groups, el.n_links, state.capacity, S)
        check(xs > 0, f"S={S}: no link pair straddles a block")
        wall = timed(run, LIVE_TIMED_TICKS) / LIVE_TIMED_TICKS
        m[f"sharded_S{S}"] = {"wall_ms_per_tick": wall * 1e3,
                              "cross_shard_rows_per_tick": xs}
        log(f"sharded tick S={S} virtual shards: bit for bit the unsharded "
            f"tick over {LIVE_TICKS} ticks; {xs} cross-shard rows per "
            f"tick; wall {wall * 1e3:.3f} ms/tick ({card})")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        mesh = make_mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
        run = sharded_run(state, groups, mesh)
        same(run(LIVE_TICKS), want, "sharded tick on two cards vs unsharded")
        wall = timed(run, LIVE_TIMED_TICKS) / LIVE_TIMED_TICKS
        m["sharded_two_cards"] = {"wall_ms_per_tick": wall * 1e3}
        log(f"sharded tick on cuda:0 + cuda:1: bit for bit the unsharded "
            f"tick; wall {wall * 1e3:.3f} ms/tick")
    else:
        log(f"sharded tick on several cards: not run, {n_cards} CUDA "
            f"device visible and the phase needs 2")
    launches = pex.LAUNCHES["ring_step"]
    log(f"sharded path launches {dict(pex.LAUNCHES)}")
    check(launches > 0, "K4 never launched on the sharded path")
    return m, launches


def check_k4(dev, timer):
    """K4 against its plain version (the list rotation into new buffers),
    bit for bit, on 4 virtual shards, one launch per ring step; timed
    against its byte bound and torch.roll over the stacked mailbox."""
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh([dev] * K4_SHARDS)
    out = {}
    for R in K4_ROWS:
        g = torch.Generator(device=dev).manual_seed(R)
        blocks = [torch.randint(-2 ** 31, 2 ** 31 - 1, (R, MAIL_WORDS),
                                generator=g, dtype=torch.int32, device=dev)
                  for _ in range(K4_SHARDS)]
        got = pex.ring_right_shift(blocks, mesh)
        want = pex.ring_right_shift_plain(blocks)
        same(got, want, f"K4 R={R}")
        err = max(float((g.long() - w.long()).abs().max())
                  for g, w in zip(got, want))
        stacked = torch.stack(blocks)
        same(torch.stack(got), torch.roll(stacked, 1, 0),
             f"K4 R={R} vs torch.roll")
        before = pex.LAUNCHES["ring_step"]
        pex.ring_right_shift(blocks, mesh)
        per_step = pex.LAUNCHES["ring_step"] - before
        check(per_step == len(pex.ring_plan(mesh)) == 1,
              f"K4 R={R}: {per_step} launches for one ring step on one card")
        moved = 2 * nbytes(*blocks)
        b, by = bound_ms(moved, 0)
        out[R] = dict(
            max_abs_err=err,
            ms=timer.ms(lambda: pex.ring_right_shift(blocks, mesh)),
            plain_ms=timer.ms(lambda: pex.ring_right_shift_plain(blocks)),
            library_ms=timer.ms(lambda: torch.roll(stacked, 1, 0)),
            bound_ms=b, bound_by=by, bytes=moved, shards=K4_SHARDS,
            launches_per_step=per_step)
        log(f"K4 R={R}: {out[R]}")
    return out


# -- the K-slot simulator and the routed fabric ------------------------------

def clone_state(state):
    """A copy of an EdgeState for an in-place batch op to change."""
    return type(state)(**{k: v.clone() for k, v in vars(state).items()})


def close_trees(card, cpu, name: str) -> float:
    """Nested dataclasses of tensors, card against CPU: counters, masks
    and integers exactly; float state within STATE_TOL, delivery times
    within DEPART_TOL. Returns the largest absolute error."""
    worst = 0.0
    for k, a in vars(card).items():
        b, label = getattr(cpu, k), f"{name}.{k}"
        if dataclasses.is_dataclass(a):
            worst = max(worst, close_trees(a, b, label))
        elif a.dtype != torch.float32 or ".counters" in label:
            check(torch.equal(a.cpu(), b), f"{label}: card and CPU differ")
        else:
            tol = DEPART_TOL if label.endswith("inflight.t") else STATE_TOL
            worst = max(worst, max_err(a.cpu(), b, tol, label))
    return worst


def host_ms(fn, reps: int = 3) -> float:
    """Median host ms of fn(), each ended by a device sync."""
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def k1_share(p: dict) -> float:
    """Kernel K1's share of a profiled section's device time."""
    k1 = sum(v for k, v in p["own_kernels_us_per_call"].items()
             if "shape_step_rows" in k)
    return k1 / p["device_us_per_call"]


def run_sim_phase(el, fresh, dev, card):
    """Phase 10: the K-slot simulator on the churned Clos. Returns
    (metrics, K1 launches of the path)."""
    from kubedtn_tpu_torch import convert, entry, sim
    from kubedtn_tpu_torch.models import traffic
    from kubedtn_tpu_torch.ops import queues
    from kubedtn_tpu_torch.ops.cuda import shaping

    m = {}
    n_rows = 2 * el.n_links
    sim0, spec = entry.build_sim(el, fresh, SIM_RATE_BPS, 1500.0, q=SIM_Q)
    shaping.reset_launches()
    t0 = time.perf_counter()
    out = sim.run(sim0, spec, SIM_STEPS, SIM_DT_US, SIM_K, seed=21)
    torch.cuda.synchronize()
    m["first_run_s"] = time.perf_counter() - t0
    launches = shaping.LAUNCHES["shape_step_rows"]
    check(launches == SIM_STEPS * SIM_K,
          f"sim path: {launches} K1 launches for {SIM_STEPS} steps of "
          f"{SIM_K} slots")
    # (a) the books close, per edge
    check(not bool(sim.conservation_residual(out).any()),
          "sim: tx + duplicated != rx + drops + in flight on some edge")
    # (b) K1 per slot against the plain step, through the whole run
    plain = sim.run(sim0, spec, SIM_STEPS, SIM_DT_US, SIM_K, seed=21,
                    shape_fn=queues.shape_packets_plain)
    check(shaping.LAUNCHES["shape_step_rows"] == launches,
          "the plain path launched K1")
    same(out, plain, "sim: K1 path vs plain path")
    log(f"sim: {SIM_STEPS} steps x {SIM_K} slots through K1 == the plain "
        f"path, bit for bit (E {fresh.capacity}, Q {SIM_Q}, "
        f"{launches} launches)")
    # (e) every outcome the configuration can raise was raised
    c = out.counters
    totals = {n: float(getattr(c, n).double().sum())
              for n in queues.COUNTER_NAMES}
    m["totals"] = totals
    for name in ("rx_packets", "dropped_loss", "dropped_queue",
                 "dropped_ring"):
        check(totals[name] > 0, f"sim: {name} stayed 0")
    check(totals["tx_packets"] == SIM_STEPS * n_rows * SIM_PKTS_PER_STEP,
          f"sim: offered {totals['tx_packets']} packets")
    # (c) the card against the port on the CPU, same draws
    gen = torch.Generator(device=dev).manual_seed(22)
    dt = sim.as_dt(SIM_DT_US, dev)
    draws = [sim.StepDraws(
        traffic=traffic.draw(spec, dt, SIM_K, gen),
        shape_u=queues.draw_shape_uniforms(fresh, SIM_K, gen))
        for _ in range(SIM_CPU_STEPS)]
    on_card = sim.run(sim0, spec, SIM_CPU_STEPS, SIM_DT_US, SIM_K,
                      draws=draws)
    t0 = time.perf_counter()
    on_cpu = sim.run(convert.tree_to(sim0, "cpu"),
                     convert.tree_to(spec, "cpu"), SIM_CPU_STEPS, SIM_DT_US,
                     SIM_K, draws=[convert.tree_to(d, "cpu") for d in draws])
    m["cpu_steps_s"] = time.perf_counter() - t0
    m["card_vs_cpu_max_abs_err"] = close_trees(on_card, on_cpu, "sim")
    log(f"sim: {SIM_CPU_STEPS} steps on the card == the CPU run on the "
        f"same draws (counters and masks exactly, floats within "
        f"{m['card_vs_cpu_max_abs_err']:.3g})")

    # steady state: from the run's end, rings filled
    def steps(n):
        sim.run(out, spec, n, SIM_DT_US, SIM_K, seed=23)

    prof = m["profile"] = {}
    wall = section(steps, SIM_TIMED_STEPS, prof, "sim_step")  # s per step
    p = prof["sim_step"]
    m.update(wall_ms_per_step=wall * 1e3, steps_per_s=1 / wall,
             packets_per_s=n_rows * SIM_PKTS_PER_STEP / wall,
             k1_share_of_device_time=k1_share(p))
    log(f"sim step: wall {m['wall_ms_per_step']:.3f} ms, device "
        f"{p['device_us_per_call'] / 1e3:.3f} ms per profiled step, busy "
        f"share {p['busy_share']:.3f}, K1 {100 * k1_share(p):.2f} % of "
        f"device time; {m['steps_per_s']:.1f} steps/s, "
        f"{m['packets_per_s']:.4g} offered packets/s ({card})")
    log(f"sim step top device ops: {p['top_device_us_per_call']}")
    return m, launches


def realises(state, dist, nh, name: str) -> None:
    """Every next hop realises its distance exactly, and there is one
    exactly where a path exists: dist[u, j] == w[nh] + dist[dst[nh], j]."""
    from kubedtn_tpu_torch.ops import routing

    w, dst = routing.edge_weights_latency(state), state.dst.long()
    ii, jj = torch.nonzero(nh >= 0, as_tuple=True)
    e = nh[ii, jj].long()
    check(torch.equal(w[e] + dist[dst[e], jj], dist[ii, jj]),
          f"{name}: a next hop does not realise its distance")
    check(torch.equal(nh >= 0, torch.isfinite(dist) & (dist > 0)),
          f"{name}: next hops and reachable pairs differ")


def run_routed_phase(el, fresh, dev, card):
    """Phase 11: routes, a link event and the routed fabric on the
    churned Clos. Returns (metrics, K1 launches of the path)."""
    from kubedtn_tpu_torch import convert, entry, router, sim
    from kubedtn_tpu_torch.ops import edge_state as es
    from kubedtn_tpu_torch.ops import queues, routing
    from kubedtn_tpu_torch.ops.cuda import shaping

    m = {}
    n = el.n_nodes
    leaves = np.arange(entry.N_SPINE, n)
    build = dict(seed=31, rate_bps=ROUTED_RATE_BPS, q=SIM_Q,
                 k_fwd=ROUTED_K_FWD, max_hops=ROUTE_HOPS)
    rs, spec, flow_dst, dist4 = entry.build_routed(el, fresh, leaves,
                                                   **build)
    rs_e, _, _, dist_e = entry.build_routed(el, fresh, leaves,
                                            k_paths=ROUTE_K_PATHS, **build)
    nh4, nh_e = rs.next_edge, rs_e.next_edge
    m["recompute_ms"] = host_ms(lambda: routing.recompute_routes(
        fresh, n, ROUTE_HOPS))
    m["recompute_ecmp_ms"] = host_ms(lambda: routing.recompute_routes_ecmp(
        fresh, n, ROUTE_K_PATHS, ROUTE_HOPS), reps=2)
    # the card against the port on the CPU, bit for bit
    cpu = convert.tree_to(fresh, "cpu")
    t0 = time.perf_counter()
    c_dist, c_nh = routing.recompute_routes(cpu, n, ROUTE_HOPS)
    _, c_nh_e = routing.recompute_routes_ecmp(cpu, n, ROUTE_K_PATHS,
                                              ROUTE_HOPS)
    m["cpu_recompute_s"] = time.perf_counter() - t0
    same([dist4, nh4, dist_e, nh_e], [c_dist, c_nh, c_dist, c_nh_e],
         "routes: card vs CPU")
    same(nh_e[:, :, 0], nh4, "ECMP's first pick vs the single path")
    leaf_block = dist4[entry.N_SPINE:, entry.N_SPINE:]
    check(bool(torch.isfinite(leaf_block).all()),
          "routes: a leaf cannot reach a leaf")
    # the hop bound cuts paths; the event below needs converged routes
    dist = routing.refine_dist(fresh, n, dist4, 64)
    nh = routing.next_hop_edges(fresh, dist, n)
    m["pairs_shorter_beyond_the_hop_bound"] = int((dist < dist4).sum())
    realises(fresh, dist, nh, "routes")
    log(f"routes: card == CPU bit for bit (dist, nh, ECMP k = "
        f"{ROUTE_K_PATHS}); every next hop realises its distance; "
        f"recompute {m['recompute_ms']:.2f} ms, ECMP "
        f"{m['recompute_ecmp_ms']:.2f} ms ({card})")

    # a 10-link event, both directions down, then up again
    # a random link of this Clos carries no shortest path (routes crowd
    # onto the few fastest uplinks): take the links that carry the most
    L = el.n_links
    used = torch.bincount(nh[nh >= 0].long() % L, minlength=L)
    top = torch.topk(used, EVENT_LINKS)
    links = top.indices.cpu().numpy()
    m["event_links_pairs_routed_over"] = top.values.tolist()
    both = np.concatenate([links, links + L])
    rows = torch.as_tensor(both, device=dev)
    w = routing.edge_weights_latency(fresh)[rows].cpu().numpy()
    s_k, d_k = fresh.src[rows].cpu().numpy(), fresh.dst[rows].cpu().numpy()
    inf = np.full(len(both), np.inf, np.float32)
    ones = np.ones(len(both), dtype=bool)
    down = es.delete_links(clone_state(fresh), both, ones)
    unknown = torch.full((n, n), torch.inf, device=dev)

    def event(state, dist, nh, w_old, w_new, name):
        t0 = time.perf_counter()
        d2, n2, cells = routing.update_routes_incremental(
            state, n, dist, nh, s_k, d_k, w_old, w_new)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        full = routing.refine_dist(state, n, unknown, 64)
        same(d2, full, f"{name}: incremental vs full recompute")
        realises(state, d2, n2, name)
        check(cells > 0, f"{name}: the event re-derived nothing")
        m[name] = {"ms": ms, "cells": cells}
        return d2, n2

    d_down, n_down = event(down, dist, nh, w, inf, "event_down")
    up = es.apply_links(clone_state(down), both, fresh.uid[rows],
                        fresh.src[rows], fresh.dst[rows], fresh.props[rows],
                        ones)
    d_up, _ = event(up, d_down, n_down, inf, w, "event_up")
    same(d_up, dist, "links up again: the first distances")
    log(f"link event ({EVENT_LINKS} links, both directions): incremental "
        f"== full recompute; down {m['event_down']}, up {m['event_up']} "
        f"of {n * n} cells ({card})")

    # the routed fabric: leaf -> spine rows bound for another leaf
    k_shape = SIM_K + ROUTED_K_FWD

    def run(rs, steps, seed=33, shape_fn=queues.shape_packets):
        return router.run_routed(rs, spec, flow_dst, steps, SIM_DT_US,
                                 SIM_K, ROUTED_K_FWD, seed=seed,
                                 shape_fn=shape_fn)

    shaping.reset_launches()
    out = run(rs, ROUTED_STEPS)
    launches = shaping.LAUNCHES["shape_step_rows"]
    check(launches == ROUTED_STEPS * k_shape,
          f"routed path: {launches} K1 launches for {ROUTED_STEPS} steps "
          f"of {k_shape} slots")
    same(run(rs, ROUTED_STEPS), out, "routed run vs its rerun")
    # K1 per slot (pending lanes arrive at 0, the state carried through
    # 12 launches a step) against the plain step, through the whole run
    plain = run(rs, ROUTED_STEPS, shape_fn=queues.shape_packets_plain)
    check(shaping.LAUNCHES["shape_step_rows"] == 2 * launches,
          "the plain routed path launched K1")
    same(plain, out, "routed: K1 path vs plain path")
    for name, o, steps in (("single path", out, ROUTED_STEPS),
                           ("ECMP", run(rs_e, ROUTED_ECMP_STEPS),
                            ROUTED_ECMP_STEPS)):
        check(not bool(sim.conservation_residual(o.sim).any()),
              f"routed {name}: an edge's books do not close")
        c = o.sim.counters
        sourced = steps * int((spec.mode == 1).sum())
        reinjected = float(c.tx_packets.double().sum()) - sourced
        balance = (float(o.node_rx_packets.double().sum()) + reinjected
                   + int((o.pend_dst >= 0).sum()) + float(o.fwd_dropped)
                   + float(o.no_route_dropped))
        check(float(c.rx_packets.double().sum()) == balance,
              f"routed {name}: transit packets are unaccounted for")
        check(float(o.no_route_dropped) == 0,
              f"routed {name}: packets found no route")
        check(reinjected > 0, f"routed {name}: nothing was forwarded")
    check(float(out.node_rx_packets.sum()) > 0,
          "routed: nothing reached its destination")
    check(not bool(out.node_rx_packets[:entry.N_SPINE].any()),
          "routed: a spine took delivery")
    m.update(node_rx_packets=float(out.node_rx_packets.sum()),
             fwd_dropped=float(out.fwd_dropped),
             forwarded=float(out.sim.counters.tx_packets.double().sum())
             - ROUTED_STEPS * int((spec.mode == 1).sum()))
    log(f"routed: {ROUTED_STEPS} steps x {k_shape} slots through K1 == "
        f"the plain path == the rerun, bit for bit; "
        f"{m['node_rx_packets']:.0f} packets delivered to their leaves, "
        f"{m['forwarded']:.0f} forwarded, {m['fwd_dropped']:.0f} "
        f"lost to forwarding overflow, 0 without a route")

    prof = m["profile"] = {}
    wall = section(lambda k: run(out, k, seed=34), ROUTED_TIMED_STEPS, prof,
                   "routed_step")
    p = prof["routed_step"]
    m.update(wall_ms_per_step=wall * 1e3,
             k1_share_of_device_time=k1_share(p))
    log(f"routed step: wall {m['wall_ms_per_step']:.3f} ms, device "
        f"{p['device_us_per_call'] / 1e3:.3f} ms per profiled step, busy "
        f"share {p['busy_share']:.3f}, K1 {100 * k1_share(p):.2f} % of "
        f"device time ({card})")
    log(f"routed step top device ops: {p['top_device_us_per_call']}")
    return m, launches


# -- phase 12: the host live plane -------------------------------------------

PLANE_ROWS = 4096           # rows per kernel class (the live tick's width)
PLANE_TICKS = 16            # explicit-clock ticks that feed frames
PLANE_DT_S = 0.01
PLANE_MAX_FRAMES = 64       # 1..64 frames per ingress wire and tick
PLANE_SIZES = (64, 257)     # frame bytes drawn from [64, 257)
PLANE_DRAIN_TICKS = 40      # idle ticks at most, to empty the delay line
PLANE_PROFILED = (6, 9)     # feed ticks [a, b) under torch.profiler
UPDATE_BATCH = 1000         # links in phase 12(a)'s UpdateLinks batch
GRPC_PAIRS = 8
GRPC_FRAMES = 20_000        # per wire and round
GRPC_ROUNDS = 3
GRPC_CHUNK = 256            # frames per PacketBatch message
GRPC_TIMEOUT_S = 60.0

# the three kernel classes' props, varied by link index (phase 12(b)).
# The TBF class is TBF-only (rate, latency; no draw decides anything):
# the 1 Mbit links overflow their 50 ms queue now and then, forcing the
# fallback re-shape, and a batch a newer in-flight dispatch shaped from
# the uncorrected bucket is re-shaped by the exact scan under the
# fallback draws, where depth 1 shapes it with the TBF core's draws, so
# with loss on such a row depth 2 would part from depth 1, in the JAX
# package too (ROADMAP §3)
CLASS_PROPS = {
    "tbf": [dict(latency="1ms", rate="1Mbit"),
            dict(latency="2ms", rate="20Mbit"),
            dict(latency="500us", rate="200Mbit"),
            dict(rate="2Gbit")],
    "seq": [dict(latency="2ms", jitter="500us", loss="2", loss_corr="25"),
            dict(latency="1ms", latency_corr="30", jitter="1ms"),
            dict(latency="3ms", reorder_prob="5", gap=2)],
    "ind": [dict(latency="3ms", jitter="1ms", loss="1"),
            dict(latency="1ms"),
            dict(latency="4ms", duplicate="2", corrupt_prob="1")],
}


def update_links_rpc(daemon, pod: str, links) -> None:
    """One Local.UpdateLinks through the Daemon's handler, in process."""
    from kubedtn_tpu_torch.wire import proto as pb

    q = pb.LinksBatchQuery(local_pod=pb.Pod(name=pod, kube_ns="default"),
                           links=[pb.link_to_proto(l) for l in links])
    check(daemon.UpdateLinks(q, None).response, f"UpdateLinks {pod} failed")


def same_columns(a, b, name: str) -> None:
    """Every EdgeState column and every row binding equal, exactly."""
    ea, eb = a["engine"], b["engine"]
    check(ea._rows == eb._rows, f"{name}: row bindings differ")
    sa, sb = ea.state, eb.state
    for f in dataclasses.fields(sa):
        check(torch.equal(getattr(sa, f.name).cpu(),
                          getattr(sb, f.name).cpu()),
              f"{name}: column {f.name} differs")


def plane_classes(built, n_rows: int) -> dict:
    """The first 3 * n_rows spine links in order, a third per class,
    re-shaped by one UpdateLinks per spine CR through the Daemon's
    handler (the spine end is the link's ingress direction). Returns
    {kind: [(spine pod, leaf pod, uid)]}."""
    from kubedtn_tpu_torch.api.types import LinkProperties

    store, daemon = built["store"], built["daemon"]
    kinds = ("tbf", "seq", "ind")
    out = {k: [] for k in kinds}
    need = 3 * n_rows
    i = 0
    for t in sorted(store.list(), key=lambda t: (len(t.name), t.name)):
        if not t.name.startswith("spine") or i >= need:
            continue
        new = []
        for link in t.spec.links[:need - i]:
            kind = kinds[i // n_rows]
            props = CLASS_PROPS[kind][i % len(CLASS_PROPS[kind])]
            new.append(link.with_properties(LinkProperties(**props)))
            out[kind].append((t.name, link.peer_pod, link.uid))
            i += 1
        update_links_rpc(daemon, t.name, new)
    return out


def plane_wires(daemon, classes):
    """Wires on both ends of every class link: (ingress, egress) lists."""
    import types

    def wd(pod, uid):
        return types.SimpleNamespace(
            local_pod_name=pod, kube_ns="default", link_uid=uid,
            intf_name_in_pod="eth1", veth_name_local_host="",
            peer_intf_id=0, peer_ip="")

    win, wout = [], []
    for links in classes.values():
        for spine, leaf, uid in links:
            win.append(daemon._add_wire(wd(spine, uid)))
            wout.append(daemon._add_wire(wd(leaf, uid)))
    return win, wout


def feed_tick(win, t: int, rng) -> int:
    """1..PLANE_MAX_FRAMES tagged frames on every ingress wire, as ONE
    FrameSeg window each over one blob for the tick (the bulk ingress
    form). A frame's first 8 bytes are its tag (wire, tick, index).
    Returns the frames fed."""
    from kubedtn_tpu_torch.wire.server import FrameSeg

    n = len(win)
    counts = rng.integers(1, PLANE_MAX_FRAMES + 1, n)
    total = int(counts.sum())
    lens = rng.integers(*PLANE_SIZES, total).astype(np.uint64)
    offs = np.zeros(total, np.uint64)
    np.cumsum(lens[:-1], out=offs[1:])
    blob = np.full(int(lens.sum()), 0x5A, np.uint8)
    wire_of = np.repeat(np.arange(n, dtype=np.uint32), counts)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    idx = np.arange(total) - np.repeat(first, counts)
    tag = np.zeros((total, 8), np.uint8)
    tag[:, :4] = wire_of.view(np.uint8).reshape(-1, 4)
    tag[:, 4:6] = np.array([t], np.uint16).view(np.uint8)
    tag[:, 6:8] = idx.astype(np.uint16).view(np.uint8).reshape(-1, 2)
    pos = offs.astype(np.int64)[:, None] + np.arange(8)
    blob[pos] = tag
    blob = blob.tobytes()
    lo = 0
    for w, c in zip(win, counts.tolist()):
        w.ingress.append(FrameSeg(blob, offs, lens, lo, lo + c))
        lo += c
    return total


def plane_run(built, win, wout, state0, seed: int, depth: int,
              telemetry: bool = False, mesh=None, profile: bool = False):
    """One run of phase 12(b): a fresh plane over the engine restored to
    `state0`, PLANE_TICKS feed ticks of PLANE_DT_S, then idle ticks until
    the delay line is empty. Returns a dict with the per-wire egress
    digests and counts, the counters, the plane, and the timings."""
    import hashlib

    from kubedtn_tpu_torch import entry

    engine = built["engine"]
    engine.state = clone_state(state0)
    plane = entry.build_plane(built["daemon"], dt_us=PLANE_DT_S * 1e6,
                              seed=seed, pipeline_depth=depth)
    plane.pipeline_explicit_clock = True
    if telemetry:
        plane.enable_telemetry(window_s=3600.0, sample_period=1024)
    if mesh is not None:
        plane.enable_sharding(mesh)
    rng = np.random.default_rng(seed)
    digests = [hashlib.blake2b(digest_size=16) for _ in wout]
    counts = [0] * len(wout)
    fed = 0
    walls = []
    prof_out = None
    dev = engine.device

    def collect():
        # explicit-clock ticks on this thread: nothing appends to an
        # egress deque while it is read here
        for k, w in enumerate(wout):
            if w.egress:
                digests[k].update(b"".join(w.egress))
                counts[k] += len(w.egress)
                w.egress.clear()

    t = 0
    prof_ctx = p_t0 = None
    for t in range(PLANE_TICKS):
        fed += feed_tick(win, t, rng)
        if profile and t == PLANE_PROFILED[0] and dev.type == "cuda":
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as tprofile

            torch.cuda.synchronize()
            prof_ctx = tprofile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof_ctx.__enter__()
            p_t0 = time.perf_counter()
        w0 = time.perf_counter()
        plane.tick(now_s=(t + 1) * PLANE_DT_S)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - w0)
        if prof_ctx is not None and t == PLANE_PROFILED[1] - 1:
            p_wall = time.perf_counter() - p_t0
            prof_ctx.__exit__(None, None, None)
            n = PLANE_PROFILED[1] - PLANE_PROFILED[0]
            dev_us = sum(e.time_range.elapsed_us()
                         for e in prof_ctx.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
            prof_out = {"device_ms_per_tick": dev_us / 1e3 / n,
                        "busy_share": dev_us / 1e6 / p_wall}
            prof_ctx = None
        collect()
    feed_wall = sum(walls)
    shaped_fed = plane.shaped
    for j in range(PLANE_DRAIN_TICKS):
        t += 1
        plane.tick(now_s=(t + 1) * PLANE_DT_S)
        collect()
        if (not plane._inflight and not plane._holdback
                and len(plane._wheel) == 0):
            break
    plane.flush()
    collect()
    check(plane.tick_errors == 0, "live plane: tick errors")
    check(len(plane._wheel) == 0 and not plane._pending,
          "live plane: delay line not empty after the drain")
    c = plane.counters
    return {"digests": [d.hexdigest() for d in digests], "counts": counts,
            "fed": fed, "plane": plane, "counters": c,
            "feed_wall_s": feed_wall, "wall_ms_per_tick":
            1e3 * statistics.median(walls), "shaped_in_feed": shaped_fed,
            "profile": prof_out}


def same_egress(a: dict, b: dict, name: str) -> None:
    check(a["counts"] == b["counts"], f"{name}: per-wire egress counts "
                                      f"differ")
    check(a["digests"] == b["digests"], f"{name}: per-wire egress bytes "
                                        f"differ")
    pa, pb = a["plane"], b["plane"]
    check((pa.shaped, pa.dropped) == (pb.shaped, pb.dropped),
          f"{name}: shaped/dropped differ")
    for f in dataclasses.fields(a["counters"]):
        check(np.array_equal(getattr(a["counters"], f.name),
                             getattr(b["counters"], f.name)),
              f"{name}: counter {f.name} differs")


def books_close(r: dict, name: str) -> None:
    """Per edge rx + loss + queue == tx; shaped + dropped == fed."""
    c, p = r["counters"], r["plane"]
    check(np.array_equal(c.rx_packets + c.dropped_loss + c.dropped_queue,
                         c.tx_packets), f"{name}: per-edge books open")
    check(p.shaped + p.dropped == r["fed"] == int(c.tx_packets.sum()),
          f"{name}: shaped {p.shaped} + dropped {p.dropped} != fed "
          f"{r['fed']}")
    check(sum(r["counts"]) == p.shaped, f"{name}: egress != shaped")


GRPC_INJECTOR = r"""
import sys, time
import grpc
sys.path.insert(0, sys.argv[1])
from kubedtn_tpu_torch.wire import proto as pb
port, wids, n, chunk = sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
wids = [int(w) for w in wids.split(",")]
frame = lambda w, i: w.to_bytes(4, "big") + i.to_bytes(4, "big") + bytes(56)
msgs = []
for lo in range(0, n, chunk):
    for w in wids:
        msgs.append(pb.PacketBatch(packets=[
            pb.Packet(remot_intf_id=w, frame=frame(w, i))
            for i in range(lo, min(n, lo + chunk))]))
ch = grpc.insecure_channel(f"127.0.0.1:{port}")
call = ch.stream_unary("/proto.v1.WireProtocol/SendToBulk",
                       request_serializer=pb.PacketBatch.SerializeToString,
                       response_deserializer=pb.BoolResponse.FromString)
t0 = time.perf_counter()
ok = call(iter(msgs)).response
print(ok, time.perf_counter() - t0, flush=True)
ch.close()
"""


def run_grpc_phase(dev, card) -> dict:
    """Phase 12(e): the real-time runner behind a real gRPC server; a
    client process streams GRPC_FRAMES frames per wire over SendToBulk;
    every frame must be delivered. Median frames/s of GRPC_ROUNDS rounds
    after one warm-up round."""
    import os
    import subprocess
    import types

    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.api.types import (Link, LinkProperties,
                                             Topology, TopologySpec)
    from kubedtn_tpu_torch.topology.engine import SimEngine
    from kubedtn_tpu_torch.topology.reconciler import Reconciler
    from kubedtn_tpu_torch.topology.store import TopologyStore
    from kubedtn_tpu_torch.wire.server import Daemon, make_server

    store = TopologyStore()
    engine = SimEngine(store, capacity=4 * GRPC_PAIRS + 8, device=dev)
    props = LinkProperties(latency="5ms")
    for i in range(GRPC_PAIRS):
        a, b = f"lp-a{i}", f"lp-b{i}"
        for x, y in ((a, b), (b, a)):
            store.create(Topology(name=x, spec=TopologySpec(links=[
                Link(local_intf="eth1", peer_intf="eth1", peer_pod=y,
                     uid=i + 1, properties=props)])))
        engine.setup_pod(a)
        engine.setup_pod(b)
    Reconciler(store, engine).drain()
    daemon = Daemon(engine)
    server, port = make_server(daemon, port=0, host="127.0.0.1",
                               log_rpcs=False)
    server.start()
    plane = entry.build_plane(daemon, dt_us=2_000.0)

    def wd(pod, uid):
        return types.SimpleNamespace(
            local_pod_name=pod, kube_ns="default", link_uid=uid,
            intf_name_in_pod="eth1", veth_name_local_host="",
            peer_intf_id=0, peer_ip="")

    win = [daemon._add_wire(wd(f"lp-a{i}", i + 1))
           for i in range(GRPC_PAIRS)]
    wout = [daemon._add_wire(wd(f"lp-b{i}", i + 1))
            for i in range(GRPC_PAIRS)]
    plane.start()
    root = os.path.dirname(os.path.abspath(__file__))
    wids = ",".join(str(w.wire_id) for w in win)
    total = GRPC_PAIRS * GRPC_FRAMES

    def one_round() -> float:
        for w in wout:
            w.egress.clear()
        proc = subprocess.Popen(
            [sys.executable, "-c", GRPC_INJECTOR, root, str(port), wids,
             str(GRPC_FRAMES), str(GRPC_CHUNK)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            deadline = time.monotonic() + GRPC_TIMEOUT_S
            done, t_first = 0, None
            while time.monotonic() < deadline:
                done = sum(len(w.egress) for w in wout)
                if done and t_first is None:
                    t_first = time.perf_counter()
                if done >= total:
                    break
                time.sleep(0.002)
            elapsed = time.perf_counter() - t_first if t_first else 0.0
            out, err = proc.communicate(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(proc.returncode == 0, f"gRPC injector failed: {err[-2000:]}")
        check(done == total, f"gRPC round delivered {done} of {total}")
        got = [list(w.egress) for w in wout]
        for k, frames in enumerate(got):
            want = [win[k].wire_id.to_bytes(4, "big") + i.to_bytes(4, "big")
                    + bytes(56) for i in range(GRPC_FRAMES)]
            check(frames == want, f"gRPC wire {k}: frames differ")
        return total / elapsed

    try:
        one_round()  # warm-up: kernel loads, first ticks
        rates = sorted(one_round() for _ in range(GRPC_ROUNDS))
    finally:
        plane.stop()
        server.stop(0)
    check(plane.tick_errors == 0, "gRPC plane: tick errors")
    m = {"frames_per_s": statistics.median(rates), "rates": rates,
         "pairs": GRPC_PAIRS, "frames_per_wire": GRPC_FRAMES,
         "stage": plane.stage_breakdown()}
    log(f"12(e) gRPC: {GRPC_PAIRS} pairs at 5 ms, {GRPC_FRAMES} frames per "
        f"wire over SendToBulk, all delivered in order; median "
        f"{m['frames_per_s']:.1f} frames/s of {GRPC_ROUNDS} rounds "
        f"{[round(r, 1) for r in rates]} ({card})")
    return m


def run_live_plane_phase(dev, card, n_spine=None, n_leaf=None,
                         n_rows: int = PLANE_ROWS) -> tuple:
    """Phase 12: the host live plane at the 100k-link Clos. Returns
    (metrics, K4 launches of the sharded plane)."""
    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.edge_state import props_row, burst_bytes
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh
    from kubedtn_tpu_torch.telemetry import (T_DELIVERED, T_DROP_LOSS,
                                             T_DROP_QUEUE, T_TX)
    from kubedtn_tpu_torch.topology.engine import ping_inputs

    m = {}
    size = {} if n_spine is None else dict(n_spine=n_spine, n_leaf=n_leaf,
                                           capacity=1 << 12)
    # (a) control plane: 600 CRs -> store -> reconciler -> engine
    built = entry.build_daemon(dev, **size)
    m["reconcile_s"] = built["reconcile_s"]
    cpu = entry.build_daemon("cpu", **size)
    same_columns(built, cpu, "12(a) realized state vs the CPU build")
    engine = built["engine"]
    log(f"12(a) control plane: {len(built['crs'])} CRs, "
        f"{engine.num_active} rows in capacity {engine.state.capacity}; "
        f"reconcile-to-steady {m['reconcile_s']:.3f} s; realized columns "
        f"== the CPU engine's from the same CRs ({card})")
    spine0 = built["store"].get("default", "spine0")
    new = LinkProperties(latency="20ms", jitter="1ms", rate="1Gbit")
    batch = [l.with_properties(new)
             for l in spine0.spec.links[:UPDATE_BATCH]]
    update_links_rpc(cpu["daemon"], "spine0", batch)  # (loads proto)
    t0 = time.perf_counter()
    update_links_rpc(built["daemon"], "spine0", batch)
    engine.flush()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    m["update_links_ms"] = 1e3 * (time.perf_counter() - t0)
    same_columns(built, cpu, "12(a) after UpdateLinks vs the CPU engine")
    rows = [engine.row_of("default/spine0", l.uid) for l in batch]
    want = torch.as_tensor(props_row(new.to_numeric()), device=dev)
    st = engine.state
    check(bool((st.props[rows] == want).all()), "UpdateLinks props")
    check(bool((st.tokens[rows] == burst_bytes(want[5:6])).all()),
          "UpdateLinks did not refill the buckets")
    log(f"12(a) UpdateLinks: {len(batch)} links through the Daemon's Local "
        f"handler in {m['update_links_ms']:.3f} ms, state == the CPU "
        f"engine's ({card})")

    # (d) ping on one deterministic link (latency 10 ms, no jitter, on
    # the last spine, which no later step re-shapes): K1
    spine = max((t.name for t in built["store"].list()
                 if t.name.startswith("spine")), key=lambda n: int(n[5:]))
    link = built["store"].get("default", spine).spec.links[0]
    leaf, uid = link.peer_pod, link.uid
    ra = engine.row_of(f"default/{spine}", uid)
    rb = engine.row_of(f"default/{leaf}", uid)
    plain_in = ping_inputs(engine.state, (ra, rb), 84.0, uid, 3)
    _ps, plain = netem.shape_step(clone_state(engine.state), *plain_in)
    r = engine.ping(spine, leaf, uid, seed=3)
    check(r["reachable"], "ping: not delivered")
    check(r["fwd_us"] == float(plain.depart_us[ra])
          and r["rev_us"] == float(plain.depart_us[rb]),
          "ping: K1 differs from the plain step")
    check(r["fwd_us"] == 10_000.0 and r["rev_us"] == 10_000.0,
          f"ping: one-way delays {r['fwd_us']} / {r['rev_us']} us, the "
          f"link's latency is 10,000 us")
    m["ping"] = r
    log(f"12(d) ping {spine}->{leaf} uid {uid}: one-way {r['fwd_us']} us "
        f"and {r['rev_us']} us == the link's 10 ms latency; K1 == the plain "
        f"step ({card})")

    # (b) the data plane at the live tick's width
    classes = plane_classes(built, n_rows)
    win, wout = plane_wires(built["daemon"], classes)
    state0 = clone_state(engine.state)
    seed = 12
    # depth 1 with telemetry off against depth 2 with telemetry on: one
    # comparison holds both contracts (a run apiece costs ~30 s here)
    d1 = plane_run(built, win, wout, state0, seed, depth=1)
    d2 = plane_run(built, win, wout, state0, seed, depth=2, telemetry=True,
                   profile=True)
    same_egress(d1, d2, "12(b) depth 2 + telemetry on vs depth 1 off")
    for name, r in (("depth 1", d1), ("depth 2", d2)):
        books_close(r, f"12(b) {name}")
    total, _secs = d2["plane"].telemetry.window_sum()
    c = d2["counters"]
    for col, arr in ((T_TX, c.tx_packets), (T_DELIVERED, c.rx_packets),
                     (T_DROP_LOSS, c.dropped_loss),
                     (T_DROP_QUEUE, c.dropped_queue)):
        check(np.array_equal(total[:len(arr), col], arr),
              f"12(b) window column {col} != the counters")
    for r in (d1, d2):
        check(r["plane"].fallbacks > 0, "12(b) the TBF fallback never ran")
    p2 = d2["plane"]
    m["plane"] = {
        "rows_per_class": n_rows, "wires": len(win) + len(wout),
        "fed": d1["fed"], "shaped": d1["plane"].shaped,
        "dropped": d1["plane"].dropped,
        "fallback_rows": d1["plane"].fallbacks,
        "wall_ms_per_tick_depth1": d1["wall_ms_per_tick"],
        "wall_ms_per_tick_depth2": d2["wall_ms_per_tick"],
        "frames_shaped_per_s_depth1": d1["shaped_in_feed"]
        / d1["feed_wall_s"],
        "frames_shaped_per_s_depth2": d2["shaped_in_feed"]
        / d2["feed_wall_s"],
        "stage_depth1": d1["plane"].stage_breakdown(),
        "stage_depth2": p2.stage_breakdown(),
        "profile_depth2": d2["profile"]}
    mp = m["plane"]
    log(f"12(b) live plane: 3 x {n_rows} rows, {len(win)} + {len(wout)} "
        f"wires, {PLANE_TICKS} ticks of {PLANE_DT_S * 1e3:.0f} ms, "
        f"{d1['fed']} frames fed, {mp['shaped']} shaped, {mp['dropped']} "
        f"dropped, {mp['fallback_rows']} TBF fallback rows; depth 1 "
        f"(telemetry off) == depth 2 (telemetry on), byte for byte per "
        f"wire; books closed per edge; window totals == counters")
    for d, r in (("1", d1), ("2 + telemetry", d2)):
        sh = r["plane"].stage_breakdown()["share"]
        log(f"12(b) depth {d}: wall {r['wall_ms_per_tick']:.3f} ms/tick "
            f"(median), {r['shaped_in_feed'] / r['feed_wall_s']:.1f} "
            f"frames shaped/s; stage shares {sh} ({card})")
    if d2["profile"] is not None:
        log(f"12(b) depth 2 + telemetry device "
            f"{d2['profile']['device_ms_per_tick']:.3f}"
            f" ms/tick, busy share {d2['profile']['busy_share']:.4f} "
            f"(torch.profiler over ticks {PLANE_PROFILED}) ({card})")

    # (c) the sharded plane: 2 virtual shards, and two cards where there
    # are two; K4 launches counted from 0
    pex.reset_launches()
    meshes = [("2 virtual shards", make_mesh([dev] * 2))]
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards >= 2:
        meshes.append(("cuda:0 + cuda:1", make_mesh(
            [torch.device("cuda", 0), torch.device("cuda", 1)])))
    for name, mesh in meshes:
        sh = plane_run(built, win, wout, state0, seed, depth=2, mesh=mesh)
        same_egress(sh, d1, f"12(c) sharded on {name} vs unsharded")
        summ = sh["plane"].shard_summary()
        m[f"sharded {name}"] = {
            "wall_ms_per_tick": sh["wall_ms_per_tick"],
            "xshard_frames": summ["xshard_frames"],
            "mailbox_hwm": summ["mailbox_hwm"]}
        log(f"12(c) sharded plane on {name}: per-wire egress == unsharded; "
            f"{summ['xshard_frames']} cross-shard frames; wall "
            f"{sh['wall_ms_per_tick']:.3f} ms/tick ({card})")
    if n_cards < 2:
        log(f"12(c) sharded plane on two cards: not run, {n_cards} CUDA "
            f"device visible and it needs 2")
    k4 = pex.LAUNCHES["ring_step"]
    log(f"12(c) K4 launches on the sharded plane: {k4}")
    check(k4 > 0 or dev.type != "cuda", "K4 never launched on the plane")

    # (e) gRPC, where it imports
    try:
        import google.protobuf  # noqa: F401
        import grpc  # noqa: F401
        have_grpc = True
    except ImportError as e:
        have_grpc, why = False, str(e)
    if have_grpc:
        m["grpc"] = run_grpc_phase(dev, card)
    else:
        log(f"12(e) gRPC: not run, grpc/protobuf do not import here: {why}")
    return m, k4


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from kubedtn_tpu_torch import _build, entry
    from kubedtn_tpu_torch.kernel_bench import Timer, card_line
    from kubedtn_tpu_torch.ops.cuda import shaping

    dev = torch.device("cuda")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name in libs:
        for line in _build.log_path(name).read_text().splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"ptxas {name}: {line.strip()}")
    log(f"built {libs} in {build_s:.1f} s")

    el, state, _ = entry.build_clos_100k()
    check(state.capacity == 1 << 18, "Clos capacity is not 2^18")
    check(int(state.num_active) == 200_000, "Clos is not 200,000 rows")

    shaping.reset_launches()
    state, fresh, main_m = run_main_path(el, state, dev)
    launches = dict(shaping.LAUNCHES)
    log(f"main path launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    log(f"link-updates/s {main_m['link_updates_per_s']:.1f} contiguous, "
        f"{main_m['link_updates_scattered_per_s']:.1f} scattered "
        f"(100k-link Clos; {card})")

    gen = torch.Generator(device=dev).manual_seed(5)
    timer = Timer(dev)
    results = {"K1": check_k1(state, dev, timer, gen),
               "K2": check_k2(state, dev, timer, gen),
               "K3": check_k3(fresh, dev, timer)}
    k3 = results["K3"]
    log(f"K3 {k3['ms'] * 1e3:.2f} us at S = {STEPS}, "
        f"{k3['ms_one_step'] * 1e3:.2f} us at S = 1; bound "
        f"{k3['bound_ms'] * 1e3:.2f} us ({k3['bound_by']}; ops "
        f"{k3['ops_ms'] * 1e3:.2f} us) ({card})")
    entry_delivered = check_entry(dev)

    live_m, k4_launches = run_live_tick(dev, card)
    k4 = check_k4(dev, timer)
    sim_m, sim_launches = run_sim_phase(el, fresh, dev, card)
    routed_m, routed_launches = run_routed_phase(el, fresh, dev, card)
    shaping.reset_launches()
    plane_m, plane_k4 = run_live_plane_phase(dev, card)
    plane_k1 = shaping.LAUNCHES["shape_step_rows"]
    log(f"live plane path launches: K1 {plane_k1}, K4 {plane_k4}")
    check(plane_k1 > 0, "K1 never launched on the live plane's path")
    k1_paths = {"main": launches["shape_step_rows"], "sim": sim_launches,
                "routed": routed_launches, "plane": plane_k1}
    log(f"K1 launches by path {k1_paths}")

    meta = {"K1": ("shape_step_rows", 220), "K2": ("shape_steps_cols", 250),
            "K3": ("shape_steps_cols_philox", 277)}
    kernels = []
    for k, (name, line) in meta.items():
        r = results[k]
        kernels.append({
            "name": f"{k} {name}", "route": "cuda", "source": SRC,
            "replaces": f"{PALLAS}:{line}", "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    # K1 carries three paths, each counted from 0: their sum, and each
    kernels[0].update(launches=sum(k1_paths.values()),
                      launches_by_path=k1_paths)
    r = k4[K4_ROWS[0]]   # the live tick's mailbox shape
    kernels.append({
        "name": "K4 ring_step", "route": "cuda", "source": K4_SRC,
        "replaces": K4_REPLACES, "launches": k4_launches + plane_k4,
        "launches_by_path": {"live_tick": k4_launches, "plane": plane_k4},
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    results["K4"] = k4
    detail = {"card": card, "build_s": build_s, "main_path": main_m,
              "entry_delivered": entry_delivered, "live_tick": live_m,
              "sim": sim_m, "routed": routed_m, "live_plane": plane_m,
              "kernels": {k: results[k] for k in results}}
    log("detail " + json.dumps(detail))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
