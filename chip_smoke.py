"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives kubedtn_tpu_torch's main path at the BASELINE size — the
100k-link Clos (200,000 directed rows in capacity 2^18), churned by
batched UpdateLinks and shaped through netem -> TBF by the drop-in step
(kernel K1) and the fused steady-state steps (kernels K2 and K3) — then
the live tick's device program on the same Clos, unsharded and sharded
(its mailbox ring steps are kernel K4), and holds every kernel against
its plain torch version on the card at those shapes and times both.

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
     bound and torch.roll.

The line before the last lists the kernels with their launches, errors,
times and bounds; the last line is {"ok": true, "device": {...}}. It
exits non-zero, printing neither, when there is no CUDA device or the
package is missing.
"""

from __future__ import annotations

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
                                             for k, v in by_op[:6]]}
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
    fresh = es.EdgeState(**{k: v.clone() for k, v in vars(state).items()})

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
    """Nested tuples / lists / dicts of tensors (or plain values), bit for
    bit; a tensor pair may lie on two devices."""
    if isinstance(a, dict):
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
    r = k4[K4_ROWS[0]]   # the live tick's mailbox shape
    kernels.append({
        "name": "K4 ring_step", "route": "cuda", "source": K4_SRC,
        "replaces": K4_REPLACES, "launches": k4_launches,
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    results["K4"] = k4
    detail = {"card": card, "build_s": build_s, "main_path": main_m,
              "entry_delivered": entry_delivered, "live_tick": live_m,
              "kernels": {k: results[k] for k in results}}
    log("detail " + json.dumps(detail))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
