"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives kubedtn_tpu_torch's main path at the BASELINE size — the
100k-link Clos (200,000 directed rows in capacity 2^18), churned by
batched UpdateLinks and shaped through netem -> TBF by the drop-in step
(kernel K1) and the fused steady-state steps (kernels K2 and K3) — then
holds every kernel against its plain torch version on the card at those
shapes and times both.

Phases, each fatal on failure:
  1. the card (nvidia-smi) and the kernels' build (set-up time);
  2. the Clos on the card;
  3. the main path, with the launch counts set to 0 just before it and
     read just after: UpdateLinks (contiguous and scattered), drop-in
     steps, fused steps with given and with in-kernel uniforms;
  4. K1 and K2 against their plain versions; K3 bit for bit against K2
     fed the same Philox draws, its loss share against the configured
     loss, flag_counts against a host count;
  5. the fat-tree entry step against known one-way delays.

The line before the last lists the kernels with their launches, errors,
times and bounds; the last line is {"ok": true, "device": {...}}. It
exits non-zero, printing neither, when there is no CUDA device or the
package is missing.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks at its 700 W limit: HBM bandwidth and
# non-tensor-core float32 rate (integer work is counted against it too).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per edge and step, counted from csrc/shaping.cu's shape_one
# (arithmetic, compares and selects) and its Philox (two 10-round calls).
OPS_STEP = 80
OPS_PHILOX = 200

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


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing ----------------------------------------------------------------

class Timer:
    """Median device time of a callable. Each rep flushes L2 (a 64 MiB
    write), then parks the stream on a spin kernel while the host
    enqueues the events and the work, so the events bracket device time
    and not the host's dispatch of the first launch."""

    def __init__(self, dev):
        self.flush = torch.empty(16 << 20, dtype=torch.float32, device=dev)

    def ms(self, fn, reps: int = TIME_REPS) -> float:
        fn()  # warm
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


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
                    and (a.device_type == cpu or "shape_step" in a.key)),
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
    b, by = bound_ms(moved, OPS_STEP * E)
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


def tiled_bytes(ts, sizes, act, t_arr, dep, fl, u_t=None):
    state = (ts.props, ts.corr, ts.tokens, ts.t_last, ts.backlog, ts.count)
    extra = (u_t,) if u_t is not None else ()
    # every input read once; depart, flags and the state written once
    return nbytes(*state, sizes, act, t_arr, *extra, dep, fl, *state[1:])


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
    moved = tiled_bytes(ts, sizes, act, t_arr, kern[1], kern[2], u_t)
    b, by = bound_ms(moved, OPS_STEP * E * STEPS)
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
    plain_ms = timer.ms(lambda: shaping.shape_steps_plain(
        ts, sizes, act, t_arr, philox.uniforms(seed, E, STEPS, dev), STEPS),
        reps=3)
    moved = tiled_bytes(ts, sizes, act, t_arr, k3[1], k3[2])
    b, by = bound_ms(moved, (OPS_STEP + OPS_PHILOX) * E * STEPS)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, bytes=moved,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from kubedtn_tpu_torch import _build, entry
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
    entry_delivered = check_entry(dev)

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
    detail = {"card": card, "build_s": build_s, "main_path": main_m,
              "entry_delivered": entry_delivered,
              "kernels": {k: results[k] for k in results}}
    log("detail " + json.dumps(detail))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
