"""Times the fused shaping kernels (K2, K3) and the mailbox ring step (K4)
on one card, and counts K2's and K3's compiled instructions per step.

    python3 kubedtn_tpu_torch/kernel_bench.py [--root DIR] [--tag NAME]
                                              [--out FILE] [--timeline]

`--root` is the directory whose `kubedtn_tpu_torch` package is imported
(default: the checkout this file lies in), so the same script measures
another tree, e.g. a parent commit unpacked with `git archive`: run it
on both trees in turns inside one call (parent, change, change, parent)
to compare them on one card.

What it measures, on the main path's inputs (the 100k-link Clos with
fresh qdiscs, E = 2^18, tiled as chip_smoke.py tiles it):
  - K3 at S = 1, 2, 5 and 10 steps per launch, so that a fit
    T(S) = a + b*S splits the per-edge cost (loads, state write-back)
    from the per-step cost (two Philox calls, shape_one, two stores);
  - K2 at S = 1 and 10;
  - K4, one ring step on 4 virtual shards of the card, at R = 4,096 and
    32,768 rows of 24 words, beside torch.roll over the stacked mailbox
    (the same function in one PyTorch call), with its launches per step;
  - the SASS of the built shaping library (`cuobjdump -sass`): for K2
    and K3 the instructions of each loop (a backward branch and its
    target) with their opcodes, and each kernel's ptxas report;
  - with `--timeline`, one K3 launch (S = 10) from a copy of
    csrc/shaping.cu with %globaltimer stamps per block (start, inputs in
    registers, state written back, SM): where a launch's time goes.

Times are CUDA events around one launch, median of 15, L2 flushed before
it by a write (the Timer chip_smoke.py uses too) and, for some, by a
read (see Timer). Prints one JSON object as its last line and writes it
to `--out` when given, with each kernel's SASS beside it. Needs a CUDA
card; fails without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

K3_STEPS = (1, 2, 5, 10)
K2_STEPS = (1, 10)
K4_SHARDS = 4
K4_ROWS = (4096, 32768)
MAIL_WORDS = 24
REPS = 15


class Timer:
    """Median device ms of one call, the stream parked on a spin kernel
    while the events and the call are queued, L2 flushed before it:

    - "write" (what chip_smoke.py times with): a 64 MiB write, which
      leaves L2 full of dirty lines that the call's own traffic must
      write back;
    - "read": a 64 MiB read, which leaves L2 full of clean lines of an
      unrelated buffer: the call's inputs are still cold, and it pays
      for no one else's write-backs."""

    def __init__(self, dev, flush: str = "write"):
        self.flush = torch.zeros(16 << 20, dtype=torch.float32, device=dev)
        self.kind = flush

    def ms(self, fn, reps: int = REPS) -> float:
        fn()  # warm
        times = []
        for _ in range(reps):
            if self.kind == "write":
                self.flush.zero_()
            else:
                self.flush.sum()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def fit_line(xs, ys):
    """Least-squares (a, b) of y = a + b*x."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
    return my - b * mx, b


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b(?:\.\S+)?\s+(?:`\()?(0x[0-9a-f]+)")


def sass_functions(so_path: str, cuobjdump: str) -> dict:
    """{mangled name: [(address, instruction text)]} of a library."""
    return parse_sass(subprocess.run([cuobjdump, "-sass", so_path],
                                     capture_output=True, text=True,
                                     check=True).stdout)


def parse_sass(out: str) -> dict:
    """{mangled name: [(address, instruction text)]} of `cuobjdump -sass`
    output."""
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _SASS_LINE.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def opcode(text: str) -> str:
    t = re.sub(r"^@!?U?P\w+\s+", "", text.strip())
    return t.split()[0] if t else ""


def loops(instrs) -> list:
    """Every backward branch: its target, its address, the instructions
    from the target to the branch inclusive, and their opcode counts."""
    out = []
    for addr, text in instrs:
        m = _BRA.search(text)
        if not m:
            continue
        tgt = int(m.group(1), 16)
        if tgt >= addr:
            continue
        body = [t for a, t in instrs if tgt <= a <= addr]
        ops = collections.Counter(opcode(t) for t in body)
        out.append({"target": hex(tgt), "branch": hex(addr),
                    "instructions": len(body),
                    "opcodes": dict(ops.most_common())})
    return out


def sass_report(_build, out_dir: Path | None) -> dict:
    nvcc = Path(_build.nvcc())
    cuobjdump = str(nvcc.parent / "cuobjdump")
    so = str(_build._target("shaping"))
    funcs = sass_functions(so, cuobjdump)
    rep = {}
    for name, instrs in funcs.items():
        kind = ("K3" if "Philox" in name else "K2" if "Given" in name
                else "K1" if "rows" in name else name)
        rep[kind] = {"function": name, "instructions": len(instrs),
                     "loops": loops(instrs)}
        if out_dir is not None:
            (out_dir / f"sass_{kind}.txt").write_text(
                "\n".join(f"{a:06x}  {t}" for a, t in instrs) + "\n")
    log = _build.log_path("shaping").read_text().splitlines()
    rep["ptxas"] = [ln.strip() for ln in log
                    if "registers" in ln or "entry function" in ln
                    or "spill" in ln]
    return rep


# -- --timeline: an instrumented copy of K3 ------------------------------

_STAMPS = """
__device__ unsigned long long kdt_stamps[1 << 16];
__device__ __forceinline__ unsigned long long kdt_now(float dep) {
  unsigned long long t;
  asm volatile("{ .reg .f32 d; add.f32 d, %1, 0f00000000; }\\n\\t"
               "mov.u64 %0, %%globaltimer;" : "=l"(t) : "f"(dep));
  return t;
}
"""
_START = "  if (e >= E) return;\n  if (act_in[e] <= 0) {\n"
_SETTLED = ("      flags[static_cast<size_t>(s) * E + e] = 0;\n    }\n"
            "    return;")
_LOADED = "  const float ta = t_arr[e];\n"
_END = "  count[e] = st.cnt;\n}"


def instrumented_source(src: str) -> str:
    """csrc/shaping.cu with globaltimer stamps in the K2/K3 kernel, per
    block (thread 0): start, inputs in registers, state written back
    (both at once for an inactive edge), and the SM it ran on. Raises if
    the kernel no longer has the anchors."""
    head = "template <class Uniforms>\n__global__ void __launch_bounds__"
    k = src.index(head, src.index("shape_step_rows"))
    body = src[k:]
    if any(body.count(a) != 1 for a in (_START, _SETTLED, _LOADED, _END)):
        raise RuntimeError("kernel_bench --timeline: csrc/shaping.cu's "
                           "K2/K3 kernel has changed; update its anchors")
    stamp = "    if (threadIdx.x == 0) kdt_stamps[blockIdx.x * 4 + {}] = {};\n"
    body = body.replace(_START, (
        "  if (threadIdx.x == 0) {\n"
        "    unsigned sm;\n    asm volatile(\"mov.u32 %0, %%smid;\" : "
        "\"=r\"(sm));\n"
        "    kdt_stamps[blockIdx.x * 4] = kdt_now(0.0f);\n"
        "    kdt_stamps[blockIdx.x * 4 + 3] = sm;\n  }\n" + _START))
    settled = _SETTLED.replace("    return;", "")
    body = body.replace(_SETTLED, settled + "    {\n"
                        "    const unsigned long long t = kdt_now(0.0f);\n"
                        + stamp.format(1, "t") + stamp.format(2, "t")
                        + "    }\n    return;")
    # every input word feeds the stamp, so it is taken once all landed
    body = body.replace(_LOADED, _LOADED + (
        "  {\n    float dep = size + ta + st.tokens + st.t_last"
        " + st.next_free + static_cast<float>(st.cnt);\n"
        "    for (int k = 0; k < NPROP; ++k) dep += p[k];\n"
        "    for (int k = 0; k < NCORR; ++k) dep += st.c[k];\n"
        "    const unsigned long long t = kdt_now(dep);\n"
        + stamp.format(1, "t") + "  }\n"))
    body = body.replace(_END, "  count[e] = st.cnt;\n"
                        + stamp.format(2, "kdt_now(st.tokens)") + "}")
    out = src[:k] + _STAMPS + body
    return out + """
extern "C" int kdt_copy_stamps(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, kdt_stamps, n * 8));
}
"""


def timeline(_build, ts, sizes, act, t_arr, out_dir) -> dict:
    """Per-block stamps of one K3 launch (S = 10, L2 flushed by a write,
    as Timer does), built from an instrumented copy of csrc/shaping.cu."""
    import ctypes
    import numpy as np

    build = _build.BUILD_DIR / "timeline"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "shaping_timeline.cu"
    src.write_text(instrumented_source(
        (_build.CSRC / "shaping.cu").read_text()))
    so = build / "libshaping_timeline.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.kdt_shape_steps_cols_philox
    fn.argtypes = _build.SIGNATURES["shaping"]["kdt_shape_steps_cols_philox"]
    lib.kdt_copy_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    E, S = ts.capacity, 10
    dev = ts.tokens.device
    dep = torch.empty((S, E), dtype=torch.float32, device=dev)
    fl = torch.empty((S, E), dtype=torch.int32, device=dev)
    flush = torch.zeros(16 << 20, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(3):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        _build.check(fn(12345, ts.props.data_ptr(), ts.corr.data_ptr(),
                        ts.tokens.data_ptr(), ts.t_last.data_ptr(),
                        ts.backlog.data_ptr(), ts.count.data_ptr(),
                        sizes.data_ptr(), t_arr.data_ptr(), act.data_ptr(),
                        dep.data_ptr(), fl.data_ptr(), E, S, stream),
                     "instrumented K3")
        torch.cuda.synchronize()
    n_blocks = (E + 255) // 256
    buf = np.zeros(n_blocks * 4, dtype=np.int64)
    _build.check(lib.kdt_copy_stamps(buf.ctypes.data, buf.size), "stamps")
    st, rd, dn, sm = buf.reshape(n_blocks, 4).T
    t0 = st.min()
    st, rd, dn = ((x - t0) / 1e3 for x in (st, rd, dn))  # us
    q = (lambda x: [round(float(v), 2) for v in
                    np.quantile(x, [0, 0.1, 0.5, 0.9, 1])])
    n_sm = int(sm.max()) + 1
    per_sm_end = np.array([dn[sm == i].max() for i in range(n_sm)
                           if (sm == i).any()])
    busy = np.array([(dn - rd)[sm == i].sum() for i in range(n_sm)
                     if (sm == i).any()])
    first = st < np.quantile(st, 0.25) + 1.0  # blocks of the first wave
    rep = {"quantiles": "min, p10, median, p90, max (us)",
           "block_start": q(st), "load": q(rd - st), "compute": q(dn - rd),
           "block_done": q(dn), "per_sm_end": q(per_sm_end),
           "blocks_per_sm": q(np.bincount(sm)),
           "first_wave_blocks": int(first.sum()),
           "per_sm_compute_sum_over_end": q(busy / per_sm_end),
           "span_us": float(dn.max())}
    if out_dir is not None:
        np.savetxt(out_dir / "timeline_stamps.txt",
                   np.stack([st, rd, dn, sm], 1), fmt="%.3f")
    return rep


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeline", action="store_true",
                    help="also stamp one K3 launch per block (an "
                    "instrumented copy of csrc/shaping.cu)")
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    # import the package of --root, never this file's own directory
    sys.path[0] = root

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is available", file=sys.stderr)
        return 2
    from kubedtn_tpu_torch import _build, entry
    from kubedtn_tpu_torch.ops import netem
    from kubedtn_tpu_torch.ops.cuda import shaping
    from kubedtn_tpu_torch.parallel import exchange as pex
    from kubedtn_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda")
    res = {"tag": args.tag, "root": root, "card": card_line(),
           "package": str(Path(_build.__file__).parent)}
    _build.build_all()
    out_dir = Path(args.out).parent if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        if args.tag:
            out_dir = out_dir / f"sass_{args.tag}"
            out_dir.mkdir(exist_ok=True)
    res["sass"] = sass_report(_build, out_dir)
    res["exchange_ptxas"] = [
        ln.strip() for ln in _build.log_path("exchange").read_text()
        .splitlines() if "registers" in ln or "spill" in ln
        or "entry function" in ln]
    timer = Timer(dev)

    _, state, _ = entry.build_clos_100k()
    ts = shaping.tile_state(state)
    E = ts.capacity
    g = torch.Generator(device=dev).manual_seed(11)
    sizes = shaping.tile_vec(torch.tensor([64.0, 512.0, 1500.0], device=dev)[
        torch.randint(0, 3, (E,), generator=g, device=dev)], ts)
    act = shaping.tile_vec(state.active.to(torch.int32), ts)
    t_arr = shaping.tile_vec(torch.zeros(E, device=dev), ts)

    def fresh():
        return shaping.TiledShapeState(
            **{k: v.clone() for k, v in vars(ts).items()})

    readt = Timer(dev, "read")
    for key, tm, steps in (("K3_ms", timer, K3_STEPS),
                           ("K3_read_flush_ms", readt, (1, 10))):
        k3 = {}
        for S in steps:
            work = fresh()
            k3[S] = tm.ms(lambda: shaping.shape_steps_tiled(
                work, sizes, act, t_arr, 12345, S))
        res[key] = {str(s): v for s, v in k3.items()}
        if len(steps) > 2:
            a, b = fit_line(list(k3), list(k3.values()))
            res["K3_fit_ms"] = {"a_per_launch": a, "b_per_step": b}
    for key, tm, steps in (("K2_ms", timer, K2_STEPS),
                           ("K2_read_flush_ms", readt, (10,))):
        k2 = {}
        for S in steps:
            u_t = torch.rand((S * netem.NU, E), generator=g, device=dev)
            work = fresh()
            k2[S] = tm.ms(lambda: shaping.shape_steps_tiled(
                work, sizes, act, t_arr, 0, S, u_t))
        res[key] = {str(s): v for s, v in k2.items()}

    if args.timeline:
        res["K3_timeline"] = timeline(_build, fresh(), sizes, act, t_arr,
                                      out_dir)

    mesh = make_mesh([dev] * K4_SHARDS)
    k4 = {}
    for R in K4_ROWS:
        gg = torch.Generator(device=dev).manual_seed(R)
        blocks = [torch.randint(-2 ** 31, 2 ** 31 - 1, (R, MAIL_WORDS),
                                generator=gg, dtype=torch.int32, device=dev)
                  for _ in range(K4_SHARDS)]
        stacked = torch.stack(blocks)
        got = pex.ring_right_shift(blocks, mesh)
        torch.cuda.synchronize()
        ok = all(torch.equal(x, y) for x, y in
                 zip(got, torch.roll(stacked, 1, 0)))
        before = pex.LAUNCHES["ring_step"]
        pex.ring_right_shift(blocks, mesh)
        per_step = pex.LAUNCHES["ring_step"] - before
        k4[str(R)] = {
            "ms": timer.ms(lambda: pex.ring_right_shift(blocks, mesh)),
            "roll_ms": timer.ms(lambda: torch.roll(stacked, 1, 0)),
            "read_flush_ms": readt.ms(
                lambda: pex.ring_right_shift(blocks, mesh)),
            "read_flush_roll_ms": readt.ms(
                lambda: torch.roll(stacked, 1, 0)),
            "launches_per_step": per_step, "equal_to_roll": ok,
            "bytes": 2 * sum(x.numel() * 4 for x in blocks)}
    res["K4"] = k4
    line = json.dumps(res)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
