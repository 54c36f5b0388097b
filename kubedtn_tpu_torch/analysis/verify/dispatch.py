"""The dispatch probe — the runtime half of the dispatch contract.

The port's counterpart of kubedtn_tpu/analysis/verify/dispatch.py. The
JAX package pins "one compiled dispatch per tick"; the port's tick is
many launches, so this probe reports, per steady tick of the canonical
probe plane (entrypoints.build_probe_plane; fresh ingress on all three
kernel classes every tick, warm-up ticks first):

(a) calls into the hand-written-kernel wrappers, by kernel: the module
    attributes of `KERNEL_WRAPPERS` are wrapped by counters, as the JAX
    probe wraps jitted callables (attribute-level, so calls resolved
    through module globals at call time are all seen). These count on
    any device: on the CPU a wrapper runs its kernel's plain version.
(b) on the card, the kernels' launch counters (ops/cuda/shaping.LAUNCHES,
    parallel/exchange.LAUNCHES) over the same ticks. (b) must equal (a):
    anything else means a kernel quietly gave way to its plain version.
(c) on the card, the CUDA kernels the ticks launch, by name, from
    torch.profiler (reported, not pinned).
(d) on the card, the host syncs on the dispatch side: each counted
    tick's `WireDataPlane._dispatch` runs under
    `torch.cuda.set_sync_debug_mode("warn")`, and each warning's Python
    stack is kept. A site is the innermost frame of the package; the
    contract is that every site lies under a `sync-ok(...)` waiver of
    the static sync pass (passes/host_sync.py), which ties this runtime
    half to the static half.

The sync-debug mode is process-wide: the probe drives
`plane.tick(now_s=...)` from the caller with no runner thread, and puts
the mode back to "default" in a `finally`.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
import traceback
import warnings
from pathlib import Path

# (module, attribute, kernel) of every hand-written-kernel wrapper the
# tick can reach; the kernel is the key of its module's LAUNCHES, and
# None for the K2/K3 wrapper (K2 with given uniforms, K3 without)
KERNEL_WRAPPERS = (
    ("kubedtn_tpu_torch.ops.cuda.shaping", "shape_step_flags",
     "shape_step_rows"),
    ("kubedtn_tpu_torch.ops.cuda.shaping", "shape_steps_tiled", None),
    ("kubedtn_tpu_torch.parallel.exchange", "ring_right_shift",
     "ring_step"),
)
LAUNCH_COUNTERS = ("kubedtn_tpu_torch.ops.cuda.shaping",
                   "kubedtn_tpu_torch.parallel.exchange")
KERNELS = ("shape_step_rows", "shape_steps_cols", "shape_steps_cols_philox",
           "ring_step")

FEED_FRAMES = 8        # frames per ingress wire and tick
FRAME_BYTES = 64
# the JAX probe warms up 4 ticks and counts 3; 2 and 1 keep every count
# exact (a steady tick's counts do not vary) at a fraction of the card
# time, most of which is reading the profiler's events: the warm-up
# fills the depth-2 pipeline and takes a sharded plane's first dispatch,
# which runs its exchange probe
WARMUP_TICKS = 2
COUNTED_TICKS = 1
DRAIN_TICKS = 8        # idle ticks (16 ms) that empty the delay line
T0_S = 100.0

_PKG = Path(__file__).resolve().parents[2]        # kubedtn_tpu_torch/
_SELF = Path(__file__).resolve().parent.parent    # analysis/


def _tiled_kernel(args, kwargs) -> str:
    u_t = kwargs.get("u_t", args[6] if len(args) > 6 else None)
    return "shape_steps_cols" if u_t is not None else \
        "shape_steps_cols_philox"


class KernelCalls:
    """Counts calls into the KERNEL_WRAPPERS while installed (a context
    manager); `calls` maps a kernel to its count."""

    def __init__(self) -> None:
        self.calls = dict.fromkeys(KERNELS, 0)
        self._patched: list = []

    def __enter__(self) -> "KernelCalls":
        for mod_name, attr, kernel in KERNEL_WRAPPERS:
            mod = importlib.import_module(mod_name)
            real = getattr(mod, attr)

            def counted(*a, _real=real, _kernel=kernel, **k):
                name = _kernel or _tiled_kernel(a, k)
                self.calls[name] += 1
                return _real(*a, **k)

            counted.__wrapped__ = real
            self._patched.append((mod, attr, real))
            setattr(mod, attr, counted)
        return self

    def __exit__(self, *exc) -> None:
        for mod, attr, real in reversed(self._patched):
            setattr(mod, attr, real)
        self._patched.clear()


def launch_counts() -> dict:
    out = {}
    for mod_name in LAUNCH_COUNTERS:
        out.update(importlib.import_module(mod_name).LAUNCHES)
    return out


class SyncSites:
    """Wraps `plane._dispatch` so that each call runs under
    torch.cuda.set_sync_debug_mode("warn") and records where each
    synchronizing CUDA operation was issued from. Only meaningful on
    the card (the CPU never syncs)."""

    def __init__(self, plane) -> None:
        self.plane = plane
        self.sites: dict[tuple, dict] = {}

    def _site(self, stack) -> tuple:
        inner = None
        for fr in stack:
            p = Path(fr.filename).resolve()
            if p.is_relative_to(_PKG) and not p.is_relative_to(_SELF):
                inner = (p.relative_to(_PKG.parent).as_posix(), fr.lineno,
                         fr.name)
        return inner or ("<outside the package>", 0, "")

    def __enter__(self) -> "SyncSites":
        import torch

        real = self.plane._dispatch

        def dispatch(*a, **k):
            seen = []

            def record(message, category, filename, lineno, file=None,
                       line=None):
                # the mode's own notice ("a prototype feature") is not a
                # sync
                if "called a synchronizing" in str(message):
                    seen.append((str(message), traceback.extract_stack()))

            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    return real(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    for message, stack in seen:
                        key = self._site(stack)
                        s = self.sites.setdefault(key, {
                            "path": key[0], "line": key[1],
                            "function": key[2], "count": 0,
                            "message": message.splitlines()[0][:200],
                            "stack": [f"{f.filename}:{f.lineno} {f.name}"
                                      for f in stack[-8:-1]]})
                        s["count"] += 1

        self.plane._dispatch = dispatch
        return self

    def __exit__(self, *exc) -> None:
        del self.plane._dispatch   # the class's method again


def waived_sites(sites: list[dict]) -> list[dict]:
    """Each site with `waiver`: the reason of the static sync pass's
    `sync-ok(...)` waiver that covers its line in the package's source
    (the line, the line above or an enclosing def), or None."""
    from kubedtn_tpu_torch.analysis import default_root
    from kubedtn_tpu_torch.analysis.core import RULE_SYNC, SourceFile

    root = default_root()
    files: dict = {}
    out = []
    for s in sites:
        p = root / s["path"]
        reason = None
        if p.is_file():
            src = files.get(p) or files.setdefault(p, SourceFile(root, p))
            reason = src.waiver_for(RULE_SYNC, s["line"])
        out.append({**s, "waiver": reason})
    return out


def probe_frames(wire: int, tick: int) -> list[bytes]:
    """The probe's ingress for one wire and tick: FEED_FRAMES frames of
    FRAME_BYTES whose first bytes tag (wire, tick, index)."""
    return [bytes([wire, tick % 256]) + j.to_bytes(2, "big")
            + b"\x07" * (FRAME_BYTES - 4) for j in range(FEED_FRAMES)]


def cuda_kernels(prof) -> tuple[dict, int]:
    """(name -> launches of the CUDA kernels, number of copies and
    fills) a torch.profiler run saw."""
    from torch.autograd import DeviceType

    out: dict = {}
    copies = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            out[e.name] = out.get(e.name, 0) + 1
    return out, copies


def probe_plane(depth: int = 1, shards: int = 0, device=None) -> dict:
    """Drive the probe plane (`shards` virtual shards of its device when
    > 1) for WARMUP_TICKS fed ticks, then COUNTED_TICKS counted fed
    ticks, then DRAIN_TICKS idle ticks and a flush. Returns the counted
    window's (a)-(d) (`calls`, `launches`, `cuda_kernels`, `syncs`; the
    last three only on the card), the delivered frames per egress wire
    and the plane's counters."""
    import numpy as np
    import torch

    from kubedtn_tpu_torch.analysis.verify.entrypoints import (
        PROBE_DT_US,
        build_probe_plane,
    )

    t0 = time.perf_counter()
    seconds = {}

    def lap(part: str) -> None:
        nonlocal t0
        t1 = time.perf_counter()
        seconds[part] = t1 - t0
        t0 = t1

    plane, win, wout = build_probe_plane(depth=depth, device=device)
    on_card = plane.device.type == "cuda"
    warmup, ticks = WARMUP_TICKS, COUNTED_TICKS
    if shards > 1:
        plane.enable_sharding([plane.device] * shards)
    dt_s = PROBE_DT_US / 1e6
    egress: list[list[bytes]] = [[] for _ in wout]

    def one_tick(i: int, feed: bool = True) -> None:
        if feed:
            for k, w in enumerate(win):
                w.ingress.extend(probe_frames(k, i))
        plane.tick(now_s=T0_S + (i + 1) * dt_s)
        for k, w in enumerate(wout):
            while w.egress:
                egress[k].append(w.egress.popleft())

    lap("build")
    for i in range(warmup):
        one_tick(i)
    if on_card:
        torch.cuda.synchronize()
    lap("warmup")
    l0 = launch_counts()
    prof = None
    with KernelCalls() as kc:
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            with SyncSites(plane) as ss, \
                    profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(warmup, warmup + ticks):
                    one_tick(i)
                torch.cuda.synchronize()
            syncs = waived_sites(list(ss.sites.values()))
        else:
            for i in range(warmup, warmup + ticks):
                one_tick(i)
            syncs = None
    l1 = launch_counts()
    launches = {k: l1[k] - l0[k] for k in KERNELS}
    lap("counted")
    for i in range(warmup + ticks, warmup + ticks + DRAIN_TICKS):
        one_tick(i, feed=False)
    plane.flush()
    for k, w in enumerate(wout):
        while w.egress:
            egress[k].append(w.egress.popleft())
    lap("drain")
    kernels, copies = (cuda_kernels(prof) if prof is not None
                       else (None, None))
    lap("profile_read")
    c = plane.counters
    return {
        "depth": depth, "shards": shards, "ticks": ticks,
        "device": str(plane.device),
        "calls": dict(kc.calls),
        "launches": launches if on_card else None,
        "calls_per_tick": {k: v / ticks for k, v in kc.calls.items()},
        "cuda_kernels": kernels,
        "cuda_kernels_per_tick": (None if kernels is None
                                  else sum(kernels.values()) / ticks),
        "cuda_copies_per_tick": None if copies is None else copies / ticks,
        "seconds": seconds,
        "syncs": syncs,
        "egress": egress,
        "counters": {f.name: np.array(getattr(c, f.name), copy=True)
                     for f in dataclasses.fields(c)},
        "tick_errors": plane.tick_errors,
    }
