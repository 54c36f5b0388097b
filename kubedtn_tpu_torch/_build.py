"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Every `ops/cuda/csrc/*.cu` file becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
Hopper only:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false ...

`--fmad=false` and the absence of `--use_fast_math` are deliberate: the
kernels must round every operation as the plain torch versions do (see
the note at the top of csrc/shaping.cu).

Libraries are built at first use into `kubedtn_tpu_torch/_build/`, from
the sources in the package alone, under a name that carries a hash of the
source and the flags, so an edited source is never served a stale build.
`build_all()` starts one nvcc per source at once. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "ops" / "cuda" / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "--fmad=false", "--ftz=false", "--prec-div=true",
    "--prec-sqrt=true", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

# C signatures of every exported function, by library.
SIGNATURES = {
    "shaping": {
        "kdt_shape_step_rows": [_P] * 18 + [_I, _I, _P],
        "kdt_shape_steps_cols": [_P] * 12 + [_I, _I, _P],
        "kdt_shape_steps_cols_philox": [ctypes.c_uint32] + [_P] * 11
        + [_I, _I, _P],
    },
    "exchange": {
        "kdt_ring_step": [_P, _P, _I, _I, _P],
        "kdt_enable_peer": [_I, _I],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                       "toolkit's bin directory on PATH")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """nvcc's output of the last build of `name` (ptxas register and
    spill report included)."""
    return BUILD_DIR / f"{name}.log"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (process, temporary output, target) or None."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    log_path(name).write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half


def build_all() -> list[str]:
    """Build every csrc/*.cu at once (one nvcc each) and load them.
    Returns the library names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    for n in names:
        library(n)
    return names


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu (built if missing),
    with argtypes/restype set for every exported function."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    job = _start(name)
    if job is not None:
        _finish(name, job)
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _loaded[name] = lib  # dtnlint: purity-ok(the loaded-library cache: a kernel's first launch builds and loads its library once per process, and no output depends on it)
    return lib


def load_seconds(name: str) -> float:
    """Seconds that building and loading csrc/<name>.cu took in this
    call: 0.0 when the library was loaded before."""
    if name in _loaded:
        return 0.0
    t0 = time.perf_counter()
    library(name)
    return time.perf_counter() - t0


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{rc}")
