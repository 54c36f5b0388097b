"""The port stands alone: importing kubedtn_tpu_torch and every module in
it loads neither jax nor the JAX package, and no file of the port (or
chip_smoke.py) names either in an import."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import kubedtn_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "kubedtn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "kubedtn_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        kubedtn_tpu_torch.__path__, prefix="kubedtn_tpu_torch."))


def test_port_modules_are_found():
    mods = port_modules()
    for want in ("kubedtn_tpu_torch.ops.edge_state",
                 "kubedtn_tpu_torch.ops.netem",
                 "kubedtn_tpu_torch.ops.cuda.shaping",
                 "kubedtn_tpu_torch.ops.cuda.philox",
                 "kubedtn_tpu_torch.models.topologies",
                 "kubedtn_tpu_torch.convert", "kubedtn_tpu_torch.entry",
                 "kubedtn_tpu_torch._build",
                 "kubedtn_tpu_torch.api.types",
                 "kubedtn_tpu_torch.ops.scan", "kubedtn_tpu_torch.runtime",
                 "kubedtn_tpu_torch.telemetry",
                 "kubedtn_tpu_torch.parallel.exchange",
                 "kubedtn_tpu_torch.parallel.mesh",
                 "kubedtn_tpu_torch.parallel.partition"):
        assert want in mods


def test_import_loads_no_jax_in_a_fresh_process():
    """A subprocess, because this test process already imported jax
    (tests/conftest.py)."""
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'kubedtn_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'kubedtn_tpu.')))\n"
        "print('LOADED', len(sys.modules), 'BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"
