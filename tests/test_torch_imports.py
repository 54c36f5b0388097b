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
                 "kubedtn_tpu_torch.parallel.partition",
                 "kubedtn_tpu_torch.ops.queues",
                 "kubedtn_tpu_torch.models.traffic", "kubedtn_tpu_torch.sim",
                 "kubedtn_tpu_torch.ops.routing",
                 "kubedtn_tpu_torch.router"):
        assert want in mods


# the host live plane's modules
LIVE_PLANE_MODULES = (
    "kubedtn_tpu_torch.contracts", "kubedtn_tpu_torch.utils.logging",
    "kubedtn_tpu_torch.fault", "kubedtn_tpu_torch.pauses",
    "kubedtn_tpu_torch.native", "kubedtn_tpu_torch.topology",
    "kubedtn_tpu_torch.topology.freelist",
    "kubedtn_tpu_torch.topology.store", "kubedtn_tpu_torch.topology.engine",
    "kubedtn_tpu_torch.topology.reconciler", "kubedtn_tpu_torch.wire.proto",
    "kubedtn_tpu_torch.wire.client", "kubedtn_tpu_torch.wire.server",
    # cross-node egress's chaos harness and the pcap tap
    "kubedtn_tpu_torch.chaos", "kubedtn_tpu_torch.utils.pcap",
    # the what-if twin and the planned-update path
    "kubedtn_tpu_torch.twin", "kubedtn_tpu_torch.twin.spec",
    "kubedtn_tpu_torch.twin.snapshot", "kubedtn_tpu_torch.twin.engine",
    "kubedtn_tpu_torch.twin.report", "kubedtn_tpu_torch.twin.query",
    "kubedtn_tpu_torch.updates", "kubedtn_tpu_torch.updates.planner",
    "kubedtn_tpu_torch.updates.gate", "kubedtn_tpu_torch.updates.stager",
    "kubedtn_tpu_torch.updates.service",
    # checkpoint and restart, and the daemon's Prometheus exporter
    "kubedtn_tpu_torch.checkpoint", "kubedtn_tpu_torch.metrics",
    "kubedtn_tpu_torch.metrics.metrics",
    # tenancy and the shared-memory ingest plane
    "kubedtn_tpu_torch.tenancy", "kubedtn_tpu_torch.tenancy.admission",
    "kubedtn_tpu_torch.tenancy.registry", "kubedtn_tpu_torch.shm",
    "kubedtn_tpu_torch.shm.ring", "kubedtn_tpu_torch.shm.ingest",
    "kubedtn_tpu_torch.shm.sender", "kubedtn_tpu_torch.shm.producer",
    # the SLO plane, the autopilot and burn_recovery's scenarios module
    "kubedtn_tpu_torch.slo", "kubedtn_tpu_torch.slo.spec",
    "kubedtn_tpu_torch.slo.tail", "kubedtn_tpu_torch.slo.evaluator",
    "kubedtn_tpu_torch.slo.fleet", "kubedtn_tpu_torch.autopilot",
    "kubedtn_tpu_torch.autopilot.candidates",
    "kubedtn_tpu_torch.autopilot.search",
    "kubedtn_tpu_torch.autopilot.actuator",
    "kubedtn_tpu_torch.autopilot.controller",
    "kubedtn_tpu_torch.scenarios",
    # live tenant migration
    "kubedtn_tpu_torch.federation", "kubedtn_tpu_torch.federation.journal",
    "kubedtn_tpu_torch.federation.migrate",
    # the fleet supervisor and its placement ledger
    "kubedtn_tpu_torch.federation.placement",
    "kubedtn_tpu_torch.federation.supervisor",
)

# the fleet supervisor's surfaces: (module, attribute path)
FLEET_SURFACES = (
    ("kubedtn_tpu_torch.federation.placement", "PlacementLedger"),
    ("kubedtn_tpu_torch.federation.supervisor", "FleetSupervisor"),
    ("kubedtn_tpu_torch.wire.server", "Daemon.FleetStatus"),
    ("kubedtn_tpu_torch.wire.server", "Daemon.FleetUpgrade"),
    ("kubedtn_tpu_torch.wire.server", "Daemon.Health"),
    ("kubedtn_tpu_torch.metrics.metrics", "FleetStatsCollector"),
    ("kubedtn_tpu_torch.entry", "build_fleet"),
    ("kubedtn_tpu_torch.scenarios", "plane_failover"),
    ("kubedtn_tpu_torch.scenarios", "fleet_rolling_upgrade"),
)


@pytest.mark.parametrize("want", LIVE_PLANE_MODULES)
def test_live_plane_modules_are_found(want):
    assert want in port_modules()


@pytest.mark.parametrize("module,attr", FLEET_SURFACES)
def test_fleet_surfaces_exist(module, attr):
    """Each surface of the fleet supervisor is a callable of the port
    (the modules above import neither jax nor the JAX package)."""
    import importlib

    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    assert callable(obj)
    assert obj.__module__.startswith("kubedtn_tpu_torch.")


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
