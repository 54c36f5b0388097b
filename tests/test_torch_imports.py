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
    # the operator CLI, the tracer and the CRD rendering
    "kubedtn_tpu_torch.cli", "kubedtn_tpu_torch.utils.tracing",
    "kubedtn_tpu_torch.api.crd",
    # the Kubernetes-facing control plane: the controller manager, the
    # CR bridge and the CNI shim
    "kubedtn_tpu_torch.topology.manager", "kubedtn_tpu_torch.topology.k8s",
    "kubedtn_tpu_torch.cni",
    # the scale path: the edge-sharded step and the sharded router
    "kubedtn_tpu_torch.parallel.sharded", "kubedtn_tpu_torch.parallel.router",
    # the scale path across processes: its worker and spawner
    "kubedtn_tpu_torch.parallel.multihost",
)

# dtnlint for the port and the dispatch probe
ANALYSIS_MODULES = (
    "kubedtn_tpu_torch.analysis", "kubedtn_tpu_torch.analysis.__main__",
    "kubedtn_tpu_torch.analysis.core", "kubedtn_tpu_torch.analysis.callgraph",
    "kubedtn_tpu_torch.analysis.fix", "kubedtn_tpu_torch.analysis.diff",
    "kubedtn_tpu_torch.analysis.passes",
    "kubedtn_tpu_torch.analysis.passes.hygiene",
    "kubedtn_tpu_torch.analysis.passes.lock_discipline",
    "kubedtn_tpu_torch.analysis.passes.host_sync",
    "kubedtn_tpu_torch.analysis.passes.key_discipline",
    "kubedtn_tpu_torch.analysis.passes.traced_purity",
    "kubedtn_tpu_torch.analysis.passes.dtype_drift",
    "kubedtn_tpu_torch.analysis.verify",
    "kubedtn_tpu_torch.analysis.verify.entrypoints",
    "kubedtn_tpu_torch.analysis.verify.dispatch",
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


@pytest.mark.parametrize("want", ANALYSIS_MODULES)
def test_analysis_modules_are_found(want):
    assert want in port_modules()


def test_analysis_loads_no_jax_in_a_fresh_process():
    """Every module of kubedtn_tpu_torch.analysis imported in a fresh
    process, and the suite run over the port's own tree: neither jax
    nor the JAX package is loaded (the analysis parses source, and never
    the JAX tree's)."""
    code = (
        "import importlib, sys\n"
        f"for m in {ANALYSIS_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from kubedtn_tpu_torch.analysis import run_suite\n"
        "_p, f = run_suite(rules=('hygiene', 'lock'))\n"
        "assert f and all(x.path.startswith('kubedtn_tpu_torch/') "
        "for x in f)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'kubedtn_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'kubedtn_tpu.')))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


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


@pytest.mark.parametrize("module", ["kubedtn_tpu_torch.parallel.sharded",
                                    "kubedtn_tpu_torch.parallel.router",
                                    "kubedtn_tpu_torch.parallel.multihost"])
def test_scale_path_module_alone_loads_no_jax(module):
    """The sharded step and the sharded router imported on their own in
    a fresh process (with entry.dryrun_multichip run on 2 CPU shards):
    neither jax nor the JAX package is loaded, and neither source names
    them in an import."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "from kubedtn_tpu_torch import entry\n"
        "entry.dryrun_multichip(2, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'kubedtn_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'kubedtn_tpu.')))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout and "OK" in out.stdout
    path = ROOT / (module.replace(".", "/") + ".py")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            assert not _forbidden(node.module or ""), node.module
        elif isinstance(node, ast.Import):
            assert not any(_forbidden(a.name) for a in node.names)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "tests/_torch_fake_apiserver.py"]))
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


# what `python -m kubedtn_tpu_torch.cli` loads: the module run as
# __main__ with these arguments (each exits through argparse or a verb)
CLI_RUNS = (["--help"], ["daemon", "--help"], ["whatif", "--help"],
            ["crd"], ["manager", "--help"])


@pytest.mark.parametrize("argv", CLI_RUNS, ids=" ".join)
def test_the_cli_loads_no_jax_in_a_fresh_process(argv):
    """`python -m kubedtn_tpu_torch.cli ARGS` as it runs, in a fresh
    process: after it, neither jax nor the JAX package is loaded."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['tpudtn-torch', *{argv!r}]\n"
        "try:\n"
        "    runpy.run_module('kubedtn_tpu_torch.cli', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'kubedtn_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'kubedtn_tpu.')))\n"
        "print('RC', rc, 'BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines()[-1] == "RC 0 BAD []", out.stdout


def test_python_m_cli_help():
    out = subprocess.run([sys.executable, "-m", "kubedtn_tpu_torch.cli",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: tpudtn-torch")
    for verb in ("daemon", "top", "slo", "whatif", "scenario"):
        assert verb in out.stdout
    assert "manager" in out.stdout and "bench" not in out.stdout


def test_fake_apiserver_loads_no_jax_in_a_fresh_process():
    """tests/_torch_fake_apiserver.py (which chip_smoke.py loads by path
    on the card's machine) imports neither jax nor the JAX package, and
    serves a LIST."""
    code = (
        "import importlib.util, json, sys, urllib.request\n"
        "spec = importlib.util.spec_from_file_location('fa', "
        "'tests/_torch_fake_apiserver.py')\n"
        "fa = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(fa)\n"
        "srv = fa.FakeApiServer()\n"
        "host, port = srv.start()\n"
        "url = f'http://{host}:{port}/apis/{fa.GROUP}/{fa.VERSION}/"
        "topologies'\n"
        "body = json.load(urllib.request.urlopen(url, timeout=10))\n"
        "srv.stop()\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'kubedtn_tpu') or m.startswith(('jax.', 'jaxlib.', "
        "'kubedtn_tpu.')))\n"
        "print(body['kind'], 'BAD', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines()[-1] == "TopologyList BAD []", out.stdout


def test_manager_help_in_a_fresh_process():
    """`tpudtn-torch manager --help` (python -m kubedtn_tpu_torch.cli):
    the JAX verb's flags and the port's --device."""
    out = subprocess.run([sys.executable, "-m", "kubedtn_tpu_torch.cli",
                          "manager", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: tpudtn-torch manager")
    for flag in ("--workers", "--probe-port", "--metrics-port",
                 "--leader-elect", "--identity", "--node-ip",
                 "--device {cuda,cpu}"):
        assert flag in out.stdout, flag
