"""The port's CLI (kubedtn_tpu_torch/cli.py) held against the JAX CLI
(kubedtn_tpu/cli.py), both driven in this process through main(argv)
with capsys.

- The parser: every JAX subcommand, positional, flag, default and choice
  is the port's too; the port lacks `bench` and adds `--device` (the
  verbs that build an engine, `manager` among them) and `--profile` (the
  daemon's, with `--jax-profile` its alias): exactly those three names.
- The local verbs print the same bytes and exit with the same codes;
  `whatif --file` ranks the same and its floats agree within the
  results tolerance (rtol 1e-5 / atol 1e-2).
- The client verbs: both CLIs in turn against one port daemon served on
  127.0.0.1 (quiescent: explicit-clock ticks, no sidecar thread), the
  same stdout. The fields that still differ are masked by name, each
  with its reason (wall-clock readings taken per call). Verbs that
  change the daemon (plan, apply --plan, physical-join) run against two
  port daemons built the same way, one per CLI.
- End to end: `top --json` and `tenant stats` of the port CLI on a port
  daemon == the JAX CLI on a JAX daemon built and fed the same way.
- `scenario`: _coerce_params as JAX's, the ported ladder in JAX's order,
  a JAX scenario not ported yet refused by name.
- No fallback: without a card and without `--device cpu` every verb
  that builds an engine exits 2, and the daemon binds nothing.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import socket

import numpy as np
import pytest
import yaml

from kubedtn_tpu import cli as jcli
from kubedtn_tpu_torch import cli as tcli

from _torch_tenant_harness import mods, tenant_plane

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = os.path.join(ROOT, "config", "samples")
RING4 = os.path.join(SAMPLES, "ring4.yaml")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    """The JAX CLI points jax's persistent compilation cache into HOME on
    every main(); a test must not write there."""
    monkeypatch.setattr(jcli, "_setup_compile_cache", lambda: None)


def run(capsys, mod, argv) -> tuple:
    capsys.readouterr()
    rc = mod.main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def pair(capsys, argv, port_extra=()) -> tuple:
    """(JAX's (rc, out, err), the port's) for the same argv; the port
    gets `port_extra` appended (its --device)."""
    return (run(capsys, jcli, argv),
            run(capsys, tcli, [*argv, *port_extra]))


# -- the parser ---------------------------------------------------------------


class _Captured(Exception):
    pass


def jax_parser():
    """The JAX CLI's parser, taken at its parse_args call (main builds
    it inline)."""
    box = {}

    def grab(self, args=None, namespace=None):
        box["p"] = self
        raise _Captured

    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser, "parse_args", grab)
    try:
        with pytest.raises(_Captured):
            jcli.main([])
    finally:
        mp.undo()
    return box["p"]


def describe(parser) -> dict:
    """{subcommand: {key: action fields}}; key = the option strings
    (options) or the dest (positionals)."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, sp in sub.choices.items():
        acts = {}
        for a in sp._actions:
            if isinstance(a, argparse._HelpAction):
                continue
            acts[tuple(a.option_strings) or a.dest] = {
                "dest": a.dest, "default": a.default,
                "choices": tuple(a.choices) if a.choices else None,
                "nargs": a.nargs, "const": a.const,
                "required": a.required, "action": type(a).__name__,
                "type": getattr(a.type, "__name__", a.type)}
        out[name] = acts
    return out


def test_parser_differs_from_jax_by_exactly_four_names():
    j = describe(jax_parser())
    t = describe(tcli.build_parser())
    assert tcli.build_parser().prog == "tpudtn-torch"
    diff = set(j) - set(t)
    assert not set(t) - set(j)
    for verb in set(j) & set(t):
        matched = set()
        for key, want in j[verb].items():
            if isinstance(key, str):      # a positional
                got = t[verb].get(key)
                tkey = key
            else:
                tkey = next((k for k in t[verb] if not isinstance(k, str)
                             and set(key) <= set(k)), None)
                got = t[verb].get(tkey)
            assert got is not None, f"{verb} {key} missing in the port"
            matched.add(tkey)
            if key == ("--jax-profile",):
                # the same flag, renamed: --profile, --jax-profile its
                # alias (its value lands in args.profile)
                assert tkey == ("--profile", "--jax-profile")
                diff.add("--profile")
                want = dict(want, dest="profile")
            assert got == want, f"{verb} {key}: {got} != {want}"
        extra = [k for k in t[verb] if k not in matched]
        for k in extra:
            assert k == ("--device",), f"{verb} adds {k}"
            assert t[verb][k]["choices"] == ("cuda", "cpu")
            assert t[verb][k]["default"] == "cuda"
            diff.add("--device")
    assert diff == {"bench", "--device", "--profile"}
    with_device = {v for v in t if ("--device",) in t[v]}
    assert with_device == {"daemon", "manager", "apply", "ping", "trace",
                           "whatif", "scenario"}


def test_jax_profile_is_the_profile_flag():
    p = tcli.build_parser()
    a = p.parse_args(["daemon", "--jax-profile", "/x"])
    b = p.parse_args(["daemon", "--profile", "/x"])
    assert a.profile == b.profile == "/x"
    assert p.parse_args(["daemon"]).device == "cuda"


# -- the local verbs ----------------------------------------------------------


@pytest.mark.parametrize("sample", ["ring4.yaml", "impairments.yaml"])
def test_apply_prints_what_jax_prints(capsys, sample):
    j, t = pair(capsys, ["apply", os.path.join(SAMPLES, sample)], CPU)
    assert t == j and j[0] == 0
    assert json.loads(t[1])["links_realized"] > 0


def test_apply_without_a_file_or_plan_like_jax(capsys):
    j, t = pair(capsys, ["apply"], CPU)
    assert t == j and j[0] == 1


GEN = {
    "line": ["n=4"], "ring": ["n=5"], "star": ["n_leaves=3"],
    "full_mesh": ["n=4"], "random_mesh": ["n_nodes=6", "n_links=8"],
    "fat_tree": ["k=4"], "clos": ["n_spine=2", "n_leaf=3"],
    "torus": ["dims=2x3"], "hypercube": ["d=3"],
    "dragonfly": ["groups=3", "routers_per_group=2"],
    "barabasi_albert": ["n=8"], "watts_strogatz": ["n=8"],
    "geo_wan": ["n=6"],
}


@pytest.mark.parametrize("family", sorted(GEN))
def test_gen_prints_what_jax_prints(capsys, family):
    from kubedtn_tpu.models.topologies import FAMILIES

    assert sorted(GEN) == sorted(FAMILIES)
    argv = ["gen", family] + [x for kv in GEN[family] for x in ("-p", kv)]
    j, t = pair(capsys, argv)
    assert t == j and j[0] == 0
    assert yaml.safe_load_all(t[1])


def test_gen_to_a_file_and_its_errors_like_jax(capsys, tmp_path):
    out = str(tmp_path / "clos.yaml")
    files = []
    for mod in (jcli, tcli):
        r = run(capsys, mod, ["gen", "clos", "-p", "n_spine=2", "-p",
                              "n_leaf=2", "-o", out])
        with open(out) as f:
            files.append(f.read())
        files.append(r)
    assert files[2:] == files[:2]
    for argv in (["gen", "nope"], ["gen", "ring", "-p", "m=3"]):
        j, t = pair(capsys, argv)
        assert t == j and j[0] == 1


def test_crd_prints_what_jax_prints(capsys):
    from kubedtn_tpu.api.crd import render_crd as jrender
    from kubedtn_tpu_torch.api.crd import render_crd

    j, t = pair(capsys, ["crd"])
    assert t == j and j[0] == 0
    assert render_crd() == jrender()
    assert t[1] == yaml.safe_dump(render_crd(), sort_keys=False) + "\n"


@pytest.mark.parametrize("argv", [
    ["ping", "sat-a", "sat-b"], ["ping", "sat-b", "relay-c"],
    ["ping", "sat-a", "sat-b", "--uid", "11"],
    ["ping", "sat-a", "relay-c"],            # no direct link: rc 1
    ["trace", "sat-a", "relay-c"], ["trace", "sat-b", "gw-d"],
    ["trace", "sat-a", "nope"],              # unknown pod: rc 1
], ids=lambda a: "-".join(a))
def test_ping_and_trace_print_what_jax_prints(capsys, argv):
    j, t = pair(capsys, [*argv, "--file", RING4], CPU)
    assert t == j


def test_trace_without_a_mode_like_jax(capsys):
    j, t = pair(capsys, ["trace", "sat-a"], CPU)
    assert t == j and j[0] == 1


def _frames() -> list:
    """A few Ethernet frames of different protocols."""
    mac = bytes(range(6)) + bytes(range(6, 12))

    def ipv4(proto, n=40):
        return (mac + b"\x08\x00" + bytes([0x45, 0, 0, 20 + n, 0, 0, 0, 0,
                                           64, proto, 0, 0, 10, 0, 0, 1,
                                           10, 0, 0, 2]) + bytes(n))
    return [ipv4(6), ipv4(17), ipv4(1), mac + b"\x08\x06" + bytes(28),
            mac + b"\x86\xdd" + bytes(60), b"\x01\x02\x03"] * 3


@pytest.mark.parametrize("quiet", [False, True])
def test_pcap_of_a_port_capture_prints_what_jax_prints(capsys, tmp_path,
                                                       quiet):
    from _torch_native_guard import ensure_jax_native

    from kubedtn_tpu_torch.utils.pcap import CaptureManager

    ensure_jax_native()
    path = str(tmp_path / "cap.pcap")
    cap = CaptureManager()
    cap.open(path)
    for i, f in enumerate(_frames()):
        cap.record("default/a", 1, f, "in" if i % 2 else "out")
    cap.close_all()
    argv = ["pcap", path] + (["-q"] if quiet else [])
    j, t = pair(capsys, argv)
    assert t == j and j[0] == 0
    assert t[1].splitlines()[-1].startswith(f"{path}: {len(_frames())} "
                                            f"frames")


WHATIF_TOPO = """
apiVersion: y-young.github.io/v1
kind: Topology
metadata: {name: a}
spec:
  links:
  - {uid: 1, local_intf: e1, peer_intf: e1, peer_pod: b,
     properties: {latency: 2ms, rate: 2Mbit}}
  - {uid: 2, local_intf: e2, peer_intf: e1, peer_pod: c,
     properties: {latency: 5ms}}
---
apiVersion: y-young.github.io/v1
kind: Topology
metadata: {name: b}
spec:
  links:
  - {uid: 1, local_intf: e1, peer_intf: e1, peer_pod: a,
     properties: {latency: 2ms, rate: 2Mbit}}
---
apiVersion: y-young.github.io/v1
kind: Topology
metadata: {name: c}
spec:
  links:
  - {uid: 2, local_intf: e1, peer_intf: e2, peer_pod: a,
     properties: {latency: 5ms}}
"""

WHATIF_SPEC = [
    {"name": "slow", "perturbations": [
        {"kind": "degrade", "uid": 2, "properties": {"latency": "20ms"}}]},
    {"name": "cut", "perturbations": [{"kind": "fail", "uid": 1}]},
    {"name": "busy", "perturbations": [{"kind": "scale", "factor": 1.5}]},
    {"name": "dark-b", "perturbations": [{"kind": "blackhole",
                                          "node": "b"}]},
]

# wall-clock readings of the sweep itself, per call
WHATIF_WALL = ("compile_s", "run_s", "replicas_steps_per_s")


def _close(a, b, path="") -> None:
    """Equal structures; floats within the results tolerance."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, (int, float)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-2,
                                   err_msg=path)
    else:
        assert a == b, path


def test_whatif_file_ranks_like_jax(capsys, tmp_path):
    topo = tmp_path / "topo.yaml"
    topo.write_text(WHATIF_TOPO)
    spec = tmp_path / "spec.yaml"
    spec.write_text(yaml.safe_dump(WHATIF_SPEC))
    argv = ["whatif", "--file", str(topo), "--spec", str(spec),
            "--ticks", "50", "--json"]
    j, t = pair(capsys, argv, CPU)
    assert t[0] == j[0] == 0, t[2]
    oj, ot = json.loads(j[1]), json.loads(t[1])
    for k in WHATIF_WALL:
        oj.pop(k), ot.pop(k)
    assert [(r["rank"], r["name"]) for r in ot["ranked"]] == \
        [(r["rank"], r["name"]) for r in oj["ranked"]]
    _close(ot, oj)
    # and the table: the same rows (its header carries the wall times)
    j, t = pair(capsys, argv[:-1], CPU)
    assert t[1].splitlines()[1:] == j[1].splitlines()[1:]


def test_whatif_spec_errors_like_jax(capsys, tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("name: not-a-list\n")
    for argv in (["whatif", "--spec", str(bad), "--file", RING4],
                 ["whatif"]):
        j, t = pair(capsys, argv, CPU)
        assert t == j and j[0] == 1


# -- the client verbs against a port daemon ------------------------------------

DET_PROPS = {
    "t0": dict(latency="10ms"),
    "t1": dict(rate="1Mbit"),
    "t2": dict(latency="5ms", latency_corr="30"),
}
NAMES = sorted(DET_PROPS)
TICK_S = 0.01
WINDOW_S = 0.05


def _feed(wires, k: int) -> None:
    for ns in NAMES:
        for i, w in enumerate(wires[ns][0]):
            w.ingress.extend(bytes([i, k % 256]) + b"\x5a" * (60 + 40 * i)
                             for _ in range(4))


def _drive(plane, wires, ticks) -> None:
    for k in ticks:
        if k < 60:
            _feed(wires, k)
        plane.tick(now_s=100.0 + (k + 1) * TICK_S)


def _tenant_daemon(pkg: str):
    """One package's three-tenant plane on an explicit clock with
    telemetry (every 4th frame sampled), fed 60 ticks and drained 30."""
    plane, reg, wires = tenant_plane(mods(pkg), NAMES, DET_PROPS,
                                     telemetry=False)
    plane.enable_telemetry(window_s=WINDOW_S, sample_period=4)
    _drive(plane, wires, range(90))
    return plane, reg, wires


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port daemon of the client verbs: the tenant plane with the
    SLO evaluator (evaluated, not started), a disabled autopilot (not
    started), a federation controller and a fleet supervisor (swept
    once, not started), behind a gRPC server. GC is off while the
    module runs: a collection between two calls would add a `gc` pause
    to one CLI's view."""
    from kubedtn_tpu_torch.autopilot import Autopilot
    from kubedtn_tpu_torch.federation import (FederationController,
                                              FleetSupervisor, PlaneHandle)
    from kubedtn_tpu_torch.scenarios import serve_on
    from kubedtn_tpu_torch.slo import SloEvaluator

    gc.collect()
    gc.disable()
    tmp = tmp_path_factory.mktemp("cli-served")
    plane, reg, wires = _tenant_daemon("torch")
    daemon = plane.daemon
    ev = SloEvaluator(reg, plane).attach(daemon)
    ev.maybe_evaluate()
    Autopilot(reg, plane, ev).attach(daemon)
    fed = FederationController(str(tmp / "journal"))
    fed.register(PlaneHandle("A", daemon, plane, reg))
    sup = FleetSupervisor(fed, str(tmp / "ledger")).attach()
    sup.sweep()
    server, port = serve_on(daemon)
    yield {"addr": f"127.0.0.1:{port}", "plane": plane}
    server.stop(0)
    gc.enable()


def _json_without(text: str, drop: dict) -> object:
    """The last JSON line of `text` with the keys in `drop` removed:
    {path: keys}, path "" the top level, "causes" / "events" / "planes"
    the dicts of those lists ("planes.health" their health)."""
    doc = json.loads(text.splitlines()[-1])
    for path, keys in drop.items():
        objs = [doc]
        for part in path.split(".") if path else []:
            nxt = []
            for o in objs:
                v = o.get(part) if isinstance(o, dict) else None
                nxt.extend(v if isinstance(v, list)
                           else [v] if isinstance(v, dict) else [])
            objs = nxt
        for o in objs:
            for k in keys:
                o.pop(k, None)
    return doc


FLOAT = re.compile(r"\s*-?\d+\.\d+(?:ms|s|%)?")

# verb -> (argv, how stdout is compared, the reason for any mask)
CLIENT_VERBS = {
    "top": (["top"], "text", ""),
    "top-json": (["top", "--json", "-n", "4"], "text", ""),
    "slo": (["slo"], "text", ""),
    "slo-json": (["slo", "--json"], "text", ""),
    "slo-tenant": (["slo", "--tenant", "t1", "--json"], "text", ""),
    "slo-fleet-server-side": (["slo", "--fleet"], "text", ""),
    "autopilot-status": (["autopilot", "status"], "text", ""),
    "autopilot-json": (["autopilot", "status", "--json"], "text", ""),
    "autopilot-history": (["autopilot", "history"], "text", ""),
    "tenant-list": (["tenant", "list"], "text", ""),
    "tenant-stats": (["tenant", "stats", "t1"], "text", ""),
    "tenant-stats-unnamed": (["tenant", "stats"], "text", ""),
    "migrate-status": (["migrate", "--status"], "text", ""),
    "trace-latest": (["trace", "latest"], "text", ""),
    "trace-latest-json": (["trace", "latest", "--json"], "text", ""),
    "trace-bad-id": (["trace", "zz", "--json"], "text", ""),
    # uptime and every pause duration are wall-clock readings the ledger
    # takes per barrier and per call
    "pauses-json": (["pauses", "--json", "--events", "8"], {
        "": ["uptime_s", "total_pause_s"],
        "causes": ["seconds", "max_s", "last_s", "last_t_s",
                   "tick_buckets", "tick_sum_s"],
        "events": ["dur_s", "t_s"]}, "wall-clock pause durations"),
    "pauses": (["pauses", "--events", "8"], "floats",
               "wall-clock pause durations"),
    # the plane's heartbeat age is read at the call
    "fleet-status": (["fleet", "status"], {
        "planes.health": ["heartbeat_age_s"]}, "heartbeat age"),
    # each call runs its own sweep: compile and run seconds are its wall
    # time (the results themselves are the seed's, equal)
    "whatif-json": (["whatif", "--json", "--ticks", "20"], {
        "": list(WHATIF_WALL)}, "sweep wall time"),
    "whatif": (["whatif", "--ticks", "20"], "header",
               "sweep wall time in the header line"),
}


@pytest.mark.parametrize("verb", sorted(CLIENT_VERBS))
def test_client_verb_prints_what_jax_prints(capsys, served, verb):
    argv, how, _reason = CLIENT_VERBS[verb]
    j, t = pair(capsys, [*argv, "--daemon", served["addr"]])
    assert t[0] == j[0], (t, j)
    assert t[2] == j[2]
    if how == "text":
        assert t[1] == j[1]
    elif how == "floats":
        assert FLOAT.sub(" X", t[1]) == FLOAT.sub(" X", j[1])
    elif how == "header":
        assert t[1].splitlines()[1:] == j[1].splitlines()[1:]
    else:
        assert _json_without(t[1], how) == _json_without(j[1], how)
    assert t[1] or t[2]


def test_client_verbs_see_the_served_state(capsys, served):
    """The views are not empty: the fed tenants, their SLO rows, a
    sampled trace, the attached and disabled autopilot, one plane."""
    addr = ["--daemon", served["addr"]]
    top = json.loads(run(capsys, tcli, ["top", "--json", *addr])[1])
    assert top["links"] and top["windows_closed"] > 0
    slo = json.loads(run(capsys, tcli, ["slo", "--json", *addr])[1])
    assert [r["tenant"] for r in slo["tenants"]] == NAMES
    tr = json.loads(run(capsys, tcli, ["trace", "latest", "--json",
                                       *addr])[1])
    assert tr["events"]
    ap = json.loads(run(capsys, tcli, ["autopilot", "status", "--json",
                                       *addr])[1])
    assert not ap["enabled"] and not ap["running"]
    fl = json.loads(run(capsys, tcli, ["fleet", "status", *addr])[1])
    assert [p["name"] for p in fl["planes"]] == ["A"]


def test_client_verbs_report_an_unreachable_daemon_like_jax(capsys):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    for argv in (["top"], ["pauses"], ["tenant", "list"],
                 ["fleet", "status"], ["migrate", "--status"],
                 ["autopilot", "status"], ["slo", "--timeout", "2"]):
        j, t = pair(capsys, [*argv, "--daemon", dead])
        assert t == j and j[0] == 1, argv


@pytest.fixture(scope="module")
def migrated():
    """Two federated port planes in lockstep with one tenant (mig) moved
    A -> B (the federation harness), both behind gRPC servers."""
    from _torch_federation_harness import fmods, run_migrated

    from kubedtn_tpu_torch.scenarios import serve_on

    gc.collect()
    gc.disable()
    rec, h, _acc, _stats, fed = run_migrated(fmods("torch"),
                                             telemetry=True)
    assert rec["state"] == "done"
    servers = [serve_on(fed.handle(n).daemon) for n in ("A", "B")]
    yield [f"127.0.0.1:{p}" for _s, p in servers]
    for s, _p in servers:
        s.stop(0)
    gc.enable()


@pytest.mark.parametrize("argv", [
    ["migrate", "--status"], ["migrate", "--status", "--id", "nope"],
    ["migrate"], ["migrate", "--resume"],
], ids=lambda a: "-".join(a))
def test_migrate_prints_what_jax_prints(capsys, migrated, argv):
    j, t = pair(capsys, [*argv, "--daemon", migrated[0]])
    assert t == j
    if argv == ["migrate", "--status"]:
        assert json.loads(t[1])["migrations"][0]["state"] == "done"


@pytest.mark.parametrize("argv", [
    ["slo", "--fleet"], ["slo", "--fleet", "--json"],
    ["slo", "--fleet", "--tenant", "mig", "--json"], ["slo"]],
    ids=lambda a: "-".join(a))
def test_slo_fleet_client_merge_prints_what_jax_prints(capsys, migrated,
                                                        argv):
    """Two daemons: --fleet merges client-side (mig's frozen slice on A
    stitched with its live rows on B); without --fleet both refuse."""
    d = [x for a in migrated for x in ("--daemon", a)]
    j, t = pair(capsys, [*argv, *d])
    assert t == j
    if "--json" in argv:
        rows = json.loads(t[1])["tenants"]
        assert "mig" in [r["tenant"] for r in rows]


def _ring4_daemon():
    """A port daemon of ring4.yaml with a stopped plane (planned updates
    then apply directly), behind a gRPC server."""
    from kubedtn_tpu_torch import entry
    from kubedtn_tpu_torch.api.types import load_yaml
    from kubedtn_tpu_torch.scenarios import serve_on
    from kubedtn_tpu_torch.topology import (Reconciler, SimEngine,
                                            TopologyStore)
    from kubedtn_tpu_torch.wire.server import Daemon

    store = TopologyStore()
    engine = SimEngine(store, device="cpu")
    for t in load_yaml(RING4):
        store.create(t)
        engine.setup_pod(t.name, t.namespace)
    Reconciler(store, engine).drain()
    daemon = Daemon(engine)
    entry.build_plane(daemon)
    server, port = serve_on(daemon)
    return server, f"127.0.0.1:{port}"


def _plan_yaml(tmp_path) -> str:
    from kubedtn_tpu_torch.api.types import LinkProperties, load_yaml

    sat_a = next(t for t in load_yaml(RING4) if t.name == "sat-a")
    sat_a.spec.links[0] = sat_a.spec.links[0].with_properties(
        LinkProperties(latency="45ms", rate="1Gbit"))
    path = tmp_path / "plan.yaml"
    path.write_text(yaml.safe_dump(sat_a.to_manifest(), sort_keys=False))
    return str(path)


def test_plan_apply_and_physical_join_print_what_jax_prints(capsys,
                                                            tmp_path):
    """One port daemon per CLI (each verb changes it): the same plan
    (its gate seconds masked: wall time), the same apply (its stage
    seconds masked), the same physical join."""
    plan = _plan_yaml(tmp_path)
    servers = [_ring4_daemon(), _ring4_daemon()]
    try:
        outs = []
        for mod, (_s, addr) in zip((jcli, tcli), servers):
            d = ["--daemon", addr]
            text = run(capsys, mod, ["plan", plan, *d])
            pj = run(capsys, mod, ["plan", plan, "--json", *d])
            plan_id = json.loads(pj[1])["plans"][0]["plan_id"]
            ap = run(capsys, mod, ["apply", "--plan", str(plan_id), *d])
            again = run(capsys, mod, ["apply", "--plan", str(plan_id), *d])
            join = run(capsys, mod, ["physical-join",
                                     os.path.join(SAMPLES,
                                                  "physical-host.yaml"),
                                     *d])
            outs.append((text, pj, ap, again, join))
        (jt, jp, ja, jg, jj), (tt, tp, ta, tg, tj) = outs
        # masked: the gate's wall seconds, the plan id (a process-wide
        # counter: the two daemons share this process) and each
        # daemon's own address in the "apply with" hint
        masks = [(re.compile(r"gate=\d+\.\d+s"), "gate=X"),
                 (re.compile(r"plan(_id=| | id )\d+"), r"plan\1X"),
                 (re.compile(r"--daemon \S+"), "--daemon X")]

        def mask(text):
            for rx, to in masks:
                text = rx.sub(to, text)
            return text

        assert tt[0] == jt[0] == 0
        assert mask(tt[1]) == mask(jt[1])
        assert _json_without(tp[1], {"plans": ["gate_s", "plan_id"]}) == \
            _json_without(jp[1], {"plans": ["gate_s", "plan_id"]})
        assert json.loads(tp[1])["plans"][0]["verified"]
        assert ta[0] == ja[0] == 0
        assert _json_without(ta[1], {"": ["stage_s"]}) == \
            _json_without(ja[1], {"": ["stage_s"]})
        assert tg[0] == jg[0] == 1
        assert _json_without(mask(tg[1]), {"": ["stage_s"]}) == \
            _json_without(mask(jg[1]), {"": ["stage_s"]})
        assert tj == jj and tj[0] == 0
    finally:
        for s, _a in servers:
            s.stop(0)


def test_top_and_tenant_stats_equal_a_jax_daemon(capsys):
    """End to end: the port CLI on a port daemon == the JAX CLI on a JAX
    daemon built and fed the same way."""
    from kubedtn_tpu.wire.server import make_server as jmake
    from kubedtn_tpu_torch.scenarios import serve_on as tserve

    def jserve(daemon):
        server, port = jmake(daemon, port=0, host="127.0.0.1",
                             log_rpcs=False)
        server.start()
        return server, port

    outs = {}
    for pkg, mod, serve in (("jax", jcli, jserve), ("torch", tcli, tserve)):
        plane, _reg, _w = _tenant_daemon(pkg)
        server, port = serve(plane.daemon)
        d = ["--daemon", f"127.0.0.1:{port}"]
        try:
            # the table's title names the daemon's own address
            outs[pkg] = [tuple(x.replace(d[1], "ADDR")
                               if isinstance(x, str) else x
                               for x in run(capsys, mod, argv + d))
                         for argv in (
                ["top", "--json"], ["top"], ["tenant", "stats", "t0"],
                ["tenant", "stats", "t1"], ["tenant", "stats", "t2"],
                ["tenant", "list"])]
        finally:
            server.stop(0)
            plane.stop()
    assert outs["torch"] == outs["jax"]
    assert json.loads(outs["torch"][0][1])["links"]


# -- scenario -------------------------------------------------------------------


@pytest.mark.parametrize("params", [
    [], ["pairs=3"], ["loss_pct=12.5", "seed=4"], ["steps=20", "width=1"],
    ["device=cpu"]])
def test_coerce_params_equal_jax(params):
    """The same -p strings coerce alike for each ported scenario (the
    names its JAX twin takes; `device` only the port's) and each gen
    family."""
    import inspect

    from kubedtn_tpu import scenarios as jsc
    from kubedtn_tpu.models import topologies as jt
    from kubedtn_tpu_torch import scenarios as tsc
    from kubedtn_tpu_torch.models import topologies as tt

    for name in tsc.LADDER:
        fj, ft = jsc.LADDER[name], tsc.LADDER[name]
        known = inspect.signature(fj).parameters
        ok = [p for p in params if p.partition("=")[0] in known]
        assert tcli._coerce_params(ft, ok) == jcli._coerce_params(fj, ok)
    for fam, ps in GEN.items():
        assert tcli._coerce_params(tt.FAMILIES[fam], ps) == \
            jcli._coerce_params(jt.FAMILIES[fam], ps)


def test_coerce_params_refuses_unknown_names_like_jax():
    from kubedtn_tpu import scenarios as jsc
    from kubedtn_tpu_torch import scenarios as tsc

    errs = []
    for cli, sc in ((jcli, jsc), (tcli, tsc)):
        with pytest.raises(ValueError) as e:
            cli._coerce_params(sc.burn_recovery, ["nope=1"])
        errs.append(str(e.value))
    assert errs[0].split(";")[0] == errs[1].split(";")[0]


def test_ladder_is_jax_order_restricted_to_the_ported():
    from kubedtn_tpu import scenarios as jsc
    from kubedtn_tpu_torch import scenarios as tsc

    assert list(tsc.LADDER) == [k for k in jsc.LADDER if k in tsc.LADDER]
    assert list(tsc.LADDER) == ["3node", "fat_tree_64", "churn_1k",
                                "routes_10k", "clos_100k", "reconcile_100k",
                                "scale_1m", "chaos_flaps", "reconverge_10k",
                                "burn_recovery", "migration_under_flap",
                                "plane_failover", "fleet_rolling_upgrade"]
    assert sorted([*tsc.LADDER, *tsc.NOT_PORTED]) == sorted(jsc.LADDER)
    assert list(tsc.NOT_PORTED) == [k for k in jsc.LADDER
                                    if k not in tsc.LADDER]


@pytest.mark.parametrize("name", ["live_plane", "noisy_neighbor",
                                  "chaos_soak"])
def test_scenario_not_ported_yet_is_refused(capsys, name):
    rc, out, err = run(capsys, tcli, ["scenario", name, *CPU])
    assert rc == 1 and out == ""
    assert err.strip() == f"scenario {name} is not ported yet"


def test_unknown_scenario_and_bad_params_are_refused(capsys):
    rc, _out, err = run(capsys, tcli, ["scenario", "nope", *CPU])
    assert rc == 1 and err.startswith("unknown scenario nope; choices: "
                                      "3node, fat_tree_64, churn_1k")
    rc, _out, err = run(capsys, tcli, ["scenario", "plane_failover", "-p",
                                       "bogus=1", *CPU])
    assert rc == 1 and "no parameter 'bogus'" in err
    rc, _out, err = run(capsys, tcli, ["scenario", "all", "-p", "a=1",
                                       *CPU])
    assert rc == 1 and "not supported with 'all'" in err


def test_scenario_runs_a_ported_scenario_on_the_cpu(capsys):
    rc, out, err = run(capsys, tcli, ["scenario", "plane_failover", *CPU])
    assert rc == 0, err
    doc = json.loads(out)
    assert doc["scenario"] == "plane_failover"


# -- no fallback ------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_daemon_without_a_card_exits_2_and_binds_nothing(capsys):
    import torch

    assert not torch.cuda.is_available()
    gport, mport = _free_port(), _free_port()
    rc, out, err = run(capsys, tcli, ["daemon", "--port", str(gport),
                                      "--metrics-port", str(mport)])
    assert rc == 2 and out == ""
    assert "no CUDA device" in err and "--device cpu" in err
    for p in (gport, mport):
        with socket.socket() as s:
            s.bind(("127.0.0.1", p))   # still free


@pytest.mark.parametrize("argv", [
    ["apply", RING4], ["ping", "sat-a", "sat-b", "--file", RING4],
    ["trace", "sat-a", "relay-c", "--file", RING4],
    ["whatif", "--file", RING4], ["scenario", "plane_failover"],
    ["scenario", "all"]], ids=lambda a: a[0] + "-" + a[-1][-9:])
def test_engine_verbs_without_a_card_exit_2(capsys, argv):
    rc, out, err = run(capsys, tcli, argv)
    assert rc == 2 and out == ""
    assert err.startswith(f"{argv[0]}: no CUDA device is available")
