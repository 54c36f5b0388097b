"""Port parity: kubedtn_tpu_torch.cni against kubedtn_tpu.cni, on the CPU.

The JAX package's 8 CNI cases of tests/test_cni_tracing.py run against
the port's shim and a port daemon behind a real gRPC server on
127.0.0.1 (the JAX cases read the reference's 3node sample, which is not
in this repo; these read config/samples/ring4.yaml, four pods in a
ring). Then the packages against each other: the same CNI stdin and env
through each package's `cni.main` against each package's daemon give
the same exit code and the same stdout, byte for byte, and leave the
two daemons' engines with equal realized columns after every step (ADD
and DEL of every pod, unknown pods, malformed requests)."""

import json
from pathlib import Path

import numpy as np
import pytest

from kubedtn_tpu_torch import cni
from kubedtn_tpu_torch.api.types import load_yaml
from kubedtn_tpu_torch.topology import SimEngine, TopologyStore
from kubedtn_tpu_torch.wire.server import Daemon, make_server

RING4 = str(Path(__file__).resolve().parent.parent / "config" / "samples"
            / "ring4.yaml")
PODS = ("sat-a", "sat-b", "relay-c", "gw-d")


@pytest.fixture(autouse=True)
def cni_log(tmp_path, monkeypatch):
    """Each shim logs into the test's own directory."""
    import kubedtn_tpu.cni as jcni

    monkeypatch.setattr(cni, "LOG_PATH", str(tmp_path / "cni.log"))
    monkeypatch.setattr(jcni, "LOG_PATH", str(tmp_path / "jax-cni.log"))


def serve(pkg: str):
    """A daemon of `pkg` over ring4's CRs behind a gRPC server on
    127.0.0.1: (server, port, engine)."""
    import importlib

    root = {"jax": "kubedtn_tpu", "torch": "kubedtn_tpu_torch"}[pkg]
    types_ = importlib.import_module(f"{root}.api.types")
    topo = importlib.import_module(f"{root}.topology")
    srv_mod = importlib.import_module(f"{root}.wire.server")
    store = topo.TopologyStore()
    kw = {"device": "cpu"} if pkg == "torch" else {}
    engine = topo.SimEngine(store, capacity=64, **kw)
    for t in types_.load_yaml(RING4):
        store.create(t)
    server, port = srv_mod.make_server(srv_mod.Daemon(engine), port=0,
                                       host="127.0.0.1")
    server.start()
    return server, port, engine


@pytest.fixture()
def daemon_port():
    store = TopologyStore()
    engine = SimEngine(store, capacity=64, device="cpu")
    for t in load_yaml(RING4):
        store.create(t)
    daemon = Daemon(engine)
    server, port = make_server(daemon, port=0, host="127.0.0.1")
    server.start()
    yield port, engine
    server.stop(0)


def conf(port: int, prev=None) -> str:
    d = {"cniVersion": "1.0.0", "name": "k8s-pod-network",
         "type": "kubedtn", "daemonPort": port}
    if prev is not None:
        d["prevResult"] = prev
    return json.dumps(d)


def env_for(cmd: str, pod: str, ns: str = "default") -> dict:
    return {
        "CNI_COMMAND": cmd,
        "CNI_ARGS": f"IgnoreUnknown=1;K8S_POD_NAMESPACE={ns};"
                    f"K8S_POD_NAME={pod}",
        "CNI_NETNS": f"/var/run/netns/{pod}",
        "CNI_CONTAINERID": "abc123",
    }


# -- tests/test_cni_tracing.py's CNI cases, on the port --------------------

def test_cmd_add_realizes_pod(daemon_port, capsys):
    port, engine = daemon_port
    prev = {"cniVersion": "1.0.0", "ips": [{"address": "10.244.0.7/24"}]}
    rc = cni.main(stdin_text=conf(port, prev), env=env_for("ADD", "sat-a"))
    assert rc == 0
    # chained prevResult is passed through on stdout
    out = json.loads(capsys.readouterr().out)
    assert out == prev
    assert engine.is_alive("default/sat-a")


def test_add_then_peer_plumbs_links(daemon_port, capsys):
    port, engine = daemon_port
    cni.main(stdin_text=conf(port), env=env_for("ADD", "sat-a"))
    cni.main(stdin_text=conf(port), env=env_for("ADD", "sat-b"))
    capsys.readouterr()
    # sat-a<->sat-b realized by whichever pod came up last
    assert engine.num_active >= 2


def test_non_topology_pod_errors_but_del_is_silent(daemon_port, capsys):
    port, engine = daemon_port
    # SetupPod returns True for unknown pods (delegate), so ADD succeeds
    rc = cni.main(stdin_text=conf(port), env=env_for("ADD", "not-a-twin"))
    assert rc == 0
    capsys.readouterr()
    # DEL of an unknown pod must never fail pod teardown
    rc = cni.main(stdin_text=conf(port), env=env_for("DEL", "not-a-twin"))
    assert rc == 0


def test_cmd_del(daemon_port, capsys):
    port, engine = daemon_port
    cni.main(stdin_text=conf(port), env=env_for("ADD", "sat-a"))
    cni.main(stdin_text=conf(port), env=env_for("ADD", "sat-b"))
    rc = cni.main(stdin_text=conf(port), env=env_for("DEL", "sat-a"))
    capsys.readouterr()
    assert rc == 0
    assert not engine.is_alive("default/sat-a")


def test_version(capsys):
    rc = cni.main(stdin_text="", env={"CNI_COMMAND": "VERSION"})
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert "1.0.0" in out["supportedVersions"]


def test_check_noop(daemon_port):
    port, _ = daemon_port
    assert cni.main(stdin_text=conf(port), env=env_for("CHECK", "sat-a")) \
        == 0


def test_conflist_install_merge_and_remove(tmp_path):
    primary = {"cniVersion": "0.3.1", "name": "cbr0",
               "plugins": [{"type": "flannel"}]}
    (tmp_path / "10-flannel.conflist").write_text(json.dumps(primary))

    out = cni.install_conflist(str(tmp_path), inter_node_link_type="GRPC",
                               daemon_port=5151)
    merged = json.loads(open(out).read())
    types = [p["type"] for p in merged["plugins"]]
    assert types == ["flannel", "kubedtn"]   # chained after the primary
    assert merged["plugins"][1]["daemonPort"] == 5151
    assert cni.inter_node_link_type(str(tmp_path)) == "GRPC"

    # idempotent: re-install doesn't duplicate the plugin
    cni.install_conflist(str(tmp_path))
    merged = json.loads(open(out).read())
    assert [p["type"] for p in merged["plugins"]].count("kubedtn") == 1

    cni.remove_conflist(str(tmp_path))
    assert not (tmp_path / cni.CONFLIST_NAME).exists()
    assert cni.inter_node_link_type(str(tmp_path)) == "VXLAN"  # default


def test_wrap_bare_conf(tmp_path):
    (tmp_path / "05-bridge.conf").write_text(json.dumps(
        {"cniVersion": "0.4.0", "name": "bridge", "type": "bridge"}))
    out = cni.install_conflist(str(tmp_path))
    merged = json.loads(open(out).read())
    assert [p["type"] for p in merged["plugins"]] == ["bridge", "kubedtn"]


# -- the packages against each other ----------------------------------------

PREV = {"cniVersion": "0.4.0", "ips": [{"address": "10.244.0.9/24"}]}


def steps(port: int) -> list:
    """(stdin, env) of one CNI history against the daemon on `port`."""
    out = [(conf(port, PREV), env_for("ADD", "sat-a")),
           (json.dumps({"cniVersion": "0.4.0", "daemonPort": port}),
            env_for("ADD", "sat-b")),
           (conf(port), env_for("ADD", "not-a-twin")),
           (conf(port), env_for("CHECK", "sat-a")),
           (conf(port), {"CNI_COMMAND": "ADD", "CNI_ARGS": "IgnoreUnknown=1"}),
           (conf(port), env_for("FROB", "sat-a")),
           ("{not json", env_for("ADD", "sat-a")),
           ("", {"CNI_COMMAND": "VERSION"}),
           (conf(port), env_for("ADD", "relay-c")),
           (conf(port), env_for("ADD", "gw-d")),
           (conf(port), env_for("DEL", "sat-b")),
           (conf(port), env_for("DEL", "not-a-twin")),
           (conf(port), env_for("ADD", "sat-b")),
           (conf(port), env_for("DEL", "gw-d", ns="elsewhere"))]
    return out + [(conf(port), env_for("DEL", p)) for p in PODS]


def test_cni_main_same_output_jax_vs_port(capsys):
    """Each package's shim against each package's daemon: the same rc
    and stdout at every step, and after it the JAX daemon's engine and
    the port daemon's hold equal realized columns, row for row (the
    history ends with every pod deleted: no active row)."""
    import kubedtn_tpu.cni as jcni

    from test_torch_manager import assert_same_realized

    shims = {"jax": jcni, "torch": cni}
    daemons = {(s, d): serve(d) for s in shims for d in ("jax", "torch")}
    try:
        histories = {k: steps(v[1]) for k, v in daemons.items()}
        n = len(next(iter(histories.values())))
        for i in range(n):
            seen = {}
            for (s, d), hist in histories.items():
                stdin, env = hist[i]
                rc = shims[s].main(stdin_text=stdin, env=env)
                seen[(s, d)] = (rc, capsys.readouterr().out)
            assert len(set(seen.values())) == 1, (i, seen)
            for s in shims:
                assert_same_realized(daemons[(s, "jax")][2],
                                     daemons[(s, "torch")][2],
                                     exact_rows=True)
        first = seen[("torch", "torch")]
        assert first[0] == 0
        engine = daemons[("torch", "torch")][2]
        assert engine.num_active == 0
        assert not any(engine.is_alive(f"default/{p}") for p in PODS)
    finally:
        for server, _port, _engine in daemons.values():
            server.stop(0)


def test_cni_outputs_and_rows_along_the_history():
    """The port's shim against a port daemon step by step: the chained
    prevResult echoed, a minimal result without one, delegation of an
    unknown pod, the CNI error result for a missing pod name, an unknown
    command and malformed stdin, VERSION's versions, and the rows each
    ADD and DEL leaves (ring4: 4 links, 8 rows when every pod is up)."""
    server, port, engine = serve("torch")
    outs, active = [], []
    try:
        import contextlib
        import io

        for stdin, env in steps(port):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cni.main(stdin_text=stdin, env=env)
            outs.append((rc, buf.getvalue().strip()))
            active.append(engine.num_active)
    finally:
        server.stop(0)
    assert json.loads(outs[0][1]) == PREV
    assert json.loads(outs[1][1]) == {"cniVersion": "0.4.0"}
    assert outs[2] == (0, json.dumps({"cniVersion": "1.0.0"}))
    assert outs[3] == (0, "")
    assert outs[4] == (1, json.dumps(
        {"code": 999, "msg": "CNI_ARGS missing K8S_POD_NAME"}))
    assert outs[5] == (1, json.dumps(
        {"code": 999, "msg": "unknown CNI_COMMAND 'FROB'"}))
    assert outs[6][0] == 1 and json.loads(outs[6][1])["code"] == 999
    assert json.loads(outs[7][1])["supportedVersions"] == \
        cni.SUPPORTED_VERSIONS
    # sat-a, sat-b up: uid 11; + relay-c: 12; + gw-d: 13, 14; sat-b down:
    # 11, 12 gone; back: all 4; a DEL in another namespace: nothing
    assert active[:10] == [0, 2, 2, 2, 2, 2, 2, 2, 4, 8]
    assert active[10:14] == [4, 4, 8, 8]
    assert active[-1] == 0
    assert np.all(np.diff(active[-4:]) <= 0)
