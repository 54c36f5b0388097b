"""`python -m kubedtn_tpu_torch.cli daemon --device cpu` as a subprocess,
booted from a small checkpoint the port wrote, driven only through what
an operator has: its ready line, gRPC, /metrics and files.

- the first life: the ready line parses; the tenancy registry, the SLO
  evaluator and the attached, disabled autopilot answer; a shm producer
  process feeds two wires through the ring directory; SIGTERM exits 0;
- its checkpoint: loads in both packages' checkpoint.load with equal
  columns and registries; the trace file is a JSON array holding
  checkpoint-load, checkpoint-save and a pause: span;
- the second life from that checkpoint: the rows, wires and counters
  are restored (each fed link's tx continues), and SIGTERM exits 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READY = re.compile(r"^kubedtn-tpu daemon: gRPC on :(\d+), metrics on "
                   r":(\d+)/metrics$")
N_FRAMES = 300            # frames the producer pushes into each ring
BOOT_S = 60.0


class Child:
    """The daemon subprocess, its ready line and its stderr file."""

    def __init__(self, args, err_path):
        self.err_path = err_path
        self._err = open(err_path, "w")
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubedtn_tpu_torch.cli", "daemon",
             "--device", "cpu", *args], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
            stderr=self._err, text=True)
        self.ports = None
        self.lines = []
        ready = threading.Event()

        def read():
            for line in self.proc.stdout:
                self.lines.append(line)
                m = READY.match(line.strip())
                if m and self.ports is None:
                    self.ports = int(m.group(1)), int(m.group(2))
                    ready.set()
            ready.set()

        threading.Thread(target=read, daemon=True).start()
        ready.wait(BOOT_S)
        if self.ports is None:
            self.kill()
            pytest.fail(f"no ready line: {self.lines} {self.err()[-3000:]}")

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.ports[0]}"

    def err(self) -> str:
        with open(self.err_path) as f:
            return f.read()

    def scrape(self) -> dict:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{self.ports[1]}/metrics", timeout=30
        ).read().decode()
        out = {}
        for line in body.splitlines():
            if line and not line.startswith("#"):
                key, _, val = line.rpartition(" ")
                out[key] = float(val)
        return out

    def term(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(60)
        finally:
            self.kill()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._err.close()


def client(addr):
    from kubedtn_tpu_torch.wire.client import DaemonClient

    return DaemonClient(addr)


def wait_for(cond, what: str, timeout: float = 20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    pytest.fail(f"timed out waiting for {what}")


FED = (("leaf0", 1), ("leaf1", 3))    # (leaf, uid) of the fed links


def series(sc: dict, leaf: str, uid: int, name: str = "tx_packets"):
    return sc.get(f'interface_{name}{{interface="uid{uid}",'
                  f'namespace="default",pod="{leaf}"}}')


@pytest.fixture(scope="module")
def life(tmp_path_factory):
    """The first life: a 2 x 4 Clos checkpoint written by the port, the
    daemon booted from it, two links wired and fed by a shm producer,
    then SIGTERM. Returns what the tests read."""
    from kubedtn_tpu_torch import checkpoint, entry
    from kubedtn_tpu_torch.wire import proto as pb

    tmp = tmp_path_factory.mktemp("cli-daemon")
    d = {k: str(tmp / k) for k in ("ckpt", "shm")}
    d["trace"] = str(tmp / "trace.json")
    built = entry.build_daemon("cpu", n_spine=2, n_leaf=4,
                               capacity=1 << 6, tenancy=True)
    checkpoint.save(d["ckpt"], built["store"], built["engine"])
    args = ["--port", "0", "--metrics-port", "0", "--checkpoint-dir",
            d["ckpt"], "--shm-dir", d["shm"], "--trace-out", d["trace"],
            "--telemetry-window", "0.5"]
    child = Child(args, str(tmp / "first.err"))
    out = {"dirs": d, "args": args, "tmp": tmp, "built": built,
           "rows": built["engine"].num_active}
    try:
        c = client(child.addr)
        out["tenants"] = c.TenantList(pb.TenantQuery(), timeout=30)
        out["slo"] = c.ObserveSLO(pb.ObserveSLORequest(), timeout=30)
        out["autopilot"] = c.AutopilotStatus(pb.AutopilotStatusRequest(),
                                             timeout=30)
        out["health"] = c.Health(pb.HealthRequest(), timeout=30)
        spine = {l.uid: l.peer_pod for t in built["crs"]
                 for l in t.spec.links}
        for leaf, uid in FED:          # wire ids 1001, 1002
            c.AddGRPCWireLocal(pb.WireDef(local_pod_name=leaf,
                                          kube_ns="default", link_uid=uid,
                                          intf_name_in_pod="eth1"),
                               timeout=30)
        for leaf, uid in FED:
            c.AddGRPCWireLocal(pb.WireDef(local_pod_name=spine[uid],
                                          kube_ns="default", link_uid=uid,
                                          intf_name_in_pod="eth1"),
                               timeout=30)
        c.close()
        env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
        prods = [subprocess.run(
            [sys.executable, "-m", "kubedtn_tpu_torch.shm.producer",
             os.path.join(d["shm"], f"p{k}.ring"), str(1001 + k),
             str(N_FRAMES), "--frame-size", "96", "--namespace",
             "default"], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=60) for k in range(len(FED))]
        out["producers"] = prods
        out["sc1"] = wait_for(
            lambda: (lambda sc: sc if all(
                series(sc, leaf, uid) == N_FRAMES for leaf, uid in FED)
                else None)(child.scrape()), "the ring frames shaped")
        out["rc1"] = child.term()
        out["err1"] = child.err()
    finally:
        child.kill()
    return out


def test_the_daemon_boots_from_the_checkpoint_and_answers(life):
    assert [t.name for t in life["tenants"].tenants] == ["default"]
    assert life["tenants"].tenants[0].links == life["rows"]
    assert life["slo"].ok, life["slo"].error
    ap = life["autopilot"]
    assert ap.ok and ap.running and not ap.enabled and not ap.dry_run
    assert life["health"].ok and life["health"].serving
    assert "restored from checkpoint" in life["err1"]


def test_a_shm_producer_feeds_the_daemon(life):
    for p in life["producers"]:
        assert p.returncode == 0, p.stderr
        assert p.stdout.splitlines()[-1] == f"done pushed={N_FRAMES}"
    sc = life["sc1"]
    assert sc["kubedtn_shm_frames_total"] == len(FED) * N_FRAMES
    assert sc["kubedtn_node_tx_packets_total"] == len(FED) * N_FRAMES
    assert sc["kubedtn_node_rx_packets_total"] == len(FED) * N_FRAMES


def test_sigterm_exits_0_with_a_checkpoint(life):
    assert life["rc1"] == 0
    assert "checkpoint written" in life["err1"]
    assert re.search(r'msg="kernel launches shape_step_rows=0 ',
                     life["err1"])


def test_the_checkpoint_loads_in_both_packages_with_equal_columns(life):
    from kubedtn_tpu import checkpoint as jckpt
    from kubedtn_tpu_torch import checkpoint as tckpt
    from kubedtn_tpu_torch.ops import edge_state as es

    path = life["dirs"]["ckpt"]
    ts, te = tckpt.load(path, device="cpu")
    js, je = jckpt.load(path)
    assert te.num_active == je.num_active == life["rows"]
    assert te._rows == je._rows and te._pod_ids == je._pod_ids
    assert sorted(t.name for t in ts.list()) == \
        sorted(t.name for t in js.list())
    for f in dataclasses.fields(es.EdgeState):
        a = np.asarray(getattr(te.state, f.name).cpu())
        b = np.asarray(getattr(je.state, f.name))
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert len(tckpt.read_ingress_entries(path)) == 0
    # the wires and the counters went with it
    z = tckpt.load_plane_counters(path)
    for leaf, uid in FED:
        assert z["tx_packets"][te.row_of(f"default/{leaf}", uid)] == N_FRAMES


def test_the_trace_file_holds_the_daemon_spans(life):
    with open(life["dirs"]["trace"]) as f:
        text = f.read()
    assert text.startswith("[\n")
    spans = json.loads(text + "\n]")
    names = {s["name"] for s in spans}
    assert {"checkpoint-load", "checkpoint-save"} <= names
    assert any(n.startswith("pause:") for n in names)
    assert all(s["ph"] == "X" and "args" in s for s in spans)


def test_the_restart_restores_rows_wires_and_counters(life):
    tmp = life["tmp"]
    child = Child(life["args"], str(tmp / "second.err"))
    try:
        sc = child.scrape()
        assert sc["kubedtn_tenant_links{tenant=\"default\"}"] == life["rows"]
        for leaf, uid in FED:
            assert series(sc, leaf, uid) == N_FRAMES
        # the wires came back with their ids: a frame more on each
        from kubedtn_tpu_torch.wire import proto as pb

        c = client(child.addr)
        c.InjectBulk(iter([pb.PacketBatch(packets=[
            pb.Packet(remot_intf_id=1001 + k, frame=bytes(64))
            for k in range(len(FED))])]), timeout=30)
        c.close()
        wait_for(lambda: all(series(child.scrape(), leaf, uid)
                             == N_FRAMES + 1 for leaf, uid in FED),
                 "the restarted daemon to shape the new frames")
        assert child.term() == 0
        err = child.err()
        assert "plane counters restored" in err
        assert "checkpoint written" in err
    finally:
        child.kill()
