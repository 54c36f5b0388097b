"""CNI shim — the kubelet-facing plugin binary, as a Python entry point.

Plays the role of the reference's chained CNI plugin
(reference plugin/kube_dtn.go:25-185): invoked per pod sandbox with the CNI
env/stdin protocol, it forwards pod lifecycle to the local daemon over gRPC
and otherwise stays out of the way (a pod that is not in any Topology is
delegated untouched). Also carries the daemon-side conf installer
(reference daemon/cni/cni.go:27-145): merge our plugin into the node's
existing conflist on startup, remove it on exit, and propagate the
inter-node link type through a drop file.

Protocol parity notes:
- cmdAdd: pod name/ns parsed from CNI_ARGS (K8S_POD_NAME/K8S_POD_NAMESPACE),
  netns from CNI_NETNS; daemon SetupPod; the chained prevResult is echoed on
  stdout so the next plugin sees it (kube_dtn.go:62-100).
- cmdDel: daemon DestroyPod; failures are logged but NOT fatal so pod
  teardown never wedges (kube_dtn.go:103-144).
- cmdCheck: accepted no-op (the reference leaves it unimplemented,
  kube_dtn.go:182-185).

Port of kubedtn_tpu/cni.py: the same protocol, conf installer and error
result, dialing the port's DaemonClient. Run it as the plugin binary
with `python -m kubedtn_tpu_torch.cni` (CNI env, the network conf on
stdin).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

DEFAULT_PORT = 51111
CONFLIST_NAME = "00-kubedtn.conflist"          # daemon/cni/cni.go:18
LINK_TYPE_FILE = "kubedtn-inter-node-link-type"  # daemon/cni/cni.go:22-24
SUPPORTED_VERSIONS = ["0.3.0", "0.3.1", "0.4.0", "1.0.0"]
# KUBEDTN_CNI_LOG, else kubedtn-cni.log in the temporary directory
# (TMPDIR; /tmp where it is unset, the JAX package's fixed path)
LOG_PATH = os.environ.get("KUBEDTN_CNI_LOG") or os.path.join(
    tempfile.gettempdir(), "kubedtn-cni.log")


def _log(msg: str) -> None:
    try:
        with open(LOG_PATH, "a") as f:
            f.write(msg.rstrip() + "\n")
    except OSError:
        pass


def parse_cni_args(args: str) -> dict[str, str]:
    """CNI_ARGS is ';'-separated K=V pairs (the types.LoadArgs format)."""
    out: dict[str, str] = {}
    for part in (args or "").split(";"):
        if "=" in part:
            k, _, v = part.partition("=")
            out[k.strip()] = v.strip()
    return out


def load_conf(stdin_text: str) -> dict:
    conf = json.loads(stdin_text or "{}")
    conf.setdefault("daemonPort", DEFAULT_PORT)
    return conf


def _client(port: int):
    from kubedtn_tpu_torch.wire.client import DaemonClient

    return DaemonClient(f"127.0.0.1:{port}")


def cmd_add(conf: dict, env: dict[str, str]) -> dict:
    """Returns the result dict to print on stdout (the chained prevResult,
    or a minimal empty result when we are the first plugin)."""
    from kubedtn_tpu_torch.wire import proto as pb

    args = parse_cni_args(env.get("CNI_ARGS", ""))
    name = args.get("K8S_POD_NAME", "")
    ns = args.get("K8S_POD_NAMESPACE", "default")
    net_ns = env.get("CNI_NETNS", "")
    if not name:
        raise RuntimeError("CNI_ARGS missing K8S_POD_NAME")

    client = _client(int(conf.get("daemonPort", DEFAULT_PORT)))
    try:
        resp = client.SetupPod(pb.SetupPodQuery(name=name, kube_ns=ns,
                                                net_ns=net_ns))
        if not resp.response:
            raise RuntimeError(f"SetupPod({ns}/{name}) refused by daemon")
    finally:
        client.close()
    _log(f"ADD {ns}/{name} netns={net_ns} ok")
    return conf.get("prevResult") or {"cniVersion": conf.get("cniVersion",
                                                             "1.0.0")}


def cmd_del(conf: dict, env: dict[str, str]) -> dict:
    from kubedtn_tpu_torch.wire import proto as pb

    args = parse_cni_args(env.get("CNI_ARGS", ""))
    name = args.get("K8S_POD_NAME", "")
    ns = args.get("K8S_POD_NAMESPACE", "default")
    if name:
        try:
            client = _client(int(conf.get("daemonPort", DEFAULT_PORT)))
            try:
                client.DestroyPod(pb.PodQuery(name=name, kube_ns=ns))
            finally:
                client.close()
            _log(f"DEL {ns}/{name} ok")
        except Exception as e:  # never block pod teardown
            _log(f"DEL {ns}/{name} failed (ignored): {e}")
    return {}


def cmd_check(conf: dict, env: dict[str, str]) -> dict:
    del conf, env
    return {}


def main(stdin_text: str | None = None, env: dict[str, str] | None = None
         ) -> int:
    env = dict(os.environ if env is None else env)
    command = env.get("CNI_COMMAND", "")
    if command == "VERSION":
        print(json.dumps({"cniVersion": "1.0.0",
                          "supportedVersions": SUPPORTED_VERSIONS}))
        return 0
    if stdin_text is None:
        stdin_text = sys.stdin.read()
    try:
        conf = load_conf(stdin_text)
        handler = {"ADD": cmd_add, "DEL": cmd_del, "CHECK": cmd_check}.get(
            command)
        if handler is None:
            raise RuntimeError(f"unknown CNI_COMMAND {command!r}")
        result = handler(conf, env)
        if result:
            print(json.dumps(result))
        return 0
    except Exception as e:
        # CNI error result format (spec §Error)
        print(json.dumps({"code": 999, "msg": str(e)}))
        _log(f"{command} error: {e}")
        return 1


# -- daemon-side conf installer (reference daemon/cni/cni.go) ----------

def install_conflist(cni_dir: str, inter_node_link_type: str = "VXLAN",
                     daemon_port: int = DEFAULT_PORT) -> str:
    """Merge the kubedtn plugin into the node's existing conflist.

    Like the reference (cni.go:27-108): take the alphabetically-first
    existing .conf/.conflist as the primary network, append our chained
    plugin, write it as 00-kubedtn.conflist, and drop the link-type file.
    """
    primary = None
    for fn in sorted(os.listdir(cni_dir)):
        if fn == CONFLIST_NAME or not fn.endswith((".conf", ".conflist")):
            continue
        with open(os.path.join(cni_dir, fn)) as f:
            data = json.load(f)
        if fn.endswith(".conf"):  # single-plugin file -> wrap
            data = {"cniVersion": data.get("cniVersion", "1.0.0"),
                    "name": data.get("name", "network"),
                    "plugins": [data]}
        primary = data
        break
    if primary is None:
        primary = {"cniVersion": "1.0.0", "name": "kubedtn", "plugins": []}

    plugins = [p for p in primary.get("plugins", [])
               if p.get("type") != "kubedtn"]
    plugins.append({"type": "kubedtn", "daemonPort": daemon_port})
    primary["plugins"] = plugins

    out = os.path.join(cni_dir, CONFLIST_NAME)
    with open(out, "w") as f:
        json.dump(primary, f, indent=2)
    with open(os.path.join(cni_dir, LINK_TYPE_FILE), "w") as f:
        f.write(inter_node_link_type)
    return out


def remove_conflist(cni_dir: str) -> None:
    """Cleanup on daemon exit (cni.go:138-145)."""
    for fn in (CONFLIST_NAME, LINK_TYPE_FILE):
        try:
            os.remove(os.path.join(cni_dir, fn))
        except FileNotFoundError:
            pass


def inter_node_link_type(cni_dir: str) -> str:
    """What the plugin reads to pick VXLAN vs GRPC wires
    (plugin/kube_dtn.go:146-159)."""
    try:
        with open(os.path.join(cni_dir, LINK_TYPE_FILE)) as f:
            return f.read().strip()
    except FileNotFoundError:
        return "VXLAN"


if __name__ == "__main__":
    sys.exit(main())
