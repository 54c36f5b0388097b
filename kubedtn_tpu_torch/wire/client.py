"""gRPC client for the daemon — the role the reference controller and CNI
plugin play against port 51111 (reference
controllers/topology_controller.go:320-329, plugin/kube_dtn.go:80-87)."""

from __future__ import annotations

import grpc

from kubedtn_tpu_torch.wire import proto as pb

GRPC_PORT = 51111  # reference common/constants.go:9


def daemon_address(host: str) -> str:
    """Normalize a node address to host:port, defaulting the daemon port.
    Handles bare IPv4, host:port, bare IPv6 (bracketed for gRPC), and
    already-bracketed IPv6 with or without a port."""
    if host.startswith("["):
        return host if "]:" in host else f"{host}:{GRPC_PORT}"
    if host.count(":") >= 2:  # bare IPv6 literal
        return f"[{host}]:{GRPC_PORT}"
    if ":" in host:
        return host
    return f"{host}:{GRPC_PORT}"


def dial_daemon(host: str) -> "DaemonClient":
    """Dial a peer daemon by node address (the reference's
    `passthrough:///<nodeIP>:51111`, common/utils.go:53-62)."""
    return DaemonClient(daemon_address(host))


class DaemonClient:
    def __init__(self, address: str) -> None:
        self._channel = grpc.insecure_channel(address)
        self._calls = {}
        for service, methods in [("Local", pb.LOCAL_METHODS),
                                 ("Remote", pb.REMOTE_METHODS),
                                 ("WireProtocol", pb.WIRE_METHODS)]:
            for m, (req, resp, streaming) in methods.items():
                path = f"/{pb.PACKAGE}.{service}/{m}"
                if streaming:
                    self._calls[m] = self._channel.stream_unary(
                        path, request_serializer=req.SerializeToString,
                        response_deserializer=resp.FromString)
                else:
                    self._calls[m] = self._channel.unary_unary(
                        path, request_serializer=req.SerializeToString,
                        response_deserializer=resp.FromString)

    def __getattr__(self, name):
        try:
            return self._calls[name]
        except KeyError:
            raise AttributeError(name) from None

    def close(self) -> None:
        self._channel.close()
