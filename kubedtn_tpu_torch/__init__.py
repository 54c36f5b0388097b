"""kubedtn_tpu_torch — the PyTorch/CUDA port of kubedtn_tpu.

Same data model as the JAX package: every directed link is one row of a
structure-of-arrays EdgeState, shaped per packet by the netem -> TBF qdisc
chain of the reference (dtn-dslab/kube-dtn). Module paths mirror
kubedtn_tpu's, so each counterpart sits at the same place:

    api/             Topology schema + golden-parity parsers (copied)
    models/          topology generators + the fast loader
    ops/edge_state   EdgeState + batched apply/update/delete links
    ops/netem        netem + TBF shaping as plain tensor code
    ops/cuda/        hand-written Hopper kernels (ops/pallas's counterpart)
    ops/queues       K shaping slots per step + the in-flight delay line
    models/traffic   CBR / Poisson / ON-OFF packet sources
    sim              the time-stepped K-slot simulator
    ops/routing      all-pairs distances, next hops, ECMP, incremental
    router           multi-hop forwarding over the simulated fabric
    runtime          the live tick's device program (parallel/: sharded)
                     and the host live plane (WireDataPlane)
    topology/        TopologyStore, Reconciler, SimEngine (control plane)
    wire/            the Daemon's gRPC services, schema and client
    native           ctypes bindings of native/kubedtn_native.cc
    telemetry        the window fold, LinkTelemetry, FlightRecorder

The package imports torch and never jax, nor anything of kubedtn_tpu.
Entry points that create tensors take `device=None`, which means the
CUDA card; without one they raise instead of falling back to the CPU.
Pass `device="cpu"` to run the plain tensor versions on the host.
"""

from __future__ import annotations

__version__ = "0.1.0"

# Group/version identity kept parity-compatible with the reference CRD
# (ref: api/v1/groupversion_info.go:28-36).
GROUP = "y-young.github.io"
VERSION = "v1"
GROUP_VERSION = f"{GROUP}/{VERSION}"


def resolve_device(device=None) -> "torch.device":
    """`None` -> the CUDA card; raises when CUDA is unavailable (no
    silent fallback to the CPU). Anything else passes through
    torch.device. (torch is imported here, not with the package: the
    CLI's client verbs and the shm producer never touch it.)"""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "kubedtn_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain tensor path on the host")
        return torch.device("cuda")
    return torch.device(device)
