"""CRD rendering — the Topology CustomResourceDefinition as data.

The reference generates its CRD with kubebuilder from Go struct markers
(reference api/v1/topology_types.go:59-176; rendered in cni.yaml:14-280 and
config/crd/bases/). Here the CRD is rendered from the same source of truth
this framework validates against at load time: the dataclasses and regex
patterns in :mod:`kubedtn_tpu_torch.api.types`. One definition, two
consumers — Python-side validation and the K8s apiserver schema — so they
cannot drift.

`render_crd()` returns the manifest as a dict; `python -m
kubedtn_tpu_torch.cli crd` prints it. Port of kubedtn_tpu/api/crd.py over
the port's api/types.py: the same manifest, key for key (the checked-in
`config/crd/topologies.yaml` is the JAX package's rendering of it).
"""

from __future__ import annotations

from typing import Any

from kubedtn_tpu_torch import GROUP, VERSION
from kubedtn_tpu_torch.api import types as T

PLURAL = "topologies"
CRD_NAME = f"{PLURAL}.{GROUP}"


def _percentage() -> dict[str, Any]:
    return {"type": "string", "pattern": T.PERCENTAGE_PATTERN.pattern}


def _duration() -> dict[str, Any]:
    return {"type": "string", "pattern": T.DURATION_PATTERN.pattern}


def link_properties_schema() -> dict[str, Any]:
    """OpenAPI v3 schema for LinkProperties — field-for-field with
    reference api/v1/topology_types.go:119-176 (defaults included)."""
    return {
        "type": "object",
        "description": "Emulated link properties applied to this link's "
                       "egress shaping (netem/tbf semantics).",
        "properties": {
            "latency": {**_duration(),
                        "description": "propagation delay, e.g. 10ms"},
            "latency_corr": {**_percentage(),
                             "description": "delay correlation percent"},
            "jitter": {**_duration(),
                       "description": "random delay variation, e.g. 1ms"},
            "loss": {**_percentage(),
                     "description": "random packet loss percent"},
            "loss_corr": _percentage(),
            "rate": {"type": "string", "pattern": T.RATE_PATTERN.pattern,
                     "description": "egress rate limit, e.g. 100Mbit"},
            "gap": {"type": "integer", "minimum": 0,
                    "description": "reorder gap (every Nth packet sent "
                                   "immediately when reordering)"},
            "duplicate": _percentage(),
            "duplicate_corr": _percentage(),
            "reorder_prob": _percentage(),
            "reorder_corr": _percentage(),
            "corrupt_prob": _percentage(),
            "corrupt_corr": _percentage(),
        },
    }


def _ip() -> dict[str, Any]:
    return {"type": "string", "pattern": T.IP_PATTERN.pattern}


def _mac() -> dict[str, Any]:
    return {"type": "string", "pattern": T.MAC_PATTERN.pattern}


def link_schema() -> dict[str, Any]:
    """Schema for one Link (reference api/v1/topology_types.go:59-95).

    Every sub-schema dict is freshly constructed (no shared objects), so
    yaml dumpers emit a plain manifest without anchors/aliases.
    """
    return {
        "type": "object",
        "required": ["local_intf", "peer_pod", "uid"],
        "properties": {
            "local_intf": {"type": "string",
                           "description": "interface name in the local pod"},
            "local_ip": _ip(),
            "local_mac": _mac(),
            "peer_intf": {"type": "string"},
            "peer_ip": _ip(),
            "peer_mac": _mac(),
            "peer_pod": {"type": "string",
                         "description": "peer pod name; 'localhost' for a "
                                        "macvlan link, 'physical/<ip>' for "
                                        "a physical-host link"},
            "uid": {"type": "integer",
                    "description": "cluster-unique link id (VNI = 5000+uid)"},
            "properties": link_properties_schema(),
        },
    }


def _links() -> dict[str, Any]:
    return {"type": "array", "items": link_schema()}


def topology_schema() -> dict[str, Any]:
    return {
        "type": "object",
        "properties": {
            "apiVersion": {"type": "string"},
            "kind": {"type": "string"},
            "metadata": {"type": "object"},
            "spec": {
                "type": "object",
                "description": "desired set of links for this pod",
                "properties": {"links": _links()},
            },
            "status": {
                "type": "object",
                "description": "observed state, written by the daemon "
                               "(placement) and reconciler (applied links)",
                "properties": {
                    "skipped": {"type": "array",
                                "items": {"type": "string"},
                                "description": "peers that were not alive "
                                               "at setup time"},
                    "src_ip": {"type": "string",
                               "description": "node IP of the pod's host"},
                    "net_ns": {"type": "string",
                               "description": "pod network-namespace path"},
                    "links": _links(),
                },
            },
        },
    }


def render_crd() -> dict[str, Any]:
    """The full CustomResourceDefinition manifest, apiextensions.k8s.io/v1."""
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": CRD_NAME},
        "spec": {
            "group": GROUP,
            "names": {
                "kind": "Topology",
                "listKind": "TopologyList",
                "plural": PLURAL,
                "singular": "topology",
            },
            "scope": "Namespaced",
            "versions": [
                {
                    "name": VERSION,
                    "served": True,
                    "storage": True,
                    "schema": {"openAPIV3Schema": topology_schema()},
                    # status is a subresource: meta/spec updates and status
                    # updates go through distinct endpoints, which is what
                    # makes the reference's CNI-vs-controller status race
                    # discipline work (reference api/clientset/v1beta1/
                    # topology.go:171-184; SURVEY.md §7 hard-part (f)).
                    "subresources": {"status": {}},
                }
            ],
        },
    }
