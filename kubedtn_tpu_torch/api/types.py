"""Topology API types — parity schema with the reference CRD.

Mirrors the reference's Topology custom resource (reference
api/v1/topology_types.go:28-219): a Topology is one pod's view of its
point-to-point links; each Link carries local/peer interface names, optional
IP/MAC, a peer pod name, a cluster-unique uid, and shaping properties.

Field names and JSON keys are kept identical to the reference so its YAML
samples (reference config/samples/) load unmodified. Validation patterns are
the same kubebuilder regexes (topology_types.go:65-175).
"""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass, field
from typing import Any, Iterable

from kubedtn_tpu_torch.api.parsers import (
    parse_duration_us,
    parse_percentage,
    parse_rate_bps,
)

# kubebuilder validation patterns from the reference CRD
# (reference api/v1/topology_types.go:65,70,112,116,145).
IP_PATTERN = re.compile(
    r"^((([0-9]|[1-9][0-9]|1[0-9]{2}|2[0-4][0-9]|25[0-5])\.){3}"
    r"([0-9]|[1-9][0-9]|1[0-9]{2}|2[0-4][0-9]|25[0-5])"
    r"(\/(3[0-2]|[1-2][0-9]|[0-9]))?)?$"
)
MAC_PATTERN = re.compile(r"^(([0-9A-Fa-f]{2}[:-]){5}[0-9A-Fa-f]{2})?$")
PERCENTAGE_PATTERN = re.compile(r"^(100(\.0+)?|\d{1,2}(\.\d+)?)$")
DURATION_PATTERN = re.compile(r"^(\d+(\.\d+)?(ns|us|µs|μs|ms|s|m|h))+$")
RATE_PATTERN = re.compile(r"^\d+(\.\d+)?([KkMmGg]i?)?(bit|bps)?$")

# Sentinel peer names with special dispatch in the reference daemon:
# "localhost" selects a macvlan link (reference daemon/kubedtn/handler.go:333),
# "physical/<ip>" a link to a physical host (handler.go:348).
LOCALHOST = "localhost"
PHYSICAL_PREFIX = "physical/"


@dataclass(frozen=True)
class LinkProperties:
    """Emulated link properties (reference api/v1/topology_types.go:119-176).

    All string-typed fields keep the reference's string encodings (durations
    "10ms", percentages "25.5", rates "100Mbps"); `to_numeric` produces the
    parsed record that lands in device arrays.
    """

    latency: str = ""
    latency_corr: str = ""
    jitter: str = ""
    loss: str = ""
    loss_corr: str = ""
    rate: str = ""
    gap: int = 0
    duplicate: str = ""
    duplicate_corr: str = ""
    reorder_prob: str = ""
    reorder_corr: str = ""
    corrupt_prob: str = ""
    corrupt_corr: str = ""

    def validate(self) -> None:
        """Apply the CRD's kubebuilder validation patterns."""
        for name in (
            "latency_corr", "loss", "loss_corr", "duplicate", "duplicate_corr",
            "reorder_prob", "reorder_corr", "corrupt_prob", "corrupt_corr",
        ):
            v = getattr(self, name)
            if v and not PERCENTAGE_PATTERN.match(v):
                raise ValueError(f"invalid percentage for {name}: {v!r}")
        for name in ("latency", "jitter"):
            v = getattr(self, name)
            if v and not DURATION_PATTERN.match(v):
                raise ValueError(f"invalid duration for {name}: {v!r}")
        if self.rate and not RATE_PATTERN.match(self.rate):
            raise ValueError(f"invalid rate: {self.rate!r}")
        if self.gap < 0:
            raise ValueError("gap must be >= 0")

    def is_empty(self) -> bool:
        """True when no property is set (the reference skips qdisc creation
        entirely in that case — common/qdisc.go:24-26)."""
        return self == LinkProperties()

    def to_numeric(self) -> dict[str, float | int]:
        """Parse to the numeric record stored per edge on device.

        Same parse calls, in the same units, as MakeQdiscs (reference
        common/qdisc.go:20-126): durations to whole µs, percentages to floats
        in [0,100], rate to bits/sec.

        Memoized on the (frozen, hashable) instance: at 100k-link scale the
        same handful of property sets is parsed millions of times, and the
        string parsing dominated reconcile profiles.
        """
        return dict(_numeric_memo(self))

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "LinkProperties":
        if not d:
            return cls()
        try:
            # a topology's links share a handful of property sets, and
            # the instances are frozen: one per distinct set
            return _props_from_items(cls, tuple(d.items()))
        except TypeError:  # an unhashable value: built as given
            return _props_from_items.__wrapped__(cls, tuple(d.items()))

    def to_dict(self) -> dict[str, Any]:
        out = {}
        for k in self.__dataclass_fields__:
            v = getattr(self, k)
            if v not in ("", 0):
                out[k] = v
        return out


@functools.lru_cache(maxsize=4096)
def _props_from_items(cls, items: tuple) -> "LinkProperties":
    d = dict(items)
    unknown = set(d) - set(cls.__dataclass_fields__)
    if unknown:
        raise ValueError(f"unknown LinkProperties fields: {sorted(unknown)}")
    return cls(**d)


@functools.lru_cache(maxsize=65536)
def _numeric_memo(props: "LinkProperties") -> tuple:
    """Cached parse of one LinkProperties value (frozen ⇒ hashable). Stored
    as an items-tuple so the cache entry itself is immutable; to_numeric
    hands each caller a fresh dict."""
    return (
        ("latency_us", parse_duration_us(props.latency)),
        ("latency_corr", parse_percentage(props.latency_corr)),
        ("jitter_us", parse_duration_us(props.jitter)),
        ("loss", parse_percentage(props.loss)),
        ("loss_corr", parse_percentage(props.loss_corr)),
        ("rate_bps", parse_rate_bps(props.rate)),
        ("gap", int(props.gap)),
        ("duplicate", parse_percentage(props.duplicate)),
        ("duplicate_corr", parse_percentage(props.duplicate_corr)),
        ("reorder_prob", parse_percentage(props.reorder_prob)),
        ("reorder_corr", parse_percentage(props.reorder_corr)),
        ("corrupt_prob", parse_percentage(props.corrupt_prob)),
        ("corrupt_corr", parse_percentage(props.corrupt_corr)),
    )


@dataclass(frozen=True)
class Link:
    """One p2p link from the local pod's perspective
    (reference api/v1/topology_types.go:59-95)."""

    local_intf: str
    peer_intf: str
    peer_pod: str
    uid: int
    local_ip: str = ""
    peer_ip: str = ""
    local_mac: str = ""
    peer_mac: str = ""
    properties: LinkProperties = field(default_factory=LinkProperties)

    def with_properties(self, properties: "LinkProperties") -> "Link":
        """Copy of this link with different properties — the hot spec-edit
        operation (UpdateLinks churn touches every link). ~4× faster than
        dataclasses.replace, which re-runs field resolution per call;
        identity fields are shared, so calc_diff still matches by key."""
        new = object.__new__(Link)
        new.__dict__.update(self.__dict__)
        new.__dict__["properties"] = properties
        return new

    def validate(self) -> None:
        for name in ("local_ip", "peer_ip"):
            v = getattr(self, name)
            if not IP_PATTERN.match(v):
                raise ValueError(f"invalid IP for {name}: {v!r}")
        for name in ("local_mac", "peer_mac"):
            v = getattr(self, name)
            if not MAC_PATTERN.match(v):
                raise ValueError(f"invalid MAC for {name}: {v!r}")
        self.properties.validate()

    def is_macvlan(self) -> bool:
        return self.peer_pod == LOCALHOST

    def is_physical(self) -> bool:
        return self.peer_pod.startswith(PHYSICAL_PREFIX)

    def physical_peer_ip(self) -> str:
        return self.peer_pod[len(PHYSICAL_PREFIX):]

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Link":
        # the instance dict filled in field order, as with_properties
        # does: the frozen __init__ sets each field through
        # object.__setattr__, and a restore builds 200,000 links
        new = object.__new__(cls)
        new.__dict__.update(
            local_intf=d["local_intf"],
            peer_intf=d.get("peer_intf", ""),
            peer_pod=d["peer_pod"],
            uid=int(d["uid"]),
            local_ip=d.get("local_ip", ""),
            peer_ip=d.get("peer_ip", ""),
            local_mac=d.get("local_mac", ""),
            peer_mac=d.get("peer_mac", ""),
            properties=LinkProperties.from_dict(d.get("properties")),
        )
        return new

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "local_intf": self.local_intf,
            "peer_intf": self.peer_intf,
            "peer_pod": self.peer_pod,
            "uid": self.uid,
        }
        for k in ("local_ip", "peer_ip", "local_mac", "peer_mac"):
            v = getattr(self, k)
            if v:
                out[k] = v
        props = self.properties.to_dict()
        if props:
            out["properties"] = props
        return out


def links_equal_without_properties(a: Link, b: Link) -> bool:
    """Identity comparison ignoring shaping properties — the reconciler's
    notion of "same link" (reference controllers/topology_controller.go:342-351)."""
    return (
        a.local_intf == b.local_intf
        and a.local_ip == b.local_ip
        and a.local_mac == b.local_mac
        and a.peer_intf == b.peer_intf
        and a.peer_ip == b.peer_ip
        and a.peer_mac == b.peer_mac
        and a.peer_pod == b.peer_pod
        and a.uid == b.uid
    )


@dataclass
class TopologySpec:
    """Desired state (reference api/v1/topology_types.go:28-34)."""

    links: list[Link] = field(default_factory=list)

    def clone(self) -> "TopologySpec":
        """List copy; Link objects are immutable and shared."""
        return TopologySpec(links=list(self.links))


@dataclass
class TopologyStatus:
    """Observed state (reference api/v1/topology_types.go:37-56).

    `links` is None (not empty list) until first reconcile — the reconciler's
    "first-seen" rule keys off that distinction
    (reference controllers/topology_controller.go:81-85).
    """

    skipped: list[str] = field(default_factory=list)
    src_ip: str = ""
    net_ns: str = ""
    links: list[Link] | None = None

    def clone(self) -> "TopologyStatus":
        """List copies; Link objects are immutable and shared."""
        return TopologyStatus(
            skipped=list(self.skipped),
            src_ip=self.src_ip,
            net_ns=self.net_ns,
            links=list(self.links) if self.links is not None else None,
        )


@dataclass
class Topology:
    """One pod's topology resource (reference api/v1/topology_types.go:200-206)."""

    name: str
    namespace: str = "default"
    spec: TopologySpec = field(default_factory=TopologySpec)
    status: TopologyStatus = field(default_factory=TopologyStatus)
    finalizers: list[str] = field(default_factory=list)
    resource_version: int = 0
    deletion_requested: bool = False

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def clone(self) -> "Topology":
        """Structural copy exploiting Link/LinkProperties immutability
        (both are frozen dataclasses): lists are copied, Link objects are
        SHARED. Equivalent to deepcopy for every supported mutation
        (callers replace Links, never mutate them) at a fraction of the
        cost — the store clones on every read/write, and generic deepcopy
        dominated reconcile profiles at 100k links."""
        return Topology(
            name=self.name,
            namespace=self.namespace,
            spec=self.spec.clone(),
            status=self.status.clone(),
            finalizers=list(self.finalizers),
            resource_version=self.resource_version,
            deletion_requested=self.deletion_requested,
        )

    def is_alive(self) -> bool:
        """A pod is alive when placement is known (reference
        daemon/kubedtn/handler.go:99,386)."""
        return bool(self.status.src_ip) and bool(self.status.net_ns)

    def validate(self) -> None:
        seen: set[tuple[str, int]] = set()
        for link in self.spec.links:
            link.validate()
            k = (link.local_intf, link.uid)
            if k in seen:
                raise ValueError(
                    f"duplicate (local_intf, uid) in {self.name}: {k}"
                )
            seen.add(k)

    @classmethod
    def from_manifest(cls, d: dict[str, Any]) -> "Topology":
        """Build from a K8s-style manifest dict (apiVersion/kind/metadata/spec),
        the format of the reference's samples (reference config/samples/3node.yml)."""
        meta = d.get("metadata", {})
        spec = d.get("spec", {}) or {}
        links = [Link.from_dict(x) for x in (spec.get("links") or [])]
        status_d = d.get("status") or {}
        status = TopologyStatus(
            skipped=list(status_d.get("skipped") or []),
            src_ip=status_d.get("src_ip", ""),
            net_ns=status_d.get("net_ns", ""),
            links=(
                [Link.from_dict(x) for x in status_d["links"]]
                if status_d.get("links") is not None
                else None
            ),
        )
        return cls(
            name=meta["name"],
            namespace=meta.get("namespace", "default"),
            spec=TopologySpec(links=links),
            status=status,
        )

    def to_manifest(self) -> dict[str, Any]:
        from kubedtn_tpu_torch import GROUP_VERSION

        d: dict[str, Any] = {
            "apiVersion": GROUP_VERSION,
            "kind": "Topology",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": {"links": [l.to_dict() for l in self.spec.links]},
        }
        status: dict[str, Any] = {}
        if self.status.skipped:
            status["skipped"] = list(self.status.skipped)
        if self.status.src_ip:
            status["src_ip"] = self.status.src_ip
        if self.status.net_ns:
            status["net_ns"] = self.status.net_ns
        if self.status.links is not None:
            status["links"] = [l.to_dict() for l in self.status.links]
        if status:
            d["status"] = status
        return d


def load_manifests(docs: Iterable[dict[str, Any]]) -> list[Topology]:
    """Extract Topology resources from a stream of K8s manifests, unwrapping
    v1 Lists — accepts the reference's sample files as-is."""
    out: list[Topology] = []
    for doc in docs:
        if not doc:
            continue
        kind = doc.get("kind", "")
        if kind == "List":
            out.extend(load_manifests(doc.get("items", [])))
        elif kind == "Topology":
            out.append(Topology.from_manifest(doc))
    return out


def load_yaml(path_or_text: str) -> list[Topology]:
    """Load Topology resources from a YAML file path or YAML text."""
    import os

    import yaml

    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    else:
        text = path_or_text
    return load_manifests(yaml.safe_load_all(text))
