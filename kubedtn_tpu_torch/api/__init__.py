from kubedtn_tpu_torch.api.parsers import (
    parse_duration_us,
    parse_percentage,
    parse_rate_bps,
    tbf_burst_bytes,
    TBF_LATENCY_US,
    TBF_MINBURST,
)
from kubedtn_tpu_torch.api.types import (
    Link,
    LinkProperties,
    Topology,
    TopologySpec,
    TopologyStatus,
    links_equal_without_properties,
)

__all__ = [
    "parse_duration_us",
    "parse_percentage",
    "parse_rate_bps",
    "tbf_burst_bytes",
    "TBF_LATENCY_US",
    "TBF_MINBURST",
    "Link",
    "LinkProperties",
    "Topology",
    "TopologySpec",
    "TopologyStatus",
    "links_equal_without_properties",
]
