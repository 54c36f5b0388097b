"""Golden-parity parsers for link-property strings.

The reference parses user-facing property strings in Go
(reference common/qdisc.go:128-199); these functions reproduce that exact
semantics so a topology written for the reference behaves identically here:

- percentages:  float in [0, 100], "" -> 0            (qdisc.go:128-143)
- durations:    Go time.ParseDuration, truncated to whole microseconds,
                negative rejected, "" -> 0            (qdisc.go:145-158)
- rates:        integer + optional SI/IEC prefix + "bit"|"bps" suffix,
                "bps" multiplies by 8, "" -> 0        (qdisc.go:160-199)
- TBF burst:    max(rate/250, 5000) bytes             (qdisc.go:360-370)

The parsers are pure Python (control plane, runs once per link update); the
parsed numerics land in device arrays (see kubedtn_tpu_torch.ops.edge_state).
"""

from __future__ import annotations

import math
import re

# TBF qdisc constants the reference hard-codes when installing the qdisc
# (tc invocation at reference common/qdisc.go:253-266).
TBF_LATENCY_US = 50_000  # "latency 50ms"
TBF_MINBURST = 1500  # "minburst 1500"

_GO_UNIT_NS = {
    "ns": 1,
    "us": 1_000,
    "µs": 1_000,  # µs (micro sign)
    "μs": 1_000,  # μs (greek mu)
    "ms": 1_000_000,
    "s": 1_000_000_000,
    "m": 60_000_000_000,
    "h": 3_600_000_000_000,
}

_DURATION_TOKEN = re.compile(r"(\d+(?:\.\d*)?|\.\d+)(ns|us|µs|μs|ms|s|m|h)")


def parse_percentage(value: str | None) -> float:
    """Percentage string -> float in [0, 100]; "" -> 0.

    Mirrors ParseFloatPercentage (reference common/qdisc.go:128-143): empty is
    zero, NaN and out-of-range rejected.
    """
    if not value:
        return 0.0
    try:
        v = float(value)
    except ValueError as e:
        raise ValueError(f"invalid percentage {value!r}: {e}") from None
    if math.isnan(v):
        raise ValueError("percentage value must be a number")
    if v < 0 or v > 100:
        raise ValueError("percentage value must be between 0 and 100")
    return v


def parse_duration_us(value: str | None) -> int:
    """Duration string -> whole microseconds; "" -> 0.

    Mirrors ParseDuration (reference common/qdisc.go:145-158), which delegates
    to Go time.ParseDuration then truncates to microseconds: a duration is one
    or more `<decimal><unit>` tokens ("1.5s", "1h2m", "300ms"), units
    ns/us/µs/ms/s/m/h; "0" alone is valid; negatives rejected.
    """
    if not value:
        return 0
    s = value.strip()
    neg = False
    if s and s[0] in "+-":
        neg = s[0] == "-"
        s = s[1:]
    if s == "0":
        return 0
    total_ns = 0
    pos = 0
    matched = False
    while pos < len(s):
        m = _DURATION_TOKEN.match(s, pos)
        if not m:
            raise ValueError(f"invalid duration {value!r}")
        matched = True
        total_ns += float(m.group(1)) * _GO_UNIT_NS[m.group(2)]
        pos = m.end()
    if not matched:
        raise ValueError(f"invalid duration {value!r}")
    if neg:
        raise ValueError("duration value must be positive")
    return int(total_ns) // 1_000


def parse_rate_bps(value: str | None) -> int:
    """Rate string -> bits per second; "" -> 0.

    Mirrors ParseRate (reference common/qdisc.go:160-199): lowercase, trim;
    strip "bit" (x1) or "bps" (x8) suffix; "i" selects IEC base 1024 over SI
    1000; k/m/g/t prefix gives base^1..4; the remainder must parse as an unsigned
    integer (decimals are rejected, exactly like Go strconv.ParseUint).
    Examples: "1000" -> 1000, "100kbit" -> 100_000, "100Mbps" -> 800_000_000,
    "1Gibps" -> 8*1024^3.
    """
    if value is None:
        return 0
    s = value.strip().lower()
    if not s:
        return 0

    mult = 1
    if s.endswith("bit"):
        s = s[: -len("bit")]
    elif s.endswith("bps"):
        s = s[: -len("bps")]
        mult = 8

    base = 1000
    if s.endswith("i"):
        s = s[:-1]
        base = 1024

    for i, unit in enumerate(("k", "m", "g", "t")):
        if s.endswith(unit):
            s = s[:-1]
            mult *= base ** (i + 1)
            break

    if not re.fullmatch(r"\d+", s):
        raise ValueError(f"invalid rate {value!r}")
    return int(s) * mult


def tbf_burst_bytes(rate_bps: int) -> int:
    """Token-bucket burst size for a given rate.

    Mirrors getTbfBurst (reference common/qdisc.go:360-370): at least
    rate/250 (kernel HZ), floored at 5000 bytes.
    """
    return max(rate_bps // 250, 5000)
