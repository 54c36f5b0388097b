"""Traffic models — per-edge packet sources for the data plane.

Port of kubedtn_tpu/models/traffic.py. The reference measures its data
plane with external traffic generators (ping, iperf pods); here the
generators are part of the framework, over every edge at once:

- CBR: constant bit rate, byte-credit accumulator.
- Poisson: Poisson packet arrivals at a mean rate.
- ON/OFF: two-state bursty source (exponential sojourn times) gating a CBR.

Each step every edge emits up to K packet slots (sizes, validity, arrival
offsets inside the step) with static shapes.

`generate` draws from a torch.Generator, or takes the draws themselves
(`TrafficDraws`), which is how the tests feed the JAX package's draws to
both packages.

ROUNDING. Every operation here rounds once, and `rate_bps / 8e6` is a
true division: that is bit for bit the program XLA compiles for the JAX
package's `sim.run`, where the traffic spec and the step length are
compile-time constants, so `rate / 8e6` and its product with dt are
folded exactly. Where they are traced arguments (`sim_step`,
`run_routed`), XLA instead computes `rate * (dt * f32(1/8e6))`, the two
scalars first; `traffic.credit` then differs from this module's in the
last bit (packet counts do not).
"""

from __future__ import annotations

import dataclasses

import torch

from kubedtn_tpu_torch import resolve_device

MODE_OFF = 0
MODE_CBR = 1
MODE_POISSON = 2
MODE_ONOFF = 3

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Static per-edge traffic configuration."""

    mode: torch.Tensor       # i32[E]
    rate_bps: torch.Tensor   # f32[E] offered load (mean for poisson/onoff)
    pkt_bytes: torch.Tensor  # f32[E]
    on_us: torch.Tensor      # f32[E] mean ON sojourn (onoff)
    off_us: torch.Tensor     # f32[E] mean OFF sojourn (onoff)


@dataclasses.dataclass(frozen=True)
class TrafficState:
    """Mutable per-edge source state."""

    credit: torch.Tensor     # f32[E] accumulated bytes not yet emitted
    on: torch.Tensor         # bool[E] ON/OFF gate


@dataclasses.dataclass(frozen=True)
class TrafficDraws:
    """One step's random inputs of `generate`."""

    u_onoff: torch.Tensor    # f32[E] uniforms of the ON/OFF toggles
    n_poisson: torch.Tensor  # f32[E] Poisson packet counts (any value on
    #                          rows that are not MODE_POISSON)
    u_arr: torch.Tensor      # f32[E, K] uniforms of the Poisson arrivals


def cbr_everywhere(capacity: int, n_edges: int, rate_bps: float,
                   pkt_bytes: float = 1500.0, device=None) -> TrafficSpec:
    """Convenience: CBR on the first n_edges rows, off elsewhere, on
    `device` (None = the CUDA card)."""
    dev = resolve_device(device)
    on = torch.arange(capacity, device=dev) < n_edges
    return TrafficSpec(
        mode=torch.where(on, MODE_CBR, MODE_OFF).to(torch.int32),
        rate_bps=torch.where(on, float(rate_bps), 0.0).to(F32),
        pkt_bytes=torch.full((capacity,), pkt_bytes, dtype=F32, device=dev),
        on_us=torch.zeros(capacity, dtype=F32, device=dev),
        off_us=torch.zeros(capacity, dtype=F32, device=dev),
    )


def init_traffic_state(capacity: int, device=None) -> TrafficState:
    dev = resolve_device(device)
    return TrafficState(
        credit=torch.zeros(capacity, dtype=F32, device=dev),
        on=torch.ones(capacity, dtype=torch.bool, device=dev),
    )


def _rate_bytes_per_us(spec: TrafficSpec) -> torch.Tensor:
    """rate_bps / 8e6 as a true division. A tensor divisor, not a Python
    scalar: torch's CUDA kernel multiplies by a scalar divisor's
    reciprocal, which is an ulp off for most rates."""
    return spec.rate_bps / torch.full_like(spec.rate_bps, 8e6)


def poisson_mean(spec: TrafficSpec, dt_us) -> torch.Tensor:
    """f32[E] mean packets per step of the Poisson rows (0 elsewhere)."""
    lam = _rate_bytes_per_us(spec) * dt_us / torch.clamp_min(spec.pkt_bytes,
                                                             1.0)
    return torch.where(spec.mode == MODE_POISSON, lam, 0.0)


def draw(spec: TrafficSpec, dt_us, k: int,
         generator: torch.Generator) -> TrafficDraws:
    """One step's draws from `generator` (on the spec's device)."""
    E, dev = spec.mode.shape[0], spec.mode.device
    return TrafficDraws(
        u_onoff=torch.rand(E, generator=generator, dtype=F32, device=dev),
        n_poisson=torch.poisson(poisson_mean(spec, dt_us),
                                generator=generator),
        u_arr=torch.rand((E, k), generator=generator, dtype=F32, device=dev),
    )


def generate(spec: TrafficSpec, ts: TrafficState, dt_us, k: int,
             generator: torch.Generator | None = None, *,
             draws: TrafficDraws | None = None):
    """Emit up to k packets per edge for one step of length dt_us (a
    float or a 0-dim f32 tensor).

    Returns (ts', sizes f32[E,K], valid bool[E,K], t_arrival f32[E,K]).
    Arrivals are offsets in [0, dt_us), sorted along K."""
    if draws is None:
        if generator is None:
            raise ValueError("generate needs a generator or the draws")
        draws = draw(spec, dt_us, k, generator)
    dev = spec.mode.device
    rate_b_us = _rate_bytes_per_us(spec)

    # ON/OFF gate: per-step toggle probabilities from exponential sojourns.
    p_off2on = torch.where(spec.off_us > 0, 1 - torch.exp(
        -dt_us / torch.clamp_min(spec.off_us, 1.0)), 1.0)
    p_on2off = torch.where(spec.on_us > 0, 1 - torch.exp(
        -dt_us / torch.clamp_min(spec.on_us, 1.0)), 0.0)
    u = draws.u_onoff
    toggled_on = torch.where(ts.on, u >= p_on2off, u < p_off2on)
    is_onoff = spec.mode == MODE_ONOFF
    gate = toggled_on | ~is_onoff

    # CBR / ON-gated CBR: credit accumulator.
    is_cbr = (spec.mode == MODE_CBR) | (is_onoff & gate)
    pkt = torch.clamp_min(spec.pkt_bytes, 1.0)
    credit = ts.credit + torch.where(is_cbr, rate_b_us * dt_us, 0.0)
    n_cbr = torch.floor(credit / pkt)

    # Poisson: mean packets per step = rate / pkt_size.
    is_poisson = spec.mode == MODE_POISSON
    n = torch.where(is_poisson, draws.n_poisson.to(F32), n_cbr)
    n = torch.where(spec.mode == MODE_OFF, 0.0, n)
    n = torch.clamp_max(n, float(k))
    credit = torch.where(is_cbr, credit - n * spec.pkt_bytes, credit)

    lane = torch.arange(k, dtype=F32, device=dev)[None, :]      # [1, K]
    valid = lane < n[:, None]
    sizes = torch.where(valid, spec.pkt_bytes[:, None], 0.0)

    # arrivals: CBR evenly spaced; poisson uniform-sorted.
    even = (lane + 0.5) / torch.clamp_min(n[:, None], 1.0) * dt_us
    rand = torch.sort(draws.u_arr * dt_us, dim=1).values
    t_arr = torch.where(is_poisson[:, None], rand, even)
    t_arr = torch.where(valid, t_arr, 0.0)

    return (
        TrafficState(credit=credit,
                     on=torch.where(is_onoff, toggled_on, ts.on)),
        sizes, valid, t_arr,
    )
