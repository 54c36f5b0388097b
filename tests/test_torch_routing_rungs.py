"""Port parity: the three routing rungs of kubedtn_tpu_torch.scenarios
(`routes_10k`, `chaos_flaps`, `reconverge_10k`) against
kubedtn_tpu.scenarios, on the CPU, at small sizes.

Each rung runs in both packages on the same arguments, its result has
every JAX key and "device", and every key but the host timings is equal:
`routes_10k` and `chaos_flaps` at small node and link counts;
`reconverge_10k`, which takes no size arguments in JAX, with
`kubedtn_tpu.scenarios.T.three_tier` monkeypatched to a small fabric and
the same sizes passed to the port's `pods=` / `leaves_per_pod=`.

`chaos_flaps` draws nothing (1 ms latency-only links, CBR traffic), so
its packet counts must be equal. The traffic credit's known last-bit
divergence (ROADMAP §3) could move an emission by a step; here it does
not: the traced JAX step adds f32 250.00002 bytes a step at 2 Mbit/s and
1 ms, the port 250 exactly, and over these steps no row's credit crosses
a packet boundary on a different step (`test_chaos_flaps_credit_crosses_
packet_boundaries_on_the_same_steps` checks that premise).
"""

import numpy as np
import pytest

from kubedtn_tpu import scenarios as jsc
from kubedtn_tpu_torch import scenarios as tsc

TIMED = {"wall_s", "recompute_s_first", "recompute_s_steady",
         "down_recompute_s", "up_recompute_s", "recompute_s_median",
         "initial_full_s", "full_recompute_s", "reconverge_s",
         "reconverge_s_steady", "speedup_vs_full", "flap10_down_s",
         "flap10_up_s", "device"}


def untimed(x):
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items() if k not in TIMED}
    if isinstance(x, list):
        return [untimed(v) for v in x]
    return x


def both(name, jkw, tkw=None):
    import chip_smoke

    j = jsc.LADDER[name](**jkw)
    t = tsc.LADDER[name](device="cpu", **(jkw if tkw is None else tkw))
    assert set(t) == set(j) | {"device"}, set(t) ^ set(j)
    assert chip_smoke.RUNG_KEYS[name] == set(j)
    assert t["device"] == "cpu" and t["scenario"] == j["scenario"] == name
    assert untimed(t) == untimed(j)
    return j, t


@pytest.mark.parametrize("n_nodes,n_links", [(200, 600), (120, 150)])
def test_routes_10k_matches_jax(n_nodes, n_links):
    _, t = both("routes_10k", dict(n_nodes=n_nodes, n_links=n_links,
                                   events=3, dst_chunk=40))
    assert 0 < t["reachable_frac"] <= 1
    assert t["recompute_s_steady"] is not None


@pytest.mark.parametrize("n_links", [70, 180])
def test_chaos_flaps_matches_jax(n_links):
    _, t = both("chaos_flaps", dict(n_nodes=60, n_links=n_links, events=2,
                                    steps_per_event=10))
    assert t["baseline_rx"] > 0
    assert t["traffic_survived_every_outage"]
    if n_links == 70:   # a sparse mesh: flapped links cut some routes
        assert all(e["no_route_during_outage"] > 0
                   for e in t["event_results"])


def test_chaos_flaps_credit_crosses_packet_boundaries_on_the_same_steps():
    """The premise of the exact comparison above: with the JAX step's
    traced credit increment and the port's exact one, every row emits on
    the same steps through every run of the rung at these sizes (30
    steps a phase at most, credit carried across phases: 5 phases)."""
    f32 = np.float32
    traced = f32(2e6) * (f32(1000.0) * f32(1 / 8e6))
    exact = f32(2e6) / f32(8e6) * f32(1000.0)
    assert traced == f32(250.00002) and exact == f32(250.0)
    cj = cp = f32(0.0)
    for step in range(5 * 30):
        cj, cp = f32(cj + traced), f32(cp + exact)
        nj, np_ = np.floor(cj / f32(1500.0)), np.floor(cp / f32(1500.0))
        assert nj == np_, step
        cj, cp = f32(cj - nj * f32(1500.0)), f32(cp - np_ * f32(1500.0))


def test_reconverge_10k_matches_jax_on_a_small_three_tier(monkeypatch):
    orig = jsc.T.three_tier
    monkeypatch.setattr(jsc.T, "three_tier",
                        lambda seed=0: orig(pods=3, leaves_per_pod=8,
                                            seed=seed))
    _, t = both("reconverge_10k", dict(events=4, seed=0),
                dict(events=4, seed=0, pods=3, leaves_per_pod=8))
    assert t["matches_full_recompute"] is True
    assert t["nodes"] == 3 * (8 + 4) + 40 and t["flap10_cells"] > 0


def test_reconverge_10k_defaults_are_jax_defaults():
    import inspect

    from kubedtn_tpu_torch.models import topologies as tT

    jp = inspect.signature(jsc.reconverge_10k).parameters
    tp = inspect.signature(tsc.reconverge_10k).parameters
    for name, p in jp.items():
        assert tp[name].default == p.default, name
    top = inspect.signature(tT.three_tier).parameters
    assert tp["pods"].default == top["pods"].default
    assert tp["leaves_per_pod"].default == top["leaves_per_pod"].default
