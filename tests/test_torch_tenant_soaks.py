"""The tenant scenarios of kubedtn_tpu_torch.scenarios on the CPU:
`noisy_neighbor` over wire ingress and over an shm ring, at the sizes of
the JAX package's smoke tests (tests/test_tenancy.py) and held against
JAX on every count and verdict (the scenario runs on an explicit clock,
so both packages' runs are deterministic), and `tenant_soak` with a
budget on its last tenant behind a real-time runner and a gRPC server,
an injector child per tenant.

The JAX package's planes run under tests/_torch_native_guard.py."""

import inspect

import pytest

from kubedtn_tpu import scenarios as jsc
from kubedtn_tpu_torch import scenarios as tsc

from _torch_native_guard import ensure_jax_native

NN_KW = dict(victim_pairs=1, aggressor_pairs=1, seconds=1.0,
             victim_rate_fps=800, aggressor_rate_fps=8_000,
             aggressor_budget_fps=800)
# every count and verdict of the result (host times and the p99 floats
# aside)
NN_EXACT = ("seconds", "victim_pairs", "aggressor_pairs", "victim_fed",
            "victim_delivered", "victim_lost", "aggressor_fed",
            "aggressor_delivered", "aggressor_admitted",
            "aggressor_budget_fps", "aggressor_budget_cap",
            "aggressor_queued_not_dropped", "aggressor_transport",
            "throttle_events", "victim_throttle_events", "dropped",
            "tick_errors", "victim_slo_met", "aggressor_burning",
            "aggressor_throttled_at_budget", "victim_unharmed",
            "in_guardrails")


@pytest.mark.parametrize("name", ["noisy_neighbor", "tenant_soak"])
def test_defaults_equal_jax(name):
    jp = inspect.signature(getattr(jsc, name)).parameters
    tp = inspect.signature(getattr(tsc, name)).parameters
    assert list(tp) == [*jp, "device"]
    for k, p in jp.items():
        assert tp[k].default == p.default, k
    assert tp["device"].default is None


@pytest.mark.parametrize("via_shm", [False, True], ids=["ingress", "shm"])
def test_noisy_neighbor_equals_jax(via_shm):
    """tests/test_tenancy.py's two smokes on the port, and every count
    and verdict equal to JAX's run, the SLO severities too."""
    assert ensure_jax_native() is None
    j = jsc.noisy_neighbor(**NN_KW, aggressor_via_shm=via_shm)
    t = tsc.noisy_neighbor(**NN_KW, aggressor_via_shm=via_shm,
                           device="cpu")
    assert set(t) == set(j) | {"device"}, set(t) ^ (set(j) | {"device"})
    assert t["device"] == "cpu"
    assert t["in_guardrails"], t
    assert t["victim_lost"] == 0
    assert t["throttle_events"] > 0
    assert t["aggressor_queued_not_dropped"] > 0
    assert (t["aggressor_admitted"] + t["aggressor_queued_not_dropped"]
            == t["aggressor_fed"])  # throttled, never dropped
    assert t["dropped"] == 0
    for k in NN_EXACT:
        assert t[k] == j[k], (k, t[k], j[k])
    assert t["victim_slo"]["severity"] == j["victim_slo"]["severity"]
    assert t["aggressor_slo"]["severity"] == j["aggressor_slo"]["severity"]
    assert t["victim_slo"]["delivery_ratio"] == \
        j["victim_slo"]["delivery_ratio"]
    if via_shm:
        assert t["aggressor_transport"] == "shm"
        assert t["shm"]["throttled_events"] > 0   # verdicts at ring head
        assert t["shm"] == j["shm"]


def test_tenant_soak_budgeted_last_tenant():
    """Two tenants of one pair for 1.5 s behind the real-time runner,
    the last at a budget of 5,000 frames/s: it is throttled, nothing is
    dropped, and every tenant delivers."""
    r = tsc.tenant_soak(tenants=2, pairs_per_tenant=1, seconds=1.5,
                        budget_fps=5_000, settle_s=30.0, device="cpu")
    assert r["device"] == "cpu" and r["scenario"] == "tenant_soak"
    assert r["throttled_tenant"] == "t1"
    assert r["per_tenant"]["t1"]["frame_budget_per_s"] == 5_000.0
    assert r["per_tenant"]["t1"]["throttle_events"] > 0
    assert r["per_tenant"]["t0"]["throttle_events"] == 0
    assert r["dropped"] == 0 and r["tick_errors"] == 0
    for name, v in r["per_tenant"].items():
        assert v["sustained_frames_per_s"] > 0, (name, v)
        assert v["admitted_frames"] > 0, (name, v)
    assert r["plane_frames_per_s"] > 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_tenant_soak_settle_on_warm_residue_fault(pkg, monkeypatch):
    """A fault of the JAX scenario: `_warm_drain_buckets` waits for the
    warm-up's frames (60 B) to leave ingress, not to be delivered, and
    nothing drains them before the injector children start; the settle
    loop's first drain then returns that residue, so the first window
    opens before any injector's frame (200 B) has arrived and can read
    0 frames/s for every tenant. The port drains the warm-up's frames
    before it starts the injectors: the drain that ends its settle holds
    injector frames only."""
    import subprocess

    mod = jsc if pkg == "jax" else tsc
    if pkg == "jax":
        assert ensure_jax_native() is None
    spawned, after = [], []
    real_popen, real_drain = subprocess.Popen, mod._drain_wires

    def popen(*a, **kw):
        spawned.append(True)
        return real_popen(*a, **kw)

    def drain(wires_out):
        sizes = {len(f) for w in wires_out for f in w.egress}
        n = real_drain(wires_out)
        if spawned and n and not after:
            after.append(sizes)
        return n

    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr(mod, "_drain_wires", drain)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    r = mod.tenant_soak(tenants=2, pairs_per_tenant=1, seconds=1.0,
                        settle_s=30.0, **kw)
    assert r["dropped"] == 0 and after
    if pkg == "jax":
        assert 60 in after[0]
    else:
        assert after[0] == {200}
