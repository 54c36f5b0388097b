"""Port parity: the six BASELINE rungs of kubedtn_tpu_torch.scenarios
against kubedtn_tpu.scenarios, on the CPU, at small sizes.

Each rung runs in both packages on the same inputs: `three_node` on a
sample YAML, `fat_tree_64` at k = 4, `churn_1k` on a 100-node mesh,
`clos_100k` with the Clos generator cut to 4 x 10 in both packages and
the port fed the JAX run's own draws (rebuilt from its key schedule, as
tests/test_torch_sim.py does), `reconcile_100k` on a 4 x 10 Clos (one
worker and eight), `scale_1m` on a 4 x 10 Clos. The port's result has
every JAX key (and "device"); ints, flags and counts are exact; the
packet counters are float sums of exact counts, exact too; timings and
rates are the host's and are not compared. Pings over links without
draws (no loss, no jitter) are exact; the ladder's order is the JAX
ladder's.
"""

import textwrap

import numpy as np
import pytest

from kubedtn_tpu import scenarios as jsc
from kubedtn_tpu_torch import scenarios as tsc

TIMED = {"wall_s", "setup_s", "reconcile_s", "churn_s", "teardown_s",
         "grpc_update_s", "updates_per_sec", "shape_pkts_per_sec",
         "packet_events_per_sec", "load_s", "device"}

NEW_RUNGS = ["3node", "fat_tree_64", "churn_1k", "clos_100k",
             "reconcile_100k", "scale_1m"]


def both(name, **kw):
    """The rung in both packages; the port's keys are the JAX rung's and
    "device", and chip_smoke.py's phase 21 checks the card's against
    the same JAX keys."""
    import chip_smoke

    j = jsc.LADDER[name](**kw)
    t = tsc.LADDER[name](device="cpu", **kw)
    assert set(t) == set(j) | {"device"}, (set(t) ^ set(j))
    assert chip_smoke.RUNG_KEYS[name] == set(j)
    assert t["device"] == "cpu" and t["scenario"] == j["scenario"]
    return j, t


def untimed(r: dict) -> dict:
    return {k: v for k, v in r.items() if k not in TIMED}


def test_new_rungs_in_the_ladder_in_jax_order():
    assert [k for k in tsc.LADDER if k in NEW_RUNGS] == NEW_RUNGS
    assert list(tsc.LADDER) == [k for k in jsc.LADDER if k in tsc.LADDER]
    assert len(tsc.NOT_PORTED) == 14
    assert not set(NEW_RUNGS) & set(tsc.NOT_PORTED)
    assert tsc.RING4_YAML.endswith("config/samples/ring4.yaml")
    assert tsc.three_node.__defaults__[0] == tsc.RING4_YAML


DET_YAML = textwrap.dedent("""\
    apiVersion: y-young.github.io/v1
    kind: Topology
    metadata: {name: r1}
    spec:
      links:
        - {uid: 1, local_intf: eth1, peer_intf: eth1, peer_pod: r2,
           properties: {latency: 10ms, rate: 1Gbit}}
        - {uid: 3, local_intf: eth2, peer_intf: eth1, peer_pod: r3,
           properties: {latency: 250us}}
    ---
    apiVersion: y-young.github.io/v1
    kind: Topology
    metadata: {name: r2}
    spec:
      links:
        - {uid: 1, local_intf: eth1, peer_intf: eth1, peer_pod: r1,
           properties: {latency: 10ms, rate: 1Gbit}}
        - {uid: 2, local_intf: eth2, peer_intf: eth2, peer_pod: r3,
           properties: {latency: 3ms, rate: 20Mbit}}
    ---
    apiVersion: y-young.github.io/v1
    kind: Topology
    metadata: {name: r3}
    spec:
      links:
        - {uid: 2, local_intf: eth2, peer_intf: eth2, peer_pod: r2,
           properties: {latency: 3ms, rate: 20Mbit}}
        - {uid: 3, local_intf: eth1, peer_intf: eth2, peer_pod: r1,
           properties: {latency: 250us}}
    """)


def test_three_node_equal_jax(tmp_path):
    path = tmp_path / "det3.yaml"
    path.write_text(DET_YAML)
    j, t = both("3node", yaml_path=str(path))
    assert untimed(t) == untimed(j)
    assert t["links"] == 3 and t["reachable"]
    assert t["pings"]["r1<->r2"] == 20_000.0


def test_three_node_on_ring4_equal_jax_on_its_draw_free_links():
    j = jsc.three_node(tsc.RING4_YAML)
    t = tsc.three_node(device="cpu")
    assert set(t) == set(j) | {"device"}
    assert t["links"] == j["links"] == 4
    assert list(t["pings"]) == list(j["pings"])
    for k in ("sat-a<->sat-b", "sat-b<->relay-c"):   # no loss, no jitter
        assert t["pings"][k] == j["pings"][k]
    assert t["pings"]["sat-a<->sat-b"] == 80_000.0


def test_fat_tree_64_equal_jax():
    j, t = both("fat_tree_64", k=4, steps=20)
    assert untimed(t) == untimed(j)
    assert t["nodes"] == 20 and t["links"] == 32
    assert t["tx_packets"] >= t["rx_packets"] > 0


def test_churn_1k_equal_jax():
    j, t = both("churn_1k", n_nodes=100, n_links=300, seconds=3.0)
    assert untimed(t) == untimed(j)
    assert t["churn_links_total"] == 90


@pytest.fixture()
def small_clos(monkeypatch):
    """Both packages' Clos generator cut to 4 x 10 (clos_100k takes no
    size) and the port's sim.run fed the JAX run's draws."""
    import torch

    from kubedtn_tpu_torch import convert
    from kubedtn_tpu_torch import sim as tsim
    from kubedtn_tpu_torch.models import topologies as tT

    from test_torch_sim import run_draws
    from test_torch_traffic import jax_spec

    for mod in (jsc.T, tT):
        orig = mod.clos

        def cut(n_spine, n_leaf, hosts=0, props=None, links_per_pair=1,
                _orig=orig):
            return _orig(4, 10, hosts, props=props,
                         links_per_pair=links_per_pair)

        monkeypatch.setattr(mod, "clos", cut)
    run = tsim.run

    def run_on_jax_draws(sim, spec, steps, dt_us, k_slots=8, seed=0):
        spec_j = jax_spec(convert.tree_to_numpy(spec))
        draws = run_draws(seed, steps, spec_j, dt_us, k_slots,
                          sim.edges.capacity)
        return run(sim, spec, steps, dt_us, k_slots, draws=draws)

    monkeypatch.setattr(tsim, "run", run_on_jax_draws)
    return torch


def test_clos_100k_equal_jax_on_its_draws(small_clos):
    j, t = both("clos_100k", steps=20)
    assert untimed(t) == untimed(j)
    assert t["links"] == 80 and t["directed_edges"] == 160
    assert t["tx_packets"] >= t["rx_packets"] > 0


@pytest.mark.parametrize("workers", [1, 8])
def test_reconcile_100k_equal_jax(workers):
    j, t = both("reconcile_100k", n_spine=4, n_leaf=10, links_per_pair=1,
                workers=workers, grpc_batch=10)
    assert untimed(t) == untimed(j)
    assert t["directed_rows"] == 80 and t["grpc_ok"]
    assert t["spot_check_latency_us"] == 20_000.0


def test_scale_1m_equal_jax():
    j, t = both("scale_1m", n_spine=4, n_leaf=10, update_iters=2,
                shape_iters=2)
    assert untimed(t) == untimed(j)
    assert (t["links"], t["directed_rows"], t["capacity"]) == (80, 160, 256)


def test_scale_1m_keeps_its_state_and_steps_it_on_keyed_draws():
    """keep= hands the final state out; the updates leave every active
    row with random_link_props' rows (seed 5), and the shaping steps
    draw from generators keyed by (9, i): the same key, the same bits."""
    import torch

    from kubedtn_tpu_torch.models import topologies as tT
    from kubedtn_tpu_torch.ops import edge_state as es

    keep = {}
    tsc.scale_1m(n_spine=4, n_leaf=10, update_iters=1, shape_iters=1,
                 device="cpu", keep=keep)
    st = keep["state"]
    want = tT.random_link_props(80, seed=5)
    np.testing.assert_array_equal(st.props[:80].numpy(), want)
    assert int(st.active.sum()) == 160
    assert int(st.pkt_count[:160].min()) >= 1
    g1 = tsc._keyed_generator(torch.device("cpu"), 9, 3)
    g2 = tsc._keyed_generator(torch.device("cpu"), 9, 3)
    g3 = tsc._keyed_generator(torch.device("cpu"), 9, 4)
    a, b, c = (torch.rand(8, generator=g) for g in (g1, g2, g3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert es.NPROP == want.shape[1]


def test_scenario_cli_prints_the_jax_keys(capsys, tmp_path):
    """`tpudtn-torch scenario 3node --device cpu` prints the rung's JSON
    with the JAX rung's keys."""
    import json

    from kubedtn_tpu_torch import cli as tcli

    rc = tcli.main(["scenario", "3node", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    got = json.loads(out)
    want = jsc.three_node(tsc.RING4_YAML)
    assert set(got) == set(want) | {"device"}
    assert got["links"] == 4


def test_chip_smoke_phase_21c_rehearsed_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 21(c) on the CPU, each rung at a small size
    (`sizes`) and the port's Clos generator cut to 4 x 10 for clos_100k:
    every rung's keys and checks, then the K1 wrapper against the plain
    step over scale_1m's state (on the CPU both are the plain step, so
    no launch is counted: the phase expects 0 there)."""
    import torch

    import chip_smoke
    from kubedtn_tpu_torch.models import topologies as tT

    orig = tT.clos

    def cut(n_spine, n_leaf, hosts=0, props=None, links_per_pair=1):
        return orig(4, 10, hosts, props=props,
                    links_per_pair=links_per_pair)

    monkeypatch.setattr(tT, "clos", cut)
    out, k1 = chip_smoke.run_ladder_phase(
        torch.device("cpu"), "cpu", sizes={
            "fat_tree_64": dict(k=4, steps=20),
            "churn_1k": dict(n_nodes=100, n_links=300, seconds=3.0),
            "clos_100k": dict(steps=20),
            "reconcile_100k": dict(n_spine=4, n_leaf=10, links_per_pair=1,
                                   grpc_batch=10),
            "scale_1m": dict(n_spine=4, n_leaf=10, update_iters=2,
                             shape_iters=2)})
    assert list(k1) == NEW_RUNGS and set(k1.values()) == {0}
    assert out["clos_100k"]["links"] == 80
    assert out["scale_1m"]["directed_rows"] == 160
    assert out["k1_2m"] == {"rows": 256, "steps": chip_smoke.RUNG_CHECK_STEPS,
                            "max_abs_err": 0.0}
