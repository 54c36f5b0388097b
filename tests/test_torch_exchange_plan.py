"""The launch plan of kernel K4's ring step (kubedtn_tpu_torch/parallel/
exchange.py `ring_plan`), on the CPU: a pure function of the mesh, so
`torch.device("cuda", i)` objects stand in for cards that need not exist.

Each launch copies every shard of one card; the cards its destinations
lie on besides its own are the pairs that are ordered (a stream wait
before, an event after)."""

import pytest
import torch

from kubedtn_tpu_torch.parallel import exchange as pex
from kubedtn_tpu_torch.parallel.mesh import make_mesh


def cuda(i):
    return torch.device("cuda", i)


def summary(mesh):
    return [(launch.device.index, launch.shards,
             tuple(p.index for p in launch.peers))
            for launch in pex.ring_plan(mesh)]


@pytest.mark.parametrize("mesh,want", [
    # 4 virtual shards on one card: one launch, nothing to order
    ([cuda(0)] * 4, [(0, (0, 1, 2, 3), ())]),
    # 2 cards x 2 shards: shard 1 writes into card 1, shard 3 into card 0
    ([cuda(0), cuda(0), cuda(1), cuda(1)],
     [(0, (0, 1), (1,)), (1, (2, 3), (0,))]),
    # the same cards interleaved: every shard writes into the other card
    ([cuda(0), cuda(1), cuda(0), cuda(1)],
     [(0, (0, 2), (1,)), (1, (1, 3), (0,))]),
    # 4 cards x 1 shard: a launch per card, each ordered with its right
    # neighbour
    ([cuda(0), cuda(1), cuda(2), cuda(3)],
     [(0, (0,), (1,)), (1, (1,), (2,)), (2, (2,), (3,)), (3, (3,), (0,))]),
    # S = 1: the shard copies into its own card
    ([cuda(0)], [(0, (0,), ())]),
    # 3 cards, uneven: card 0's two shards write into cards 0 and 2
    ([cuda(0), cuda(1), cuda(2), cuda(0)],
     [(0, (0, 3), (1,)), (1, (1,), (2,)), (2, (2,), (0,))]),
])
def test_ring_plan_groups_shards_by_card(mesh, want):
    assert summary(mesh) == want


def test_ring_plan_covers_every_shard_once():
    mesh = [cuda(i % 3) for i in range(7)]
    plan = pex.ring_plan(mesh)
    shards = sorted(s for launch in plan for s in launch.shards)
    assert shards == list(range(7))
    for launch in plan:
        assert all(mesh[s] == launch.device for s in launch.shards)
        want = {mesh[(s + 1) % 7] for s in launch.shards} - {launch.device}
        assert set(launch.peers) == want
        assert len(launch.peers) == len(set(launch.peers))


def test_ring_plan_splits_a_card_beyond_the_kernels_table():
    """A card with more shards than one launch's table takes (PLAN_MAX,
    the kernel's MAX_PLAN) makes several launches per step."""
    n = pex.PLAN_MAX + 5
    plan = pex.ring_plan([cuda(0)] * n)
    assert [len(launch.shards) for launch in plan] == [pex.PLAN_MAX, 5]
    assert all(launch.peers == () for launch in plan)


def test_ring_plan_of_cpu_shards_is_one_launch():
    """Virtual CPU shards plan like virtual shards of one card (the CPU
    path itself runs the plain rotation and launches nothing)."""
    assert summary(make_mesh(["cpu"] * 3)) == [(None, (0, 1, 2), ())]
