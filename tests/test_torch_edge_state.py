"""Port parity: kubedtn_tpu_torch.ops.edge_state against
kubedtn_tpu.ops.edge_state — the batched link operations must leave both
packages' states identical, bit for bit, including batches padded with
invalid lanes (which JAX drops out of bounds and the port masks out)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedtn_tpu.api.types import LinkProperties as JLinkProperties
from kubedtn_tpu.models.topologies import random_link_props
from kubedtn_tpu.ops import edge_state as jes
from kubedtn_tpu_torch import convert
from kubedtn_tpu_torch.api.types import LinkProperties
from kubedtn_tpu_torch.ops import edge_state as tes
from test_torch_netem import (assert_states_close, jax_state,
                              random_state_np, torch_state)

E = 1024


def padded_batch(rows, n_pad, seed):
    """(rows, valid) with `n_pad` invalid lanes mixed in, whose row
    values are garbage (in and out of bounds)."""
    rng = np.random.default_rng(seed)
    B = len(rows) + n_pad
    valid = np.ones(B, bool)
    valid[rng.choice(B, n_pad, replace=False)] = False
    out = np.empty(B, np.int32)
    out[valid] = rows
    out[~valid] = rng.choice([-1, 0, 5, E, E + 7], n_pad)
    return out, valid


def both(jfn, tfn, d, *args, **kw):
    """Run one op on a JAX and a torch copy of state `d`."""
    j = jfn(jax_state(d), *(jnp.asarray(a) for a in args), **kw)
    t = tfn(torch_state(d), *args, **kw)
    return j, t


def test_init_state_matches_jax():
    assert_states_close(jes.init_state(64),
                        tes.init_state(64, device="cpu"), exact=True)


def test_props_row_and_burst():
    lp = LinkProperties(latency="10ms", jitter="1ms", loss="0.5",
                        rate="1Gbit", gap=3)
    jl = JLinkProperties(latency="10ms", jitter="1ms", loss="0.5",
                         rate="1Gbit", gap=3)
    np.testing.assert_array_equal(tes.props_row(lp.to_numeric()),
                                  jes.props_row(jl.to_numeric()))
    row, shaped = tes.props_row_and_shaped(lp)
    assert shaped and not row.flags.writeable
    rates = np.asarray([0, 1e3, 20e6, 1e9, 10e9, 123456789], np.float32)
    # as the compiled JAX functions compute it: XLA turns the division
    # by 250 into a multiplication by its float32 reciprocal
    np.testing.assert_array_equal(
        tes.burst_bytes(torch.as_tensor(rates)).numpy(),
        np.asarray(jax.jit(jes.burst_bytes)(jnp.asarray(rates))))


def test_apply_links_padded_matches_jax():
    d = random_state_np(E, seed=1)
    rng = np.random.default_rng(1)
    rows, valid = padded_batch(rng.choice(E, 200, replace=False), 56, 1)
    B = len(rows)
    args = (rows, rng.integers(0, 1 << 20, B).astype(np.int32),
            rng.integers(0, 64, B).astype(np.int32),
            rng.integers(0, 64, B).astype(np.int32),
            random_link_props(B, 1), valid)
    j, t = both(jes.apply_links, tes.apply_links, d, *args)
    assert_states_close(j, t, exact=True)


def test_delete_links_padded_matches_jax():
    d = random_state_np(E, seed=2)
    rng = np.random.default_rng(2)
    rows, valid = padded_batch(rng.choice(E, 100, replace=False), 28, 2)
    j, t = both(jes.delete_links, tes.delete_links, d, rows, valid)
    assert_states_close(j, t, exact=True)


@pytest.mark.parametrize("form", ["contiguous", "scatter", "dense"])
def test_update_links_padded_matches_jax(form):
    """All three update_links formulations, each with padded lanes."""
    d = random_state_np(E, seed=3)
    rng = np.random.default_rng(3)
    if form == "contiguous":
        start, B = 100, 512
        rows = (start + np.arange(B)).astype(np.int32)
        valid = rng.random(B) < 0.8
        valid[0] = True
        rows[~valid] = -1  # padding lanes may hold anything
        assert tes.contiguous_window(rows, valid, E)
    else:
        n = 100 if form == "scatter" else 700
        rows, valid = padded_batch(rng.choice(E, n, replace=False), 28, 3)
        B = len(rows)
        assert (B * 4 < E) == (form == "scatter")
    props = random_link_props(len(rows), 3)
    contiguous = form == "contiguous"
    j = jes.update_links(jax_state(d), jnp.asarray(rows),
                         jnp.asarray(props), jnp.asarray(valid), contiguous)
    t = tes.update_links(torch_state(d), rows, props, valid, contiguous)
    assert_states_close(j, t, exact=True)
    touched = t.pkt_count.numpy()[rows[valid]]
    assert (touched == 0).all()


def test_update_links_is_in_place_and_empty_is_noop():
    d = random_state_np(E, seed=4)
    t = torch_state(d)
    assert tes.update_links(t, np.zeros(0, np.int32),
                            np.zeros((0, tes.NPROP), np.float32),
                            np.zeros(0, bool)) is t
    before = t.props
    out = tes.update_links(t, np.arange(8, dtype=np.int32),
                           random_link_props(8, 4), np.ones(8, bool))
    assert out.props is before  # updated in place
    with pytest.raises(ValueError, match="outside capacity"):
        tes.update_links(t, np.arange(E - 4, E + 4, dtype=np.int32),
                         random_link_props(8, 4), np.ones(8, bool),
                         contiguous=True)


@pytest.mark.parametrize("rows,valid,want", [
    ([5, 6, 7, 8], [1, 1, 1, 1], True),
    ([5, 6, 0, 8], [1, 1, 0, 1], True),
    ([5, 7, 8, 9], [1, 1, 1, 1], False),
    ([0, 1, 2, 3], [0, 1, 1, 1], False),
    ([E - 2, E - 1, 0, 0], [1, 1, 0, 0], False),
])
def test_contiguous_window_matches_jax(rows, valid, want):
    rows = np.asarray(rows, np.int32)
    valid = np.asarray(valid, bool)
    assert tes.contiguous_window(rows, valid, E) is want
    assert jes.contiguous_window(rows, valid, E) is want


def test_compact_state_matches_jax():
    d = random_state_np(E, seed=5)
    rng = np.random.default_rng(5)
    perm = rng.permutation(E).astype(np.int32)
    perm[700:] = rng.integers(-E, 2 * E, E - 700)  # "may be anything"
    j, t = both(jes.compact_state, tes.compact_state, d, perm,
                np.int32(600))
    assert_states_close(j, t, exact=True)


def test_grow_state_matches_jax():
    d = random_state_np(E, seed=6)
    j = jes.grow_state(jax_state(d), 4096)
    t = tes.grow_state(torch_state(d), 4096)
    assert t.capacity == 4096
    assert_states_close(j, t, exact=True)
    same = torch_state(d)
    assert tes.grow_state(same, E) is same


def test_init_state_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tes.init_state(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.edge_state_from_numpy(random_state_np(8, 0))
