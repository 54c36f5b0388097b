"""The port's first slice end to end against the JAX package, on the CPU:
a Clos topology is loaded, churned by batched UpdateLinks, then shaped by
three drop-in steps and one fused S=3 call, both packages fed the same
numpy uniforms. Also the state hand-over (convert.py) and the entry
points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from kubedtn_tpu.models import topologies as jtopo
from kubedtn_tpu.ops import edge_state as jes
from kubedtn_tpu.ops import netem as jnetem
from kubedtn_tpu.ops.pallas import shaping as jshaping
from kubedtn_tpu_torch import convert, entry
from kubedtn_tpu_torch.models import topologies as ttopo
from kubedtn_tpu_torch.ops import edge_state as tes
from kubedtn_tpu_torch.ops.cuda import shaping as tshaping
from test_torch_netem import (DEPART_TOL, assert_results_close,
                              assert_states_close, jax_to_numpy,
                              random_state_np)
from test_torch_shaping import (assert_tiled_close, jax_u_tiles,
                                torch_u_cols, untile)

NU = jnetem.NU


def test_clos_slice_end_to_end():
    jel = jtopo.clos(4, 8, links_per_pair=2)
    tel = ttopo.clos(4, 8, links_per_pair=2)
    assert tel.node_names == jel.node_names
    for f in ("a", "b", "uid", "props"):
        np.testing.assert_array_equal(getattr(tel, f), getattr(jel, f))

    # 1. the topology into the structure of arrays
    js, jrows = jtopo.load_edge_list_into_state(jel)
    ts, trows = ttopo.load_edge_list_into_state(tel, device="cpu")
    np.testing.assert_array_equal(trows, jrows)
    assert ts.capacity == js.capacity == 256
    assert_states_close(js, ts, exact=True)

    # 2. batched UpdateLinks, as bench.py churns: one end's rows as a
    #    contiguous window, the other end's sorted-but-scattered
    L = jel.n_links
    valid = np.ones(L, bool)
    props1 = ttopo.random_link_props(L, 1)
    np.testing.assert_array_equal(props1, jtopo.random_link_props(L, 1))
    rows_c = np.arange(L, dtype=np.int32)
    perm = np.random.default_rng(3).permutation(2 * L)[:L]
    rows_s = np.sort((perm + L) % (2 * L)).astype(np.int32)
    for rows, props, contiguous in ((rows_c, props1, True),
                                    (rows_s, ttopo.random_link_props(L, 2),
                                     False)):
        js = jes.update_links(js, jnp.asarray(rows), jnp.asarray(props),
                              jnp.asarray(valid), contiguous)
        ts = tes.update_links(ts, rows, props, valid, contiguous)
        assert_states_close(js, ts, exact=True)

    # 3. three drop-in steps with numpy uniforms
    E = ts.capacity
    rng = np.random.default_rng(7)
    sizes = rng.choice([64, 1500], E).astype(np.float32)
    have = rng.random(E) < 0.9
    t_arr = rng.uniform(0, 100, E).astype(np.float32)
    jstep = jax.jit(jnetem._shape_step_from_u)
    delivered = 0
    for _ in range(3):
        u = rng.random((E, NU)).astype(np.float32)
        js, jr = jstep(js, jnp.asarray(sizes), jnp.asarray(have),
                       jnp.asarray(t_arr), jnp.asarray(u))
        ts, tr = tshaping.shape_step(
            ts, torch.as_tensor(sizes), torch.as_tensor(have),
            torch.as_tensor(t_arr), torch.as_tensor(u), donate=True)
        assert_results_close(jr, tr)
        assert_states_close(js, ts)
        delivered += int(tr.delivered.sum())
    assert delivered > 0

    # 4. one fused S=3 call on the tiled state
    S = 3
    us = rng.random((S, E, NU)).astype(np.float32)
    act = np.asarray(js.active).astype(np.int32)
    jts = jshaping.tile_state(js)
    jts, jdep, jfl = jshaping.shape_steps_tiled(
        jts, *(jshaping.tile_vec(jnp.asarray(x), jts)
               for x in (sizes, act, t_arr)),
        0, S, jax_u_tiles(us, jts), interpret=True)
    tts = tshaping.tile_state(ts)
    tts, tdep, tfl = tshaping.shape_steps_tiled(
        tts, *(tshaping.tile_vec(torch.as_tensor(x), tts)
               for x in (sizes, act, t_arr)),
        0, S, torch_u_cols(us))
    np.testing.assert_array_equal(tfl.numpy(), untile(jfl, E))
    np.testing.assert_allclose(tdep.numpy(), untile(jdep, E), **DEPART_TOL)
    assert_tiled_close(jts, tts)
    assert_states_close(jshaping.untile_state(jts, js),
                        tshaping.untile_state(tts, ts))


def test_convert_round_trip():
    d = random_state_np(512, seed=2)
    s = convert.edge_state_from_numpy(d, device="cpu")
    back = convert.edge_state_to_numpy(s)
    assert set(back) == set(d)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == np.asarray(v).dtype, k
    # from a JAX state, as the tests hand one over
    el = jtopo.fat_tree(4)
    js, _ = jtopo.load_edge_list_into_state(el, capacity=64)
    ts = convert.edge_state_from_numpy(jax_to_numpy(js), device="cpu")
    assert_states_close(js, ts, exact=True)
    back["tokens"][:] = -1.0  # the numpy side is a copy
    assert (s.tokens >= 0).all()


def test_entry_runs_the_drop_in_step_on_cpu():
    fn, args = entry.entry(device="cpu")
    state, sizes, have, t_arr, gen = args
    assert state.capacity == 1024 and int(state.num_active) == 512
    before = state.tokens.clone()
    new_state, res = fn(*args)
    n = int(res.delivered.sum())
    assert 0 < n <= 512
    assert torch.isfinite(res.depart_us[res.delivered]).all()
    assert not res.delivered[512:].any()
    # not donated: the input state is untouched
    assert torch.equal(state.tokens, before)
    assert not torch.equal(new_state.tokens, before)


def test_entry_points_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry.entry, entry.build_clos_100k):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_clos_100k_shape_matches_bench():
    """build_clos_100k builds bench.py's BASELINE Clos (checked on the
    generator's arithmetic; the full build runs on the card)."""
    assert (entry.N_SPINE, entry.N_LEAF, entry.LINKS_PER_PAIR) == \
        (bench.N_SPINE, bench.N_LEAF, bench.LINKS_PER_PAIR)
    el = ttopo.clos(10, 50, links_per_pair=2)
    assert el.n_links == 10 * 50 * 2
    s, rows = ttopo.load_edge_list_into_state(el, device="cpu")
    assert s.capacity == 2048 and len(rows) == 2000
