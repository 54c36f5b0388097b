"""Port parity: kubedtn_tpu_torch.ops.cuda.shaping (plain versions on the
CPU) against the Pallas kernels of kubedtn_tpu.ops.pallas.shaping in
interpret mode, plus the Philox generator K3 draws from and the ctypes
binding of the CUDA source.

The CUDA kernels themselves only run on the card (tests/test_torch_cuda.py
and chip_smoke.py); here the wrappers take their plain versions because
the tensors lie on the CPU."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedtn_tpu.ops import netem as jnetem
from kubedtn_tpu.ops.pallas import shaping as jshaping
from kubedtn_tpu_torch import _build, convert
from kubedtn_tpu_torch.ops import edge_state as tes
from kubedtn_tpu_torch.ops import netem as tnetem
from kubedtn_tpu_torch.ops.cuda import philox
from kubedtn_tpu_torch.ops.cuda import shaping as tshaping
from test_torch_netem import (DEPART_TOL, STATE_TOL, assert_states_close,
                              jax_state, random_state_np, step_inputs,
                              torch_state)

NU = jnetem.NU


def jax_tiled(d, sizes, act, t_arr):
    """JAX TiledShapeState + tiled vectors of numpy state `d`."""
    ts = jshaping.tile_state(jax_state(d))
    return (ts, jshaping.tile_vec(jnp.asarray(sizes), ts),
            jshaping.tile_vec(jnp.asarray(act.astype(np.int32)), ts),
            jshaping.tile_vec(jnp.asarray(t_arr), ts))


def torch_tiled(d, sizes, act, t_arr):
    ts = tshaping.tile_state(torch_state(d))
    return (ts, tshaping.tile_vec(torch.as_tensor(sizes), ts),
            tshaping.tile_vec(torch.as_tensor(act.astype(np.int32)), ts),
            tshaping.tile_vec(torch.as_tensor(t_arr), ts))


def jax_u_tiles(us, ts):
    """[S, E, NU] numpy uniforms -> JAX [S*NU, R, 128] slab."""
    e_pad = ts.tokens.shape[0] * jshaping.LANE
    return jnp.concatenate([jshaping._tiles(jnp.asarray(u), e_pad)
                            for u in us], axis=0)


def torch_u_cols(us):
    """[S, E, NU] numpy uniforms -> [S*NU, E] (row s*NU+k = lane k of
    step s)."""
    return torch.as_tensor(np.concatenate([u.T for u in us], axis=0))


def untile(x, E):
    x = np.asarray(x)
    return x.reshape(x.shape[0], -1)[:, :E]


def assert_tiled_close(jts, tts):
    E = tts.capacity
    for name in ("props", "corr"):
        np.testing.assert_allclose(getattr(tts, name).numpy(),
                                   untile(getattr(jts, name), E),
                                   err_msg=name, **STATE_TOL)
    for name in ("tokens", "t_last", "backlog", "count"):
        np.testing.assert_allclose(getattr(tts, name).numpy(),
                                   np.asarray(getattr(jts, name))
                                   .reshape(-1)[:E],
                                   err_msg=name, **STATE_TOL)


@pytest.mark.parametrize("capacity", [1024, 3000])
def test_tile_state_layout_is_jax_tiles_reshaped(capacity):
    d = random_state_np(capacity, seed=1)
    jts = jshaping.tile_state(jax_state(d))
    tts = tshaping.tile_state(torch_state(d))
    assert tts.capacity == capacity
    for name in ("props", "corr"):
        np.testing.assert_array_equal(getattr(tts, name).numpy(),
                                      untile(getattr(jts, name), capacity))
    back = tshaping.untile_state(tts, torch_state(d))
    assert_states_close(jax_state(d), back, exact=True)
    d_np = {f: np.asarray(getattr(jts, f)) for f in
            ("props", "corr", "tokens", "t_last", "backlog", "count")}
    d_np["capacity"] = jts.capacity
    conv = convert.tiled_state_from_numpy(d_np, device="cpu")
    for name in d_np:
        if name != "capacity":
            assert torch.equal(getattr(conv, name), getattr(tts, name))
    with pytest.raises(ValueError, match="expected shape"):
        tshaping.tile_vec(torch.zeros(capacity + 1), tts)


@pytest.mark.parametrize("capacity,seed", [(1024, 0), (2000, 1)])
def test_plain_k1_matches_pallas_tiled_step(capacity, seed):
    """Plain K1 (the drop-in wrapper on CPU tensors) against
    shape_step_tiled with the same external uniforms, interpret mode."""
    d = random_state_np(capacity, seed)
    sizes, have, t_arr, u = step_inputs(capacity, seed)
    act = have & d["active"]
    jts, jsz, jact, jta = jax_tiled(d, sizes, act, t_arr)
    jts2, jdep, jfl = jshaping.shape_step_tiled(
        jts, jsz, jact, jta, 0, jax_u_tiles([u], jts), interpret=True)

    ts2, res = tshaping.shape_step(
        torch_state(d), torch.as_tensor(sizes), torch.as_tensor(have),
        torch.as_tensor(t_arr), torch.as_tensor(u), donate=True)
    np.testing.assert_array_equal(
        tshaping.pack_flags(res).numpy(),
        np.asarray(jfl).reshape(-1)[:capacity])
    np.testing.assert_allclose(res.depart_us.numpy(),
                               np.asarray(jdep).reshape(-1)[:capacity],
                               **DEPART_TOL)
    assert_tiled_close(jts2, tshaping.tile_state(ts2))


@pytest.mark.parametrize("S", [1, 3])
def test_plain_k2_matches_pallas_fused_steps(S):
    capacity = 2048
    d = random_state_np(capacity, seed=10 + S)
    rng = np.random.default_rng(S)
    sizes = rng.uniform(64, 1500, capacity).astype(np.float32)
    t_arr = np.zeros(capacity, np.float32)
    us = rng.random((S, capacity, NU)).astype(np.float32)
    jts, jsz, jact, jta = jax_tiled(d, sizes, d["active"], t_arr)
    jts2, jdep, jfl = jshaping.shape_steps_tiled(
        jts, jsz, jact, jta, 0, S, jax_u_tiles(us, jts), interpret=True)

    tts, tsz, tact, tta = torch_tiled(d, sizes, d["active"], t_arr)
    tts2, tdep, tfl = tshaping.shape_steps_tiled(
        tts, tsz, tact, tta, 0, S, torch_u_cols(us))
    assert tdep.shape == tfl.shape == (S, capacity)
    np.testing.assert_array_equal(tfl.numpy(), untile(jfl, capacity))
    np.testing.assert_allclose(tdep.numpy(), untile(jdep, capacity),
                               **DEPART_TOL)
    assert_tiled_close(jts2, tts2)
    assert (tfl.numpy() & tshaping.FLAG_DELIVERED).any()


def test_plain_k2_equals_sequential_plain_k1():
    """S fused plain steps == S drop-in plain steps given the same
    uniforms (torch against torch: bit for bit)."""
    S, capacity = 3, 1024
    d = random_state_np(capacity, seed=21)
    sizes, _, t_arr, _ = step_inputs(capacity, 21)
    us = np.random.default_rng(21).random((S, capacity, NU)).astype(
        np.float32)
    active = torch.as_tensor(d["active"])
    state = torch_state(d)
    deps, fls = [], []
    for s in range(S):
        state, res = tshaping.shape_step(
            state, torch.as_tensor(sizes), active, torch.as_tensor(t_arr),
            torch.as_tensor(us[s]), donate=False)
        deps.append(res.depart_us)
        fls.append(tshaping.pack_flags(res))
    tts, tsz, tact, tta = torch_tiled(d, sizes, d["active"], t_arr)
    tts, dep, fl = tshaping.shape_steps_tiled(tts, tsz, tact, tta, 0, S,
                                              torch_u_cols(us))
    assert torch.equal(fl, torch.stack(fls))
    assert torch.equal(dep, torch.stack(deps))
    back = tshaping.untile_state(tts, torch_state(d))
    for name in ("tokens", "t_last", "backlog_until", "corr", "pkt_count"):
        assert torch.equal(getattr(back, name), getattr(state, name)), name


def test_plain_k3_is_k2_on_philox_draws():
    """Without u_t the CPU path runs K3's plain version: K2's plain
    version fed philox.uniforms, the bits K3 draws in the kernel."""
    capacity, S, seed = 1024, 4, 1234
    d = random_state_np(capacity, seed=31)
    sizes, _, t_arr, _ = map(torch.as_tensor, step_inputs(capacity, 31))
    act = torch.as_tensor(d["active"].astype(np.int32))

    def run(*extra):
        return tshaping.shape_steps_tiled(
            tshaping.tile_state(torch_state(d)), sizes, act, t_arr, seed,
            S, *extra)

    k3 = run()
    k2 = run(philox.uniforms(seed, capacity, S, "cpu"))
    assert torch.equal(k3[1], k2[1]) and torch.equal(k3[2], k2[2])
    step1 = tshaping.shape_step_tiled(tshaping.tile_state(torch_state(d)),
                                      sizes, act, t_arr, seed)
    assert torch.equal(step1[2], k3[2][0])


def test_flag_counts_match_jax():
    rng = np.random.default_rng(4)
    flags = rng.integers(0, 64, (3, 8, 128)).astype(np.int32)
    want = jshaping.flag_counts(jnp.asarray(flags))
    got = tshaping.flag_counts(torch.as_tensor(flags))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.int32
        assert int(got[k]) == int(want[k]), k


def test_pack_unpack_flags_roundtrip():
    d = random_state_np(1024, seed=3)
    _, res = tnetem._shape_step_from_u(
        torch_state(d), *map(torch.as_tensor, step_inputs(1024, 3)))
    back = tshaping.unpack_flags(res.depart_us, tshaping.pack_flags(res))
    for k in ("depart_us", "delivered", "dropped_loss", "dropped_queue",
              "corrupted", "duplicated", "reordered"):
        assert torch.equal(getattr(back, k), getattr(res, k)), k


# -- Philox4x32-10 ---------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    # Random123's known-answer vectors (kat_vectors, philox4x32 10 rounds)
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    got = philox.philox4x32([torch.tensor(c) for c in ctr], key)
    assert tuple(int(w) for w in got) == want


def test_philox_uniforms_grid_range_and_streams():
    u = philox.uniforms(7, 4096, 3, "cpu")
    assert u.shape == (3 * NU, 4096) and u.dtype == torch.float32
    assert (u >= 0).all() and (u < 1).all()  # no negative draws
    scaled = u.double() * 2 ** 24  # on the 2^-24 grid
    assert torch.equal(scaled, scaled.round())
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert len(torch.unique(u)) > 0.99 * u.numel()
    # the seed is taken mod 2^32, as the kernel's uint32 key
    assert torch.equal(philox.uniforms(7 - 2 ** 32, 64, 2, "cpu"),
                       philox.uniforms(7, 64, 2, "cpu"))
    assert not torch.equal(philox.uniforms(8, 64, 2, "cpu"),
                           philox.uniforms(7, 64, 2, "cpu"))


def test_bits_to_uniform_top_bit_words():
    """Words with the top bit set (negative as int32) stay in [0, 1):
    the shift is logical."""
    bits = torch.tensor([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])
    u = philox.bits_to_uniform(bits)
    assert u.tolist() == [0.0, 0.5 - 2 ** -24, 0.5, 1 - 2 ** -24]


# -- device rules and the binding ------------------------------------------

def test_device_none_without_cuda_raises(monkeypatch):
    """device=None means the card; without one nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        philox.uniforms(1, 8, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tes.init_state(8)
    d = {f: np.zeros(8) for f in ("props", "corr", "tokens", "t_last",
                                   "backlog", "count")}
    d["capacity"] = 8
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tiled_state_from_numpy(d)


def test_wrappers_raise_off_cpu_without_kernel():
    """A tensor that is not on the CPU never takes the plain version."""
    d = random_state_np(64, seed=0)
    meta = tes.EdgeState(**{k: v.to("meta") for k, v in
                            vars(torch_state(d)).items()})
    z = torch.zeros(64, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tshaping.shape_step(meta, z, z.bool(), z,
                            torch.zeros(64, NU, device="meta"),
                            donate=True)
    tts = tshaping.TiledShapeState(**{
        k: v.to("meta") for k, v in
        vars(tshaping.tile_state(torch_state(d))).items()})
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tshaping.shape_steps_tiled(tts, z, z.int(), z, 1, 2)


def test_ctypes_signatures_match_cuda_source():
    """Every exported C function's parameter count and integer/seed
    slots agree with _build.SIGNATURES (the source is compiled only on
    the card, so the binding is checked against the text here)."""
    src = (_build.CSRC / "shaping.cu").read_text()
    found = dict(re.findall(r'extern "C" int (kdt_\w+)\(([^)]*)\)', src))
    sigs = _build.SIGNATURES["shaping"]
    assert set(found) == set(sigs)
    for name, params in found.items():
        params = [p.strip() for p in params.split(",")]
        want = sigs[name]
        assert len(params) == len(want), name
        for p, t in zip(params, want):
            if p.startswith("int ") or p == "int":
                assert t is _build._I, (name, p)
            elif p.startswith("uint32_t "):
                assert t is _build.ctypes.c_uint32, (name, p)
            else:
                assert "*" in p and t is _build._P, (name, p)


def test_build_flags_and_missing_nvcc(monkeypatch, tmp_path):
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in flags and "fast_math" not in flags
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    default = _build.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        assert _build.nvcc() == str(default)
    else:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc()
