"""Port parity: kubedtn_tpu_torch.models.traffic against
kubedtn_tpu.models.traffic.

Both packages get the same draws: the JAX package's own, rebuilt from its
key schedule (traffic.py:85 splits the traffic key in three; :94 the
ON/OFF uniforms, :105-107 the Poisson counts, :120-121 the arrival
uniforms) and handed to the port as `TrafficDraws`.

WHICH JAX PROGRAM THE PORT EQUALS BIT FOR BIT. The port rounds once per
operation and divides `rate_bps` by 8e6 exactly. That is the program XLA
compiles when the traffic spec and dt are compile-time constants, as in
`sim.run` (its scan closes over them): `rate / 8e6` and `* dt` are folded
exactly, then one add. With spec and dt as traced arguments (`sim_step`,
`router.run_routed`, a bare `jit(generate)`), XLA instead computes
`rate * (dt * f32(1/8e6))`, the two scalars first, which moves
`traffic.credit` by an ulp or two. Measured here on the CPU (jax 0.9);
`test_generate_*_constants` holds the first bit for bit and
`test_generate_traced_arguments` the second at rtol 1e-6, packet counts,
masks and sizes exactly in both.

`jax_traffic_draws`, `jax_spec`, `torch_spec` and `mixed_spec_np` are
shared by the sim and router tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedtn_tpu.models import traffic as jtr
from kubedtn_tpu_torch.models import traffic as ttr


def jax_traffic_draws(kg, spec: jtr.TrafficSpec, dt_us: float, k: int):
    """The TrafficDraws (as torch tensors) that jtr.generate makes under
    the traffic key `kg`."""
    E = spec.mode.shape[0]
    k_onoff, k_poisson, k_arr = jax.random.split(kg, 3)
    lam = spec.rate_bps / 8e6 * jnp.float32(dt_us) / jnp.maximum(
        spec.pkt_bytes, 1.0)
    n_poi = jax.random.poisson(
        k_poisson, jnp.where(spec.mode == jtr.MODE_POISSON, lam, 0.0), (E,))
    return ttr.TrafficDraws(
        u_onoff=torch.as_tensor(np.array(
            jax.random.uniform(k_onoff, (E,)))),
        n_poisson=torch.as_tensor(np.array(n_poi.astype(jnp.float32))),
        u_arr=torch.as_tensor(np.array(
            jax.random.uniform(k_arr, (E, k)))))


def mixed_spec_np(capacity: int, seed: int, modes=(0, 1, 2, 3)) -> dict:
    """A TrafficSpec as numpy with every listed mode on some rows."""
    rng = np.random.default_rng(seed)
    return dict(
        mode=rng.choice(modes, capacity).astype(np.int32),
        rate_bps=rng.uniform(1e6, 6e7, capacity).astype(np.float32),
        pkt_bytes=rng.choice([200.0, 700.0, 1500.0], capacity)
        .astype(np.float32),
        on_us=rng.choice([0.0, 3000.0, 10000.0], capacity)
        .astype(np.float32),
        off_us=rng.choice([0.0, 2000.0, 8000.0], capacity)
        .astype(np.float32))


def jax_spec(d) -> jtr.TrafficSpec:
    return jtr.TrafficSpec(**{k: jnp.asarray(v) for k, v in d.items()})


def torch_spec(d) -> ttr.TrafficSpec:
    return ttr.TrafficSpec(**{k: torch.as_tensor(v) for k, v in d.items()})


def state_np(capacity: int, seed: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    return dict(credit=rng.uniform(0, 1400, capacity).astype(np.float32),
                on=rng.random(capacity) < 0.5)


def assert_onoff_draws_off_the_thresholds(draws, spec_np, dt_us):
    """jnp.exp and torch.exp may differ by an ulp, so a test of the
    ON/OFF gate wants no uniform within 1e-5 of a toggle probability
    (the JAX package draws them itself: pick a seed where this holds)."""
    u = draws.u_onoff.numpy()
    for sojourn in (spec_np["off_us"], spec_np["on_us"]):
        p = 1 - np.exp(-dt_us / np.maximum(sojourn, 1.0))
        assert (np.abs(u - p) >= 1e-5).all()


def run_both(spec_np, st_np, dt_us, k, seed, constants: bool):
    """(jax outputs, torch outputs) of one generate call on the same
    draws; `constants` closes the JAX program over spec and dt."""
    spec_j = jax_spec(spec_np)
    key = jax.random.key(seed)
    draws = jax_traffic_draws(key, spec_j, dt_us, k)
    ts_j = jtr.TrafficState(credit=jnp.asarray(st_np["credit"]),
                            on=jnp.asarray(st_np["on"]))
    if constants:
        dt = jnp.float32(dt_us)
        out_j = jax.jit(lambda ts, key: jtr.generate(spec_j, ts, dt, k,
                                                     key))(ts_j, key)
    else:
        out_j = jax.jit(jtr.generate, static_argnums=3)(
            spec_j, ts_j, jnp.float32(dt_us), k, key)
    ts_t = ttr.TrafficState(credit=torch.as_tensor(st_np["credit"]),
                            on=torch.as_tensor(st_np["on"]))
    out_t = ttr.generate(torch_spec(spec_np), ts_t, dt_us, k, draws=draws)
    return out_j, out_t


def assert_generate_equal(out_j, out_t, credit_exact: bool):
    (jts, jsz, jva, jta), (tts, tsz, tva, tta) = out_j, out_t
    np.testing.assert_array_equal(tva.numpy(), np.asarray(jva))
    np.testing.assert_array_equal(tsz.numpy(), np.asarray(jsz))
    np.testing.assert_array_equal(tts.on.numpy(), np.asarray(jts.on))
    np.testing.assert_array_equal(tta.numpy(), np.asarray(jta))
    if credit_exact:
        np.testing.assert_array_equal(tts.credit.numpy(),
                                      np.asarray(jts.credit))
    else:
        np.testing.assert_allclose(tts.credit.numpy(),
                                   np.asarray(jts.credit), rtol=1e-6,
                                   atol=1e-3)


MODE_CASES = {"cbr": (jtr.MODE_CBR,), "poisson": (jtr.MODE_POISSON,),
              "off": (jtr.MODE_OFF,), "mixed": (0, 1, 2, 3)}


@pytest.mark.parametrize("case", sorted(MODE_CASES))
@pytest.mark.parametrize("dt_us", [1000.0, 250.0])
def test_generate_modes_with_constants(case, dt_us):
    E, k = 1024, 8
    spec_np = mixed_spec_np(E, 3, MODE_CASES[case])
    spec_np["on_us"][:] = 0.0   # ON/OFF thresholds are tested below
    spec_np["off_us"][:] = 0.0
    out_j, out_t = run_both(spec_np, state_np(E, 3), dt_us, k, 5, True)
    assert_generate_equal(out_j, out_t, credit_exact=True)
    n = out_t[2].sum(dim=1)
    if case == "off":
        assert not n.any()
    else:
        assert n.any()
    if case in ("poisson", "mixed"):  # Poisson arrivals are sorted
        poi = torch.as_tensor(spec_np["mode"] == jtr.MODE_POISSON)
        t = out_t[3][poi]
        v = out_t[2][poi]
        assert ((t[:, 1:] >= t[:, :-1]) | ~v[:, 1:]).all()


def test_generate_onoff_with_constants():
    E, k, dt_us = 2048, 4, 1000.0
    spec_np = mixed_spec_np(E, 4, (jtr.MODE_ONOFF, jtr.MODE_CBR))
    spec_j = jax_spec(spec_np)
    key = jax.random.key(11)
    draws = jax_traffic_draws(key, spec_j, dt_us, k)
    assert_onoff_draws_off_the_thresholds(draws, spec_np, dt_us)
    st = state_np(E, 4)
    out_j, out_t = run_both(spec_np, st, dt_us, k, 11, True)
    assert_generate_equal(out_j, out_t, credit_exact=True)
    on = out_t[0].on.numpy()
    is_onoff = spec_np["mode"] == jtr.MODE_ONOFF
    assert (on[is_onoff] != st["on"][is_onoff]).any()      # some toggled
    np.testing.assert_array_equal(on[~is_onoff], st["on"][~is_onoff])
    # off_us == 0 turns on at once, on_us == 0 never turns off
    assert on[is_onoff & ~st["on"] & (spec_np["off_us"] == 0)].all()
    assert on[is_onoff & st["on"] & (spec_np["on_us"] == 0)].all()


@pytest.mark.parametrize("k", [1, 2])
def test_generate_clips_the_count_at_k(k):
    E, dt_us = 512, 1000.0
    spec_np = mixed_spec_np(E, 6, (jtr.MODE_CBR, jtr.MODE_POISSON))
    spec_np["rate_bps"][:] = 9e7      # ~8-56 packets offered per step
    out_j, out_t = run_both(spec_np, state_np(E, 6), dt_us, k, 2, True)
    assert_generate_equal(out_j, out_t, credit_exact=True)
    assert (out_t[2].sum(dim=1) == k).all()
    # a clipped CBR row keeps the credit it did not emit
    cbr = spec_np["mode"] == jtr.MODE_CBR
    assert (out_t[0].credit.numpy()[cbr] > 1500.0).all()


def test_generate_traced_arguments():
    E, k, dt_us = 2048, 8, 1000.0
    spec_np = mixed_spec_np(E, 8)
    out_j, out_t = run_both(spec_np, state_np(E, 8), dt_us, k, 13, False)
    assert_generate_equal(out_j, out_t, credit_exact=False)
    # the two programs do differ in credit's last bits
    assert not np.array_equal(out_t[0].credit.numpy(),
                              np.asarray(out_j[0].credit))


def test_cbr_everywhere_and_init_match_jax():
    j = jtr.cbr_everywhere(64, 40, 12e6, 1500.0)
    t = ttr.cbr_everywhere(64, 40, 12e6, 1500.0, device="cpu")
    for f in dataclasses.fields(ttr.TrafficSpec):
        got, want = getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name))
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    ts = ttr.init_traffic_state(64, "cpu")
    assert ts.on.all() and not ts.credit.any()


def test_generate_draws_from_generator():
    E, k = 256, 4
    spec = torch_spec(mixed_spec_np(E, 9))
    ts = ttr.init_traffic_state(E, "cpu")
    a = ttr.generate(spec, ts, 1000.0, k, torch.Generator().manual_seed(3))
    d = ttr.draw(spec, 1000.0, k, torch.Generator().manual_seed(3))
    b = ttr.generate(spec, ts, 1000.0, k, draws=d)
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    poi = spec.mode == ttr.MODE_POISSON
    assert d.n_poisson[poi].sum() > 0 and not d.n_poisson[~poi].any()
    with pytest.raises(ValueError, match="generator or the draws"):
        ttr.generate(spec, ts, 1000.0, k)
