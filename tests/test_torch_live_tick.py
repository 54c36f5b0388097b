"""Port parity of the live tick's device program: the three row cores, the
telemetry fold, group packing and the fused tick, against the JAX
package on the CPU, plus the port's own fused ≡ per-class ladder
contract.

Both packages get the same numpy state and the same uniforms: the test
draws JAX's keyed uniforms with `netem._uniform_rows(fold_in(sub, c),
key_ids, R, K)` and hands them to the port as `u`. Tolerances are those
of the port's first slice (tests/test_torch_netem.py): integers and
flags exact; state rtol 1e-6 / atol 1e-3; departures (and the latency
sums built from them) rtol 1e-5 / atol 1e-2 — the reference's own
Pallas parity tolerances, which cover XLA's fused multiply-adds on the
JAX side. The associative scan and the port's internal contracts are
held bit for bit.

The helpers at the top are shared with tests/test_torch_sharded.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubedtn_tpu import runtime as jrt
from kubedtn_tpu import telemetry as jtele
from kubedtn_tpu.ops import edge_state as jes
from kubedtn_tpu.ops import netem as jnetem
from kubedtn_tpu_torch import convert, entry
from kubedtn_tpu_torch import runtime as trt
from kubedtn_tpu_torch import telemetry as ttele
from kubedtn_tpu_torch.ops import netem as tnetem
from kubedtn_tpu_torch.ops.scan import associative_scan
from test_torch_netem import (DEPART_TOL, STATE_TOL, jax_state,
                              random_state_np, torch_state)

NU = jnetem.NU
CLASS_FOLD = {"seq": 0, "ind": 1, "tbf": 2}
KINDS = ("tbf", "seq", "ind")
_CORR_COLS = [jes.P_LATENCY_CORR, jes.P_LOSS_CORR, jes.P_DUPLICATE_CORR,
              jes.P_REORDER_CORR, jes.P_CORRUPT_CORR]


# -- shared helpers ----------------------------------------------------------

def live_state_np(capacity: int, seed: int) -> dict:
    """random_state_np with its rows in thirds, one per kernel class:
    TBF-batch (rate > 0, iid), slot-independent (rate 0, iid), and
    sequential (correlated). Every 7th row has a 200 ms backlog, so the
    TBF third holds overloaded rows that raise `fallback`."""
    d = random_state_np(capacity, seed)
    p = d["props"]
    n = capacity // 3
    iid = slice(0, 2 * n)
    p[iid, _CORR_COLS] = 0.0
    p[iid, jes.P_REORDER_PROB] = 0.0
    p[:n, jes.P_RATE_BPS] = np.random.default_rng(seed).choice(
        [20e6, 1e9, 10e9], n)
    p[n:2 * n, jes.P_RATE_BPS] = 0.0
    p[2 * n:, jes.P_LOSS_CORR] = 50.0
    return d


def live_batches(d: dict, n_rows: int, k_max: int, seed: int):
    """(batches, groups, keyid_map) of one tick over a live_state_np
    state: n_rows busy rows per class (the TBF class's include an
    overloaded row), 1..k_max frames of 64-1500 bytes each."""
    rng = np.random.default_rng(seed)
    props = d["props"]
    cls = {"tbf": np.asarray(jnetem.tbf_batch_rows(props)),
           "ind": np.asarray(jnetem.slot_independent_rows(props))}
    cls["seq"] = ~cls["tbf"] & ~cls["ind"]
    batches, groups = [], {}
    for kind in KINDS:
        cand = np.flatnonzero(cls[kind])
        rows = rng.choice(cand, n_rows, replace=False)
        if kind == "tbf":
            rows[0] = cand[cand % 7 == 0][0]   # 200 ms backlog
        counts = rng.integers(1, k_max + 1, n_rows)
        counts[0] = k_max
        groups[kind] = list(range(len(batches), len(batches) + n_rows))
        for r, m in zip(rows, counts):
            lens = rng.integers(64, 1501, m).astype(np.float32)
            batches.append((None, int(r), lens, None, False))
    keyid_map = {b[1]: entry.link_key_id(b[1]) for b in batches}
    return batches, groups, keyid_map


def np_groups(d, batches, groups, keyid_map):
    E = len(d["uid"])
    return {k: jrt._build_group(batches, groups[k], E, keyid_map)
            for k in KINDS}


def torch_args(quad):
    return tuple(torch.as_tensor(np.asarray(a).astype(
        np.int64 if a.dtype == np.uint32 else a.dtype)) for a in quad)


def jax_args(quad):
    return tuple(jnp.asarray(a) for a in quad)


def jax_uniforms(sub, quads):
    """The [R, K, NU] uniforms JAX's row cores draw for each class under
    the tick sub-key `sub`, as numpy."""
    return {k: np.array(jnetem._uniform_rows(
        jax.random.fold_in(sub, CLASS_FOLD[k]), jnp.asarray(q[3]),
        q[1].shape[0], q[1].shape[1])) for k, q in quads.items()}


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, name, tol):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, name
    if want.dtype == np.float32:
        np.testing.assert_allclose(got, want, err_msg=name, **tol)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_out_close(got, want, kind, label=""):
    """A class's transfer set: (delivered, depart, loss, queue, corrupt
    [, fallback])."""
    assert len(got) == len(want) == (6 if kind == "tbf" else 5)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, f"{label} {kind} out[{i}]",
                     DEPART_TOL if i == 1 else STATE_TOL)


def assert_dyn_close(got, want):
    for name, g, w in zip(("tokens", "t_last", "backlog_until", "corr",
                           "pkt_count"), got, want):
        assert_close(g, w, name, STATE_TOL)


def assert_tel_close(got, want):
    """Every column exact (counts and byte sums are small integers in
    float32) except the latency sum, a sum of departures."""
    got, want = to_np(got), to_np(want)
    lat = ttele.T_LAT_SUM_US
    rest = [c for c in range(ttele.KCOLS) if c != lat]
    np.testing.assert_array_equal(got[:, rest], want[:, rest])
    np.testing.assert_allclose(got[:, lat], want[:, lat], **DEPART_TOL)


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bitwise(a, b, name="value"):
    """Nested tuples / lists / dicts of tensors, bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), name
        for k in a:
            assert_bitwise(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bitwise(x, y, f"{name}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(bits(a), bits(b)), name
    else:
        assert a == b, name


# -- the associative scan ------------------------------------------------------

def _mp_jax(x, y):
    xa11, xa12, xa21, xa22, xc1, xc2 = x
    ya11, ya12, ya21, ya22, yc1, yc2 = y
    m = jnp.maximum
    return (m(ya11 + xa11, ya12 + xa21), m(ya11 + xa12, ya12 + xa22),
            m(ya21 + xa11, ya22 + xa21), m(ya21 + xa12, ya22 + xa22),
            m(m(ya11 + xc1, ya12 + xc2), yc1),
            m(m(ya21 + xc1, ya22 + xc2), yc2))


@pytest.mark.parametrize("K", [1, 2, 5, 13, 16, 64])
def test_associative_scan_bitwise_maxplus(K):
    rng = np.random.default_rng(K)
    elems = [rng.uniform(-5e4, 5e4, (7, K)).astype(np.float32)
             for _ in range(6)]
    elems[1][:, ::3] = -1e30   # the semiring's -inf surrogate
    want = jax.jit(lambda e: jax.lax.associative_scan(_mp_jax, e, axis=1))(
        tuple(jnp.asarray(e) for e in elems))
    got = associative_scan(tnetem._mp_combine,
                           tuple(torch.as_tensor(e) for e in elems), axis=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))


def test_associative_scan_sum_order_and_axis():
    """A float sum is order-sensitive: the port pairs as JAX does."""
    x = np.random.default_rng(0).standard_normal((9, 3)).astype(np.float32)
    x *= np.float32(1e4) ** np.arange(9, dtype=np.float32)[:, None] % 7
    want = np.asarray(jax.lax.associative_scan(jnp.add, jnp.asarray(x)))
    got = associative_scan(torch.add, torch.as_tensor(x), axis=0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- the row cores -------------------------------------------------------------

@pytest.fixture(scope="module")
def core_case():
    """A live state (E = 192), one tick's groups and JAX's draws."""
    d = live_state_np(192, seed=11)
    batches, groups, kmap = live_batches(d, n_rows=40, k_max=16, seed=12)
    quads = np_groups(d, batches, groups, kmap)
    sub = jax.random.split(jax.random.PRNGKey(5))[1]
    return d, quads, sub, jax_uniforms(sub, quads)


def _gathered(d, rows):
    r = np.minimum(np.asarray(rows), len(d["uid"]) - 1)
    return {k: v[r] for k, v in d.items()}


def test_shape_rows_indep_matches_jax(core_case):
    d, quads, sub, us = core_case
    rows, sizes, valid, kids = quads["ind"]
    g = _gathered(d, rows)
    jfn = jax.jit(jnetem.shape_rows_indep)
    jres, jdelta = jfn(jnp.asarray(g["props"]), jnp.asarray(g["active"]),
                       jnp.asarray(sizes), jnp.asarray(valid),
                       jax.random.fold_in(sub, 1), jnp.asarray(kids))
    tres, tdelta = tnetem.shape_rows_indep(
        torch.as_tensor(g["props"]), torch.as_tensor(g["active"]),
        torch.as_tensor(sizes), torch.as_tensor(valid), None,
        u=torch.as_tensor(us["ind"]))
    for f in dataclasses.fields(jnetem.ShapeResult):
        assert_close(getattr(tres, f.name), getattr(jres, f.name), f.name,
                     DEPART_TOL)
    assert_close(tdelta, jdelta, "delta", STATE_TOL)
    assert bool(tres.delivered.any()) and bool(tres.dropped_loss.any())


def test_shape_rows_seq_matches_jax(core_case):
    d, quads, sub, us = core_case
    rows, sizes, valid, kids = quads["seq"]
    g = _gathered(d, rows)
    carry = ("tokens", "t_last", "backlog_until", "corr", "pkt_count")
    jfn = jax.jit(jnetem.shape_rows_seq)
    jcarry, jres = jfn(jnp.asarray(g["props"]), jnp.asarray(g["active"]),
                       tuple(jnp.asarray(g[k]) for k in carry),
                       jnp.asarray(sizes), jnp.asarray(valid),
                       jax.random.fold_in(sub, 0), jnp.asarray(kids))
    tcarry, tres = tnetem.shape_rows_seq(
        torch.as_tensor(g["props"]), torch.as_tensor(g["active"]),
        tuple(torch.as_tensor(g[k]) for k in carry),
        torch.as_tensor(sizes), torch.as_tensor(valid), None,
        u=torch.as_tensor(us["seq"]))
    for f in dataclasses.fields(jnetem.ShapeResult):
        assert_close(getattr(tres, f.name), getattr(jres, f.name), f.name,
                     DEPART_TOL)
    assert_dyn_close(tcarry, jcarry)
    # a lane that is not valid & active keeps the row's state
    idle = ~(np.asarray(valid).any(1) & g["active"])
    assert idle.any()
    np.testing.assert_array_equal(tcarry[0].numpy()[idle],
                                  g["tokens"][idle])


def test_shape_rows_tbf_matches_jax_with_fallback(core_case):
    d, quads, sub, us = core_case
    rows, sizes, valid, kids = quads["tbf"]
    g = _gathered(d, rows)
    cols = ("props", "active", "corr", "pkt_count", "tokens", "t_last",
            "backlog_until")
    jout = jax.jit(jnetem.shape_rows_tbf)(
        *(jnp.asarray(g[k]) for k in cols), jnp.asarray(sizes),
        jnp.asarray(valid), jax.random.fold_in(sub, 2), jnp.asarray(kids))
    tout = tnetem.shape_rows_tbf(
        *(torch.as_tensor(g[k]) for k in cols), torch.as_tensor(sizes),
        torch.as_tensor(valid), None, u=torch.as_tensor(us["tbf"]))
    for f in dataclasses.fields(jnetem.ShapeResult):
        assert_close(getattr(tout[0], f.name), getattr(jout[0], f.name),
                     f.name, DEPART_TOL)
    for name, i in (("tok_row", 1), ("dep_row", 2), ("delta", 3),
                    ("has_accept", 4), ("fallback", 5)):
        assert_close(tout[i], jout[i], name, STATE_TOL)
    assert bool(tout[5].any()), "no TBF-overload row raised fallback"
    assert not bool(tout[5].all())


def test_tbf_core_equals_sequential_core_off_fallback(core_case):
    """The max-plus TBF core is exact where it raises no fallback: the
    sequential core on the same rows and draws gives the same outcomes
    and, for rows that accepted a frame, the same bucket state."""
    d, quads, _sub, us = core_case
    rows, sizes, valid, _kids = quads["tbf"]
    g = {k: torch.as_tensor(v) for k, v in _gathered(d, rows).items()}
    sizes, valid = torch.as_tensor(sizes), torch.as_tensor(valid)
    u = torch.as_tensor(us["tbf"])
    res, tok_row, dep_row, delta, hacc, fbk = tnetem.shape_rows_tbf(
        g["props"], g["active"], g["corr"], g["pkt_count"], g["tokens"],
        g["t_last"], g["backlog_until"], sizes, valid, None, u=u)
    (tk, tl, nf, _corr, cnt), sres = tnetem.shape_rows_seq(
        g["props"], g["active"], (g["tokens"], g["t_last"],
                                  g["backlog_until"], g["corr"],
                                  g["pkt_count"]),
        sizes, valid, None, u=u)
    ok = ~fbk
    for f in dataclasses.fields(tnetem.ShapeResult):
        a, b = getattr(res, f.name)[ok], getattr(sres, f.name)[ok]
        assert_close(a, b, f.name, DEPART_TOL)
    acc = ok & hacc
    assert bool(acc.any())
    assert_close(tok_row[acc], tk[acc], "tokens", STATE_TOL)
    assert_close(dep_row[acc], tl[acc], "t_last", STATE_TOL)
    assert_close(dep_row[acc], nf[acc], "backlog_until", STATE_TOL)
    assert_close(g["pkt_count"][acc] + delta[acc], cnt[acc], "pkt_count",
                 STATE_TOL)


def test_row_core_draws_depend_on_identity_not_batch():
    """The keyed draw: a row's uniforms depend on (key, class, key id,
    slot) only — not its position in the batch, nor the padded K."""
    kids = torch.tensor([[5, 1], [9, 0], [7, 3]], dtype=torch.int64)
    u = tnetem.uniform_rows((1, 2), 2, kids, 3, 4, "cpu")
    assert u.shape == (3, 4, NU) and u.dtype == torch.float32
    assert bool(((u >= 0) & (u < 1)).all())
    swapped = tnetem.uniform_rows((1, 2), 2, kids[[2, 0, 1]], 3, 16, "cpu")
    assert torch.equal(swapped[:, :4], u[[2, 0, 1]])
    assert not torch.equal(tnetem.uniform_rows((1, 2), 1, kids, 3, 4,
                                               "cpu"), u)
    assert not torch.equal(tnetem.uniform_rows((1, 3), 2, kids, 3, 4,
                                               "cpu"), u)


# -- the wrappers over the full state -----------------------------------------

def test_shape_slots_wrappers_match_jax(core_case):
    """Gathers clamp the padding rows (index E), scatters drop them."""
    d, quads, sub, us = core_case
    js, ts = jax_state(d), torch_state(d)
    q = {k: (jax_args(quads[k]), torch_args(quads[k])) for k in KINDS}
    assert int(quads["seq"][0].max()) == len(d["uid"])  # padding present
    jst, jres = jnetem.shape_slots_nodonate(
        js, *q["seq"][0][:3], jax.random.fold_in(sub, 0), q["seq"][0][3])
    tst, tres = tnetem.shape_slots_nodonate(
        ts, *q["seq"][1][:3], None, u=torch.as_tensor(us["seq"]))
    for name in ("tokens", "t_last", "backlog_until", "corr", "pkt_count"):
        assert_close(getattr(tst, name), getattr(jst, name), name,
                     STATE_TOL)
    assert_close(tres.depart_us, jres.depart_us, "depart", DEPART_TOL)
    jres, jcnt = jnetem.shape_slots_indep_nodonate(
        js, *q["ind"][0][:3], jax.random.fold_in(sub, 1), q["ind"][0][3])
    tres, tcnt = tnetem.shape_slots_indep_nodonate(
        ts, *q["ind"][1][:3], None, u=torch.as_tensor(us["ind"]))
    assert_close(tcnt, jcnt, "pkt_count", STATE_TOL)
    assert_close(tres.delivered, jres.delivered, "delivered", STATE_TOL)
    jout = jnetem.shape_slots_tbf_nodonate(
        js, *q["tbf"][0][:3], jax.random.fold_in(sub, 2), q["tbf"][0][3])
    tout = tnetem.shape_slots_tbf_nodonate(
        ts, *q["tbf"][1][:3], None, u=torch.as_tensor(us["tbf"]))
    for i in range(1, 6):
        assert_close(tout[i], jout[i], f"tbf[{i}]", STATE_TOL)
    # the input state is not modified
    assert torch.equal(ts.tokens, torch.as_tensor(d["tokens"]))


# -- telemetry -------------------------------------------------------------------

def test_telemetry_constants_match_jax():
    assert ttele.BUCKET_EDGES_US == jtele.BUCKET_EDGES_US
    for name in ("N_BINS", "KCOLS", "T_TX", "T_DELIVERED", "T_BYTES",
                 "T_DROP_LOSS", "T_DROP_QUEUE", "T_CORRUPT",
                 "T_LAT_SUM_US", "T_QDEPTH", "T_HIST0", "COLUMN_NAMES",
                 "CAUSE_NAMES"):
        assert getattr(ttele, name) == getattr(jtele, name), name


def test_tel_matrix_and_accumulate_match_jax(core_case):
    d, quads, sub, us = core_case
    rows, sizes, valid, kids = quads["seq"]
    g = _gathered(d, rows)
    carry = ("tokens", "t_last", "backlog_until", "corr", "pkt_count")
    _, tres = tnetem.shape_rows_seq(
        torch.as_tensor(g["props"]), torch.as_tensor(g["active"]),
        tuple(torch.as_tensor(g[k]) for k in carry),
        torch.as_tensor(sizes), torch.as_tensor(valid), None,
        u=torch.as_tensor(us["seq"]))
    jres = jnetem.ShapeResult(**{
        f.name: jnp.asarray(getattr(tres, f.name).numpy())
        for f in dataclasses.fields(jnetem.ShapeResult)})
    assert bool(tres.delivered.any())
    jmat = jax.jit(jtele.tel_matrix)(jnp.asarray(sizes),
                                     jnp.asarray(valid), jres)
    tmat = ttele.tel_matrix(torch.as_tensor(sizes), torch.as_tensor(valid),
                            tres)
    assert tmat.shape == (len(rows), ttele.KCOLS)
    assert_tel_close(tmat, jmat)
    E = len(d["uid"])
    acc = np.random.default_rng(3).integers(0, 9, (E, ttele.KCOLS)) \
        .astype(np.float32)
    jacc = jax.jit(jtele.tel_accumulate)(jnp.asarray(acc), jnp.asarray(rows),
                                         jnp.asarray(sizes),
                                         jnp.asarray(valid), jres)
    tacc = ttele.tel_accumulate(convert.tel_from_numpy(acc, "cpu"),
                                torch.as_tensor(rows),
                                torch.as_tensor(sizes),
                                torch.as_tensor(valid), tres)
    assert_tel_close(tacc, jacc)
    assert int(rows.max()) == E  # the padding rows dropped


# -- group packing -----------------------------------------------------------------

def test_build_group_matches_jax():
    d = live_state_np(192, seed=21)
    batches, groups, kmap = live_batches(d, n_rows=9, k_max=5, seed=22)
    E = len(d["uid"])
    for kind in KINDS:
        want = jrt._build_group(batches, groups[kind], E, kmap)
        got = trt._build_group(batches, groups[kind], E, kmap, device="cpu")
        assert [w.shape for w in want] == [tuple(g.shape) for g in got]
        assert want[1].shape == (64, 16)    # the padding ladders
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.astype(
                g.numpy().dtype), err_msg=kind)
        assert got[3].dtype == torch.int64 and int(got[3].max()) < 2 ** 32


# -- the fused tick ------------------------------------------------------------------

TICKS = 5
ELAPSED_US = 1500.0


@pytest.fixture(scope="module")
def tick_case():
    d = live_state_np(192, seed=31)
    batches, groups, kmap = live_batches(d, n_rows=40, k_max=16, seed=32)
    return d, np_groups(d, batches, groups, kmap)


def run_jax_ticks(d, quads, ticks=TICKS):
    """`ticks` chained jitted JAX fused ticks with telemetry; returns
    (per-tick uniforms, per-tick outs, dyn, tel) as numpy."""
    js = jax_state(d)
    E = len(d["uid"])
    key = jax.random.PRNGKey(77)
    dyn, tel = None, jnp.zeros((E, jtele.KCOLS), jnp.float32)
    a = {k: jax_args(quads[k]) for k in KINDS}
    us, outs = [], []
    for _ in range(ticks):
        us.append(jax_uniforms(jax.random.split(key)[1], quads))
        key, _sub, dyn, o, tel = jrt._fused_tick(
            js, dyn, key, jnp.float32(ELAPSED_US), a["seq"], a["tbf"],
            a["ind"], tel, has_seq=True, has_tbf=True, has_ind=True,
            has_dyn=dyn is not None, has_tel=True)
        outs.append(jax.tree.map(np.asarray, o))
    return us, outs, jax.tree.map(np.asarray, dyn), np.asarray(tel)


def run_port_ticks(d, quads, us, ticks=TICKS):
    ts = torch_state(d)
    E = len(d["uid"])
    key = trt.tick_key(77)
    dyn, tel = None, ttele.init_acc(E, "cpu")
    a = {k: torch_args(quads[k]) for k in KINDS}
    outs = []
    for t in range(ticks):
        u = {k: torch.as_tensor(v) for k, v in us[t].items()}
        key, _sub, dyn, o, tel = trt.fused_tick(
            ts, dyn, key, ELAPSED_US, a["seq"], a["tbf"], a["ind"], tel,
            uniforms=u)
        outs.append(o)
    return outs, dyn, tel


@pytest.fixture(scope="module")
def jax_ticks(tick_case):
    return run_jax_ticks(*tick_case)


def test_fused_tick_matches_jax(tick_case, jax_ticks):
    d, quads = tick_case
    us, jouts, jdyn, jtel = jax_ticks
    touts, tdyn, ttel = run_port_ticks(d, quads, us)
    for t, (to, jo) in enumerate(zip(touts, jouts)):
        assert to.keys() == jo.keys()
        for kind in KINDS:
            assert_out_close(to[kind], jo[kind], kind, f"tick {t}")
    assert_dyn_close(tdyn, jdyn)
    assert_tel_close(ttel, jtel)
    assert any(bool(o["tbf"][5].any()) for o in touts), "no fallback row"
    assert float(ttel[:, ttele.T_DELIVERED].sum()) > 0


def test_fused_tick_leaves_its_inputs(tick_case):
    d, quads = tick_case
    ts = torch_state(d)
    a = {k: torch_args(quads[k]) for k in KINDS}
    tel = ttele.init_acc(ts.capacity, "cpu")
    trt.fused_tick(ts, None, trt.tick_key(1), ELAPSED_US, a["seq"],
                   a["tbf"], a["ind"], tel)
    assert not bool(tel.any())
    for name in ("tokens", "t_last", "backlog_until", "corr", "pkt_count"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), d[name])


def run_ladder(ts, a, key, ticks, tel):
    dyn, outs = None, []
    for _ in range(ticks):
        key, sub = trt.split(key)
        el, o = ELAPSED_US, {}
        for kind in KINDS:
            dyn, o[kind], tel = trt.class_tick(ts, dyn, sub, el, a[kind],
                                               tel, kind=kind)
            el = 0.0   # the clock roll applies once per tick
        outs.append(o)
    return outs, dyn, tel


@pytest.mark.parametrize("with_tel", [True, False])
def test_class_ladder_equals_fused_bitwise(tick_case, with_tel):
    """The port's fused ≡ per-class contract, on its own keyed draws."""
    d, quads = tick_case
    ts = torch_state(d)
    a = {k: torch_args(quads[k]) for k in KINDS}
    tel0 = ttele.init_acc(ts.capacity, "cpu") if with_tel else None
    key, dyn, tel, fouts = trt.tick_key(9), None, tel0, []
    for _ in range(3):
        key, _sub, dyn, o, tel = trt.fused_tick(
            ts, dyn, key, ELAPSED_US, a["seq"], a["tbf"], a["ind"], tel)
        fouts.append(o)
    louts, ldyn, ltel = run_ladder(ts, a, trt.tick_key(9), 3, tel0)
    assert_bitwise(louts, fouts, "outs")
    assert_bitwise(ldyn, dyn, "dyn")
    if with_tel:
        assert_bitwise(ltel, tel, "tel")
    else:
        assert ltel is None and tel is None


def test_tick_key_split_is_deterministic_and_fresh():
    k = trt.tick_key(2 ** 40 + 3)
    assert k == (3, 256)
    k1, s1 = trt.split(k)
    assert trt.split(k) == (k1, s1)
    assert len({k, k1, s1, trt.split(k1)[0]}) == 4
    assert all(0 <= w < 2 ** 32 for w in k1 + s1)


def test_fused_tick_with_missing_classes(tick_case):
    """A class without traffic is skipped (its args None)."""
    d, quads = tick_case
    ts = torch_state(d)
    a = torch_args(quads["ind"])
    _, _, dyn, outs, tel = trt.fused_tick(ts, None, trt.tick_key(4), 0.0,
                                          None, None, a)
    assert list(outs) == ["ind"] and tel is None
    np.testing.assert_array_equal(dyn[0].numpy(), d["tokens"])


def test_build_live_tick_classes_and_shapes():
    from kubedtn_tpu_torch.api.types import LinkProperties
    from kubedtn_tpu_torch.models.topologies import (
        clos, load_edge_list_into_state)

    el = clos(4, 12, 0, props=LinkProperties(latency="10ms", rate="10Gbit"),
              links_per_pair=2)
    state, _ = load_edge_list_into_state(el, device="cpu")
    groups = entry.build_live_tick(el, state, 20, 16, 3, device="cpu")
    n = 2 * el.n_links
    props = state.props.numpy()
    for kind, pred in (("tbf", jnetem.tbf_batch_rows),
                       ("ind", jnetem.slot_independent_rows)):
        rows = groups[kind][0].numpy()
        real = rows[rows < state.capacity]
        assert len(real) == 20 and real.max() < n
        assert np.asarray(pred(props[real])).all(), kind
    assert tuple(groups["seq"][1].shape) == (64, 16)
    assert int(groups["seq"][2].sum(1).max()) == 16
    _, _, dyn, outs, _ = trt.fused_tick(
        state, None, trt.tick_key(0), 0.0, groups["seq"], groups["tbf"],
        groups["ind"])
    for kind in KINDS:
        assert bool(outs[kind][0].any()), kind
    assert convert.dyn_from_numpy([x.numpy() for x in dyn], "cpu")[4] \
        .dtype == torch.int32
