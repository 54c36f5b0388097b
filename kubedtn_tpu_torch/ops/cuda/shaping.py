"""Fused netem+TBF shaping on hand-written Hopper kernels.

Counterpart of kubedtn_tpu/ops/pallas/shaping.py. Three CUDA kernels in
csrc/shaping.cu share one device function that computes the JAX kernels'
`_tile_step_values` for one edge per thread:

    K1  shape_step           <- _shape_kernel            (drop-in step)
    K2  shape_steps_tiled    <- _shape_kernel_steps      (S fused steps,
        with u_t                                          given uniforms)
    K3  shape_steps_tiled    <- _shape_kernel_steps_prng (S fused steps,
        without u_t                                       Philox in-kernel)

Each wrapper launches its kernel for CUDA tensors and runs the kernel's
plain torch version for CPU tensors; a tensor on any other device, or
mixed devices, raises. There is no fallback from the card to the plain
version. The plain versions:

    K1  netem._shape_step_from_u
    K2  shape_steps_plain: S sequential plain steps on the column state
    K3  shape_steps_plain fed philox.uniforms, the exact bits K3 draws

`LAUNCHES` counts kernel launches per kernel (plain runs do not count).

Layout: the tiled state is column-major — props [NPROP, E], corr
[NCORR, E] and [E] vectors. The TPU's [C, R, 128] tiling is a vector-
register artefact; `tiles.reshape(C, -1)[:, :E]` of the JAX tiled state
equals this package's array.
"""

from __future__ import annotations

import dataclasses

import torch

from kubedtn_tpu_torch import _build
from kubedtn_tpu_torch.ops import edge_state as es
from kubedtn_tpu_torch.ops import netem
from kubedtn_tpu_torch.ops.cuda import philox
from kubedtn_tpu_torch.ops.edge_state import EdgeState

FLAG_DELIVERED = 1
FLAG_DROP_LOSS = 2
FLAG_DROP_QUEUE = 4
FLAG_CORRUPTED = 8
FLAG_DUPLICATED = 16
FLAG_REORDERED = 32

_FLAG_FIELDS = (
    ("delivered", FLAG_DELIVERED),
    ("dropped_loss", FLAG_DROP_LOSS),
    ("dropped_queue", FLAG_DROP_QUEUE),
    ("corrupted", FLAG_CORRUPTED),
    ("duplicated", FLAG_DUPLICATED),
    ("reordered", FLAG_REORDERED),
)

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"shape_step_rows": 0, "shape_steps_cols": 0,
            "shape_steps_cols_philox": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class TiledShapeState:
    """EdgeState's shaping-dynamic columns in kernel layout.

    props [NPROP, E] (loop-invariant), corr [NCORR, E],
    tokens/t_last/backlog [E] float32, count [E] int32."""

    props: torch.Tensor
    corr: torch.Tensor
    tokens: torch.Tensor
    t_last: torch.Tensor
    backlog: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.tokens.shape[0]


def tile_state(state: EdgeState) -> TiledShapeState:
    """One-time layout change into the column-major kernel layout (new
    tensors; `state` is not modified)."""
    return TiledShapeState(
        props=state.props.T.contiguous(),
        corr=state.corr.T.contiguous(),
        tokens=state.tokens.clone(),
        t_last=state.t_last.clone(),
        backlog=state.backlog_until.clone(),
        count=state.pkt_count.clone(),
    )


def untile_state(tstate: TiledShapeState, state: EdgeState) -> EdgeState:
    """Fold the tiled dynamic columns back into an EdgeState (the
    inverse of tile_state for everything that changes)."""
    return dataclasses.replace(
        state,
        tokens=tstate.tokens,
        t_last=tstate.t_last,
        backlog_until=tstate.backlog,
        corr=tstate.corr.T.contiguous(),
        pkt_count=tstate.count,
    )


def tile_vec(x: torch.Tensor, tstate: TiledShapeState) -> torch.Tensor:
    """[E] vector in the tiled layout (sizes/act/t_arrival that stay
    constant across a tiled run): the kernels read it as it is."""
    if tuple(x.shape) != (tstate.capacity,):
        raise ValueError(f"expected shape ({tstate.capacity},), got "
                         f"{tuple(x.shape)}")
    return x.contiguous()


def pack_flags(res: netem.ShapeResult) -> torch.Tensor:
    """ShapeResult's six masks -> one int32 FLAG_* word per edge."""
    out = torch.zeros(res.delivered.shape, dtype=torch.int32,
                      device=res.delivered.device)
    for name, bit in _FLAG_FIELDS:
        out |= getattr(res, name).to(torch.int32) * bit
    return out


def unpack_flags(depart: torch.Tensor,
                 flags: torch.Tensor) -> netem.ShapeResult:
    return netem.ShapeResult(
        depart_us=depart,
        **{name: (flags & bit) != 0 for name, bit in _FLAG_FIELDS})


# flag_counts' keys, as the JAX package names them, with their bits
COUNT_BITS = (("delivered", FLAG_DELIVERED), ("drop_loss", FLAG_DROP_LOSS),
              ("drop_queue", FLAG_DROP_QUEUE),
              ("corrupted", FLAG_CORRUPTED),
              ("duplicated", FLAG_DUPLICATED),
              ("reordered", FLAG_REORDERED))


def flag_counts(flags: torch.Tensor) -> dict:
    """Per-class totals of a flags slab as int32 scalars on its device —
    six scalars cross to the host instead of the slab."""
    return {name: ((flags & bit) != 0).sum().to(torch.int32)
            for name, bit in COUNT_BITS}


# -- device checks -------------------------------------------------------

def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _checked(specs) -> torch.device:
    """specs: (name, tensor, dtype, shape). Every tensor must lie on one
    CUDA device, be contiguous and have the dtype and shape given."""
    dev = specs[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA or CPU tensors, got "
                         f"{dev}")
    for name, t, dtype, shape in specs:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


F32, I32, BOOL = torch.float32, torch.int32, torch.bool


# -- K1: the drop-in step ------------------------------------------------

def shape_step(state: EdgeState, sizes: torch.Tensor,
               have_pkt: torch.Tensor, t_arrival: torch.Tensor,
               u: torch.Tensor, *, donate: bool):
    """One packet per edge through netem -> TBF with the given [E, NU]
    uniforms: kernel K1 for CUDA tensors, netem._shape_step_from_u for
    CPU tensors. Same results either way.

    donate=True lets K1 write the new shaping state into `state`'s
    tensors in place (the input must not be used afterwards);
    donate=False writes fresh tensors. Returns (state', ShapeResult)."""
    state, depart, flags = shape_step_flags(state, sizes, have_pkt,
                                            t_arrival, u, donate=donate)
    return state, unpack_flags(depart, flags)


def _u_rows(E: int, u_rows: int | None) -> int:
    """The uniforms' row count: E by default, else a divisor of E."""
    if u_rows is None:
        return E
    u_rows = int(u_rows)
    if u_rows <= 0 or E % u_rows:
        raise ValueError(f"u_rows={u_rows} must be a positive divisor of "
                         f"the {E} state rows")
    return u_rows


def shape_step_flags(state: EdgeState, sizes: torch.Tensor,
                     have_pkt: torch.Tensor, t_arrival: torch.Tensor,
                     u: torch.Tensor, *, donate: bool,
                     u_rows: int | None = None):
    """shape_step with the outcome packed as FLAG_* words: on the card
    this enqueues kernel K1 and nothing else. Returns (state', depart
    [E], flags int32 [E]).

    `u_rows` (default E) is the uniforms' row count, a divisor of E:
    `u` is [u_rows, NU] and row e reads row e % u_rows. A replica sweep
    passes one step's [E, NU] draws for its N x E rows this way
    (twin/engine.py); the plain version computes the same."""
    E = state.capacity
    n_u = _u_rows(E, u_rows)
    if _on_cpu(state.tokens):
        if tuple(u.shape) != (n_u, netem.NU):
            raise ValueError(f"u has shape {tuple(u.shape)}, expected "
                             f"{(n_u, netem.NU)}")
        if n_u != E:
            u = u.repeat(E // n_u, 1)
        state, res = netem._shape_step_from_u(state, sizes, have_pkt,
                                              t_arrival, u)
        return state, res.depart_us, pack_flags(res)
    dev = _checked([
        ("props", state.props, F32, (E, es.NPROP)),
        ("corr", state.corr, F32, (E, es.NCORR)),
        ("u", u, F32, (n_u, netem.NU)),
        ("tokens", state.tokens, F32, (E,)),
        ("t_last", state.t_last, F32, (E,)),
        ("backlog_until", state.backlog_until, F32, (E,)),
        ("pkt_count", state.pkt_count, I32, (E,)),
        ("sizes", sizes, F32, (E,)),
        ("t_arrival", t_arrival, F32, (E,)),
        ("have_pkt", have_pkt, BOOL, (E,)),
        ("active", state.active, BOOL, (E,)),
    ])
    out = state if donate else dataclasses.replace(state, **{
        k: torch.empty_like(getattr(state, k)) for k in
        ("tokens", "t_last", "backlog_until", "corr", "pkt_count")})
    depart = torch.empty(E, dtype=F32, device=dev)
    flags = torch.empty(E, dtype=I32, device=dev)
    if E:
        lib = _build.library("shaping")
        _build.check(lib.kdt_shape_step_rows(
            state.props.data_ptr(), state.corr.data_ptr(), u.data_ptr(),
            state.tokens.data_ptr(), state.t_last.data_ptr(),
            state.backlog_until.data_ptr(), state.pkt_count.data_ptr(),
            sizes.data_ptr(), t_arrival.data_ptr(), have_pkt.data_ptr(),
            state.active.data_ptr(), depart.data_ptr(), flags.data_ptr(),
            out.tokens.data_ptr(), out.t_last.data_ptr(),
            out.backlog_until.data_ptr(), out.corr.data_ptr(),
            out.pkt_count.data_ptr(), E, n_u, _stream(dev)),
            "shape_step_rows")
        LAUNCHES["shape_step_rows"] += 1
    return out, depart, flags


# -- K2 / K3: fused steps on the tiled state -----------------------------

def shape_steps_plain(tstate: TiledShapeState, sizes_t: torch.Tensor,
                      act_t: torch.Tensor, t_arr_t: torch.Tensor,
                      u_t: torch.Tensor, steps: int):
    """Plain version of K2 (and of K3, given philox.uniforms): `steps`
    sequential netem.shape_rows calls on the column state, step s
    reading uniform rows [s*NU, (s+1)*NU). Returns a NEW tiled state and
    depart [steps, E], flags int32 [steps, E]."""
    NU = netem.NU
    props, act = tstate.props.T, act_t > 0
    tokens, t_last, backlog = tstate.tokens, tstate.t_last, tstate.backlog
    corr, count = tstate.corr.T, tstate.count
    deps, fls = [], []
    for s in range(steps):
        res, (tokens, t_last, backlog, corr, count) = netem.shape_rows(
            props, corr, tokens, t_last, backlog, count, sizes_t, t_arr_t,
            act, u_t[s * NU:(s + 1) * NU].T)
        deps.append(res.depart_us)
        fls.append(pack_flags(res))
    new = TiledShapeState(props=tstate.props, corr=corr.T.contiguous(),
                          tokens=tokens, t_last=t_last, backlog=backlog,
                          count=count)
    return new, torch.stack(deps), torch.stack(fls)


def shape_steps_tiled(tstate: TiledShapeState, sizes_t: torch.Tensor,
                      act_t: torch.Tensor, t_arr_t: torch.Tensor, seed,
                      steps: int, u_t: torch.Tensor | None = None):
    """`steps` shaping steps fused into one launch, the mutable state
    crossing steps in registers; sizes/act/t_arrival stay constant.
    With `u_t` ([steps*NU, E]) kernel K2 reads the given uniforms;
    without it kernel K3 draws Philox4x32-10 in the thread from `seed`
    (int, taken mod 2^32). CPU tensors run the plain versions.

    DONATES tstate: on the card the kernel updates its tensors in
    place. Returns (tstate', depart [steps, E], flags int32 [steps, E])."""
    E = tstate.capacity
    if _on_cpu(tstate.tokens):
        if u_t is None:
            u_t = philox.uniforms(seed, E, steps, tstate.tokens.device)
        return shape_steps_plain(tstate, sizes_t, act_t, t_arr_t, u_t,
                                 steps)
    specs = [
        ("props", tstate.props, F32, (es.NPROP, E)),
        ("corr", tstate.corr, F32, (es.NCORR, E)),
        ("tokens", tstate.tokens, F32, (E,)),
        ("t_last", tstate.t_last, F32, (E,)),
        ("backlog", tstate.backlog, F32, (E,)),
        ("count", tstate.count, I32, (E,)),
        ("sizes_t", sizes_t, F32, (E,)),
        ("t_arr_t", t_arr_t, F32, (E,)),
        ("act_t", act_t, I32, (E,)),
    ]
    if u_t is not None:
        specs.append(("u_t", u_t, F32, (steps * netem.NU, E)))
    dev = _checked(specs)
    depart = torch.empty((steps, E), dtype=F32, device=dev)
    flags = torch.empty((steps, E), dtype=I32, device=dev)
    if E and steps:
        lib = _build.library("shaping")
        ts = tstate
        tail = (ts.props.data_ptr(), ts.corr.data_ptr(),
                ts.tokens.data_ptr(), ts.t_last.data_ptr(),
                ts.backlog.data_ptr(), ts.count.data_ptr(),
                sizes_t.data_ptr(), t_arr_t.data_ptr(), act_t.data_ptr(),
                depart.data_ptr(), flags.data_ptr(), E, steps,
                _stream(dev))
        if u_t is not None:
            name = "shape_steps_cols"
            rc = lib.kdt_shape_steps_cols(u_t.data_ptr(), *tail)
        else:
            name = "shape_steps_cols_philox"
            rc = lib.kdt_shape_steps_cols_philox(int(seed) & philox.MASK32,
                                                 *tail)
        _build.check(rc, name)
        LAUNCHES[name] += 1
    return tstate, depart, flags


def shape_step_tiled(tstate: TiledShapeState, sizes_t: torch.Tensor,
                     act_t: torch.Tensor, t_arr_t: torch.Tensor, seed,
                     u_t: torch.Tensor | None = None):
    """One step in the tiled layout — the steps=1 case of
    shape_steps_tiled. Returns (tstate', depart [E], flags int32 [E])."""
    tstate, depart, flags = shape_steps_tiled(tstate, sizes_t, act_t,
                                              t_arr_t, seed, 1, u_t)
    return tstate, depart[0], flags[0]
