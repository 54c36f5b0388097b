"""Parallel prefix scan with an associative operator, in plain torch.

`associative_scan` is jax.lax.associative_scan's odd/even recursion
written out over torch tensors: the same pairings, in the same order, so
a floating-point operator (the TBF core's max-plus map composition)
rounds exactly as the JAX package's scan does. A `cumsum`/`cummax`
rewrite is a different order of operations and not the same function in
float32.

The recursion (Blelloch 1990, as JAX implements it):

- combine adjacent pairs (0,1), (2,3), ... and scan that half-length
  sequence recursively: those are the results at the odd positions;
- the even positions after the first combine the previous odd result
  with the element itself;
- interleave the two, as JAX does: each half zero-padded into the gaps
  and the two added (or OR-ed, for bool), so +0.0 fills every gap.
"""

from __future__ import annotations

import torch


def _sl(x: torch.Tensor, start, stop, step, axis: int) -> torch.Tensor:
    return x[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int):
    """a at the even positions, b at the odd, along `axis`
    (len(a) == len(b) or len(b) + 1)."""
    n = a.shape[axis] + b.shape[axis]
    shape = list(a.shape)
    shape[axis] = n
    pa = torch.zeros(shape, dtype=a.dtype, device=a.device)
    pb = torch.zeros(shape, dtype=b.dtype, device=b.device)
    _sl(pa, 0, None, 2, axis).copy_(a)
    _sl(pb, 1, None, 2, axis).copy_(b)
    return pa | pb if a.dtype == torch.bool else pa + pb


def associative_scan(fn, elems, axis: int = 0):
    """Inclusive scan of `elems` (a tensor, or a tuple/list of tensors of
    one length along `axis`) under the associative `fn(a, b)`, which
    takes and returns the same structure. Element k of the result is
    fn(...fn(fn(e0, e1), e2)..., ek)."""
    single = isinstance(elems, torch.Tensor)
    flat = [elems] if single else list(elems)
    axis = axis % flat[0].dim()
    n = flat[0].shape[axis]
    if any(e.shape[axis] != n for e in flat):
        raise ValueError("associative_scan: inputs differ in length along "
                         f"axis {axis}: {[tuple(e.shape) for e in flat]}")

    def combine(a, b):
        c = fn(a[0], b[0]) if single else fn(tuple(a), tuple(b))
        return [c] if single else list(c)

    def scan(es):
        num = es[0].shape[axis]
        if num < 2:
            return es
        reduced = combine([_sl(e, 0, -1, 2, axis) for e in es],
                          [_sl(e, 1, None, 2, axis) for e in es])
        odd = scan(reduced)
        if num % 2 == 0:
            even = combine([_sl(e, 0, -1, None, axis) for e in odd],
                           [_sl(e, 2, None, 2, axis) for e in es])
        else:
            even = combine(odd, [_sl(e, 2, None, 2, axis) for e in es])
        even = [torch.cat([_sl(e, 0, 1, None, axis), r], dim=axis)
                for e, r in zip(es, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    out = scan(flat)
    return out[0] if single else type(elems)(out)
