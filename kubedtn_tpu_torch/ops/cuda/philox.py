"""Philox4x32-10 in plain torch: the exact bits kernel K3 draws.

K3 (csrc/shaping.cu, `PhiloxUniforms`) draws each edge's five uniforms
per step inside the thread, keyed by (seed, 0) with the counter
(edge, step, j, 0) for j = 0, 1: the first call gives lanes 0-3, the
second call's first word lane 4. This module materialises the same bits
on any device, so K3 can be held bit for bit against K2 fed these draws,
and the CPU runs K3's plain version.

uint32 arithmetic is held in int64 tensors and masked to 32 bits; the
32x32 -> 64-bit products are split in 16-bit halves so that no
intermediate leaves int64's range.

Bits become uniforms by the 24-bit rule of the TPU kernel's
`_bits_to_uniform` (kubedtn_tpu/ops/pallas/shaping.py): a LOGICAL shift
right by 8, then times 2^-24, so every draw lies on the 2^-24 grid in
[0, 1). The words here are non-negative int64, so the shift cannot
sign-extend — the trap the TPU kernel documents for its signed bits.
"""

from __future__ import annotations

import torch

from kubedtn_tpu_torch import resolve_device
from kubedtn_tpu_torch.ops.netem import NU

MASK32 = 0xFFFFFFFF
M0 = 0xD2511F53
M1 = 0xCD9E8D57
W0 = 0x9E3779B9
W1 = 0xBB67AE85
ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a uint32 constant m and uint32
    values x held in int64."""
    p_lo = x * (m & 0xFFFF)          # < 2^48
    p_hi = x * (m >> 16)             # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (t >> 32) + (p_hi >> 16), t & MASK32


def philox4x32(ctr, key):
    """Philox4x32-10 of counter words `ctr` (four int64 tensors or ints,
    broadcast together) under key (k0, k1). Returns four int64 tensors
    of uint32 values."""
    dev = next((w.device for w in ctr if isinstance(w, torch.Tensor)),
               None)
    c = [torch.as_tensor(w, dtype=torch.int64, device=dev) for w in ctr]
    return _rounds(list(torch.broadcast_tensors(*c)), key)


def philox4x32_words(ctr, key) -> tuple:
    """philox4x32 of four Python int counter words: four Python ints,
    computed on the host (no tensor, no device)."""
    return tuple(_rounds([int(w) & MASK32 for w in ctr], key))


def _rounds(c: list, key) -> list:
    """The ten Philox rounds on four uint32 words held in int64 tensors
    or Python ints (the same operators serve both)."""
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    for r in range(ROUNDS):
        if r > 0:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c[0])
        hi1, lo1 = _mulhilo(M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (held in int64) -> float32 uniforms in [0, 1) with a
    24-bit mantissa: logical shift right by 8, times 2^-24."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def uniforms(seed: int, capacity: int, steps: int,
             device=None) -> torch.Tensor:
    """The [steps*NU, capacity] float32 uniforms K3 draws for `seed`, on
    `device` (None = the CUDA card): row s*NU + k is lane k of step s,
    the layout K2 reads."""
    device = resolve_device(device)
    e = torch.arange(capacity, dtype=torch.int64, device=device)[None, :]
    s = torch.arange(steps, dtype=torch.int64, device=device)[:, None]
    key = (int(seed) & MASK32, 0)
    first = philox4x32((e, s, 0, 0), key)
    second = philox4x32((e, s, 1, 0), key)
    lanes = first + second[:NU - 4]
    return torch.stack([bits_to_uniform(w) for w in lanes],
                       dim=1).reshape(steps * NU, capacity)
