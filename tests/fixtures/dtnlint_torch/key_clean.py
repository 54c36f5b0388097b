"""Clean fixture for the port's key-discipline pass: zero findings
expected."""

import torch

from kubedtn_tpu_torch.ops.cuda import philox
from kubedtn_tpu_torch.ops.netem import uniform_rows
from kubedtn_tpu_torch.runtime import split, tick_key


def split_then_draw(key, ids):
    key, sub = split(key)
    return key, uniform_rows(sub, 0, ids, 4, 2, "cpu")


def two_ticks(key, ids):
    k1, s1 = split(key)
    _k2, s2 = split(k1)
    return (uniform_rows(s1, 0, ids, 4, 2, "cpu"),
            uniform_rows(s2, 0, ids, 4, 2, "cpu"))


def leaf_kernel(ctr, key):
    # the caller split for us; one draw consumes the parameter
    return philox.philox4x32(ctr, key)


def rooted(seed, ids):
    key = tick_key(seed)
    _next, sub = split(key)
    return uniform_rows(sub, 0, ids, 4, 2, "cpu")


def per_iteration(key, ids, n):
    out = []
    for _ in range(n):
        key, sub = split(key)
        out.append(uniform_rows(sub, 0, ids, 4, 2, "cpu"))
    return out


def seeded_draws(seed, n, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(n, generator=gen, device=dev)
    a.uniform_(generator=gen)
    return a, torch.randint(0, 9, (n,), generator=gen, device=dev)


def own_generator(seed):
    gen = torch.Generator()
    torch.manual_seed(seed)   # beside a generator of its own
    return gen
