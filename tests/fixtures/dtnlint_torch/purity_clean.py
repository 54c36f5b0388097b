"""Clean fixture for the port's purity pass (the roots are the
top-level functions without a leading underscore): host effects
outside the programs and local containers inside them are both
legal."""

import time

import torch


def step(x):
    xs = []
    xs.append(x * 2)         # local list: no effect outside the call
    return torch.stack(xs)


def draws(x, gen):
    # a draw from a generator the caller seeded (the key pass's rules)
    return x + torch.rand(x.shape, generator=gen)


def _host_loop(x):
    t0 = time.time()         # host side, never reached from a root
    y = step(x)
    print("elapsed", time.time() - t0)
    return y
