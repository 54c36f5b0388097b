"""Known-bad fixture for the port's purity pass (the roots are the
top-level functions without a leading underscore): each line marked
`# expect: purity` must give a finding, and no other line may. Never
imported — parsed only."""

import random
import time

import numpy as np
import torch

EVENTS = []
CACHE = {}


def step(x):
    t = time.time()            # expect: purity
    print("tick", x)           # expect: purity
    return x + t


def jittered(x):
    return x * random.random()   # expect: purity


def host_rng(x):
    return x + np.random.rand()   # expect: purity


def reseeding(x):
    torch.manual_seed(0)       # expect: purity
    return x


def accum(x):
    EVENTS.append(x)           # expect: purity
    return x


def memo(x):
    CACHE[x.shape[0]] = x      # expect: purity
    return x


def run_loop(xs):
    def body(carry, x):
        EVENTS.append(x)       # expect: purity
        return carry + x

    carry = 0.0
    for x in xs:
        carry = body(carry, x)
    return carry


def calls_helper(x):
    return _helper(x)


def _helper(x):
    return x + time.perf_counter()   # expect: purity
