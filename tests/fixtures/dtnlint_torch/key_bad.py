"""Known-bad fixture for the port's key-discipline pass: each line
marked `# expect: key` must give a finding, and no other line may.
Never imported — parsed only."""

import numpy as np
import torch

from kubedtn_tpu_torch.ops.cuda import philox
from kubedtn_tpu_torch.ops.netem import uniform_rows
from kubedtn_tpu_torch.runtime import tick_key

KEY = (1, 2)


def reuse(key, ids):
    a = uniform_rows(key, 0, ids, 4, 2, "cpu")
    b = uniform_rows(key, 1, ids, 4, 2, "cpu")   # expect: key
    return a + b


def raw_root(seed, ids):
    return uniform_rows(tick_key(seed), 0, ids, 4, 2, "cpu")  # expect: key


def root_into_call(seed, state):
    return shape(state, tick_key(seed))   # expect: key


def loop_invariant(key, ctr, n):
    out = 0
    for _ in range(n):
        out = out + philox.philox4x32(ctr, key)[0]   # expect: key
    return out


def sample_root(seed, ctr):
    key = tick_key(seed)
    return philox.philox4x32_words(ctr, key)   # expect: key


def module_key(ctr):
    return philox.philox4x32(ctr, KEY)   # expect: key


def global_draws(n, dev):
    a = torch.rand(n, device=dev)         # expect: key
    b = torch.randn(n)                    # expect: key
    c = torch.randint(0, 9, (n,))         # expect: key
    d = torch.bernoulli(a)                # expect: key
    e = torch.multinomial(a, 1)           # expect: key
    f = torch.normal(0.0, 1.0, (n,))      # expect: key
    a.uniform_()                          # expect: key
    b.exponential_()                      # expect: key
    return a, b, c, d, e, f


def global_seeds(seed):
    torch.manual_seed(seed)               # expect: key
    torch.cuda.manual_seed(seed)          # expect: key
    torch.cuda.manual_seed_all(seed)      # expect: key
    np.random.seed(seed)                  # expect: key


def shape(state, key):
    return state
