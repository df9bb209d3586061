# ruff: noqa
"""DET001 fixture: draws from hidden global RNG streams."""
import random

import numpy as np
import torch


def pick(ids, t):
    winner = random.choice(ids)             # line 10: DET001 (stdlib global)
    noise = np.random.rand(4)               # line 11: DET001 (numpy legacy)
    a = torch.randn(3)                      # line 12: DET001 (torch global)
    b = torch.rand_like(t)                  # line 13: DET001 (torch global)
    t.uniform_()                            # line 14: DET001 (in-place draw)
    torch.manual_seed(0)                    # line 15: DET001 (global reseed)
    torch.cuda.manual_seed_all(0)           # line 16: DET001 (global reseed)
    gen = torch.Generator().manual_seed(0)  # allowed: explicit generator
    c = torch.randn(3, generator=gen)       # allowed: draws from gen
    t.normal_(generator=gen)                # allowed: draws from gen
    d = torch.bernoulli(torch.full((3,), 0.5), generator=gen)  # allowed
    rng = np.random.default_rng(0)          # allowed: explicit Generator
    return winner, noise, a, b, c, d, rng.random()
