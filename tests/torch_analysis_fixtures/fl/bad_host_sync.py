# ruff: noqa
"""TORCH001 fixture: host syncs inside functions torch.func transforms run."""
import numpy as np
import torch
from torch.func import grad_and_value, vmap


def _helper(x):
    return x.tolist()                   # line 9: TORCH001 (called from _loss)


class Executor:
    def _loss(self, params, x):
        y = (params * x).sum()
        scale = float(y)                # line 15: TORCH001 (float)
        n = int(x.shape[0])             # allowed: a shape is a host value
        _helper(x)
        return y * scale / n

    def step(self, params, x):
        return vmap(grad_and_value(self._loss))(params, x)


def per_sample(x):
    arr = np.asarray(x)                 # line 25: TORCH001 (np.asarray)
    host = x.cpu()                      # line 26: TORCH001 (.cpu)
    return x.sum().item() + host.sum() + arr.sum()  # line 27: TORCH001 (.item)


def run(x):
    return torch.func.vmap(per_sample)(x)


def host_side(x):
    return float(x.sum())               # allowed: no transform runs it


def scalar_grad(p):
    return torch.func.grad(lambda q: (q * q).sum().numpy())(p)  # line 39
