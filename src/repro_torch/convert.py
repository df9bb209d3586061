"""Carry params and train states across frameworks as nested dicts of
numpy arrays.

The tree's keys, leaf shapes and dtypes stay as they are, so params
written by the JAX package (``np.asarray`` of each leaf) load here
unchanged, and the reverse.  A train state differs in one leaf: the
optimizer's step ``count``, a 0-d array there and a host int here.

``bfloat16`` leaves cross bit for bit through their 16-bit patterns: an
array whose dtype is named ``bfloat16`` (the type JAX's arrays carry)
becomes a ``torch.bfloat16`` tensor, and back.  Numpy has no such type of
its own, so the way back needs one registered in the process (JAX or
``ml_dtypes`` loaded); the port imports neither.

A DTensor leaf (the sharded train step's) is gathered whole with
``full_tensor()``, a collective: every rank of its mesh calls
``params_to_numpy`` / ``train_state_to_numpy`` together.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .core.flatten import tree_map
from .device import DeviceLike, resolve_device


def _to_tensor(leaf: Any) -> torch.Tensor:
    a = np.array(leaf)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_array(t: torch.Tensor) -> np.ndarray:
    if isinstance(t, DTensor):          # gathered whole on every rank
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        raise TypeError("numpy has no bfloat16 type in this process: load "
                        "ml_dtypes (or JAX) to carry a bfloat16 tensor "
                        "out") from None
    return t.view(torch.uint16).numpy().view(bf16)


def params_from_numpy(tree: Dict[str, Any],
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Nested dict of array-likes → the same dict of tensors on ``device``
    (``None`` means ``"cuda"``).  Each leaf is copied."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a).to(dev), tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Dict of tensors → the same dict of numpy arrays on the host."""
    return tree_map(_to_array, params)


def train_state_from_numpy(tree: Dict[str, Any],
                           device: DeviceLike = None) -> Dict[str, Any]:
    """A train state ``{"params", "opt"}`` of array-likes, as the JAX
    package's ``make_train_step`` holds it (the optimizer's ``count`` a 0-d
    int array), → the port's: tensors on ``device``, ``count`` a host int
    (``optim.adam`` keeps it on the host, so its bias corrections cost no
    device sync)."""
    opt = dict(tree["opt"])
    count = opt.pop("count", None)
    out = {"params": params_from_numpy(tree["params"], device),
           "opt": params_from_numpy(opt, device)}
    if count is not None:
        out["opt"]["count"] = int(np.asarray(count))
    return out


def train_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's train state → the JAX package's layout in numpy arrays,
    ``count`` an int32 0-d array as ``jnp.zeros((), jnp.int32)`` starts it."""
    opt = dict(state["opt"])
    count = opt.pop("count", None)
    out = {"params": params_to_numpy(state["params"]),
           "opt": params_to_numpy(opt)}
    if count is not None:
        out["opt"]["count"] = np.asarray(count, dtype=np.int32)
    return out
