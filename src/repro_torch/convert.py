"""Carry params across frameworks as nested dicts of numpy arrays.

The tree's keys, leaf shapes and dtypes stay as they are, so params
written by the JAX package (``np.asarray`` of each leaf) load here
unchanged, and the reverse.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.flatten import tree_map
from .device import DeviceLike, resolve_device


def params_from_numpy(tree: Dict[str, Any],
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Nested dict of array-likes → the same dict of tensors on ``device``
    (``None`` means ``"cuda"``).  Each leaf is copied."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Dict of tensors → the same dict of numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
