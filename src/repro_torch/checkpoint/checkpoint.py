"""Pytree checkpointing (npz-based), in the JAX package's file format.

Flattens a tree of arrays to path-keyed npz entries and restores it into
the structure of a template.  A key is the leaf's path
(``core.flatten.tree_paths``) joined by ``|``: dict keys as they are,
visited in sorted order as ``jax.tree_util`` visits dicts, and list or
tuple positions as ``#i``.  Files written by
the JAX package load here, and the reverse.

Leaves may be tensors (on any device), numpy arrays or Python scalars.
``host_arrays`` moves a snapshot's tensors to the host with one copy per
(device, dtype), so saving waits for the card once, not once a leaf.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.flatten import tree_paths

Pytree = Any
_SEP = "|"


def path_key(path: Sequence[str]) -> str:
    return _SEP.join(path)


def host_arrays(leaves: List[Any]) -> List[np.ndarray]:
    """The leaves as numpy arrays.  Tensors are concatenated per (device,
    dtype) and copied to the host once a group, then split back."""
    out: List[Optional[np.ndarray]] = [None] * len(leaves)
    groups: Dict[tuple, List[int]] = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            groups.setdefault((leaf.device, leaf.dtype), []).append(i)
        else:
            out[i] = np.asarray(leaf)
    for idx in groups.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        host = flat.cpu().numpy()
        offset = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = host[offset:offset + n].reshape(tuple(leaves[i].shape))
            offset += n
    return out


def flatten_with_paths(tree: Pytree, prefix: str = "") -> Dict[str, Any]:
    """``{key: leaf}`` with the leaves as they are (not yet on the host);
    ``prefix`` is joined in front of every key."""
    head = (prefix,) if prefix else ()
    return {path_key(head + path): leaf for path, leaf in tree_paths(tree)}


def _like_leaf(arr: np.ndarray, like: Any, key: str,
               force_dtype: Optional[torch.dtype] = None) -> Any:
    """``arr`` shape-checked against ``like`` and given its type: a tensor
    on ``like``'s device in its dtype (or ``force_dtype``), or a numpy
    array in its dtype."""
    if tuple(arr.shape) != tuple(np.shape(like)):
        raise ValueError(f"shape mismatch at {key}: "
                         f"{arr.shape} vs {tuple(np.shape(like))}")
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(
            device=like.device, dtype=force_dtype or like.dtype)
    return arr.astype(np.asarray(like).dtype)


def unflatten_like(data, like: Pytree, prefix: str = "",
                   force_dtype: Optional[torch.dtype] = None) -> Pytree:
    """Rebuild a tree with ``like``'s structure from the ``prefix|<path>``
    entries of ``data`` (an open npz or a dict of arrays)."""
    head = (prefix,) if prefix else ()

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(node[k], path + (str(k),)) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub, path + (f"#{i}",))
                              for i, sub in enumerate(node))
        if node is None:
            return None
        key = path_key(head + path)
        return _like_leaf(data[key], node, key, force_dtype)

    return build(like, ())


def save_pytree(tree: Pytree, path: str) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    flat = flatten_with_paths(tree)
    np.savez(p, **dict(zip(flat, host_arrays(list(flat.values())))))


def load_pytree(path: str, like: Pytree) -> Pytree:
    """Restore into the structure of ``like`` (shape-checked; each leaf
    takes ``like``'s dtype, and a tensor leaf its device)."""
    with np.load(path, allow_pickle=False) as data:
        return unflatten_like(data, like)


class CheckpointManager:
    """Step-tagged checkpoints with retention. Files: <dir>/step_%08d.npz"""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, tree: Pytree, step: int) -> Path:
        path = self.dir / f"step_{step:08d}.npz"
        save_pytree(tree, str(path))
        self._gc()
        return path

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def steps(self) -> List[int]:
        out = []
        for f in self.dir.glob("step_*.npz"):
            m = re.match(r"step_(\d+)\.npz", f.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, like: Pytree, step: Optional[int] = None) -> Pytree:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return load_pytree(str(self.dir / f"step_{step:08d}.npz"), like)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            (self.dir / f"step_{s:08d}.npz").unlink(missing_ok=True)
