"""Parameter trees: nested dicts of tensors, and their flat view.

Model params, optimizer moments and client updates are nested ``dict``s
whose leaves are tensors.  Every traversal visits the keys sorted at each
level, the order ``jax.tree_util`` uses for dicts, so ``flatten_params``
lays a tree out exactly as ``jax.flatten_util.ravel_pytree`` does: leaves
in sorted-key order, each raveled row-major.  The (K, P) update matrix of
the ``fed_agg`` kernels depends on that order.  ``tree_paths`` walks
any tree, lists and tuples too, in ``jax.tree_util``'s order; the
checkpoint files' keys are its paths (checkpoint/checkpoint.py).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

Tree = Dict[str, Any]


def _items(tree: Any, path: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _items(tree[key], path + (key,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    else:
        raise TypeError(f"params leaf at {'/'.join(path) or '<root>'} is "
                        f"{type(tree).__name__}, not a tensor")


def tree_paths(tree: Any, path: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path parts, leaf)`` in ``jax.tree_util``'s order: dict keys
    sorted, lists and tuples by position (``#i``); ``None`` holds no
    leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_paths(tree[key], path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from tree_paths(sub, path + (f"#{i}",))
    elif tree is not None:
        yield path, tree


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in sorted-key order."""
    return [leaf for _, leaf in _items(tree)]


def tree_map(fn: Callable[..., torch.Tensor], tree: Tree,
             *rest: Tree) -> Tree:
    """A tree shaped like ``tree`` whose leaves are ``fn`` of the matching
    leaves of ``tree`` and ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def flatten_params(tree: Tree
                   ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Tree]]:
    """Ravel ``tree`` into one flat vector, as ``ravel_pytree`` does.

    Returns ``(flat, unflatten)``: ``flat`` holds every leaf, in sorted-key
    order and row-major, in the leaves' promoted dtype; ``unflatten(vec)``
    rebuilds the tree from a vector of the same length, giving each leaf
    back its own shape and dtype (as views of ``vec`` where the dtype
    already matches).
    """
    if not isinstance(tree, dict):
        raise TypeError(f"params must be a dict, got {type(tree).__name__}")
    items = list(_items(tree))
    if not items:
        raise ValueError("cannot flatten a tree without tensors")
    dtype = items[0][1].dtype
    for _, leaf in items[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    flat = torch.cat([leaf.reshape(-1).to(dtype) for _, leaf in items])
    layout = [(path, leaf.shape, leaf.dtype, leaf.numel())
              for path, leaf in items]
    size = flat.numel()

    def unflatten(vec: torch.Tensor) -> Tree:
        if vec.shape != (size,):
            raise ValueError(f"expected a flat vector of {size} values, "
                             f"got shape {tuple(vec.shape)}")
        out: Tree = {}
        offset = 0
        for path, shape, leaf_dtype, n in layout:
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = vec[offset:offset + n].reshape(shape).to(
                leaf_dtype)
            offset += n
        return out

    return flat, unflatten


def flatten_into(tree: Tree, out: torch.Tensor) -> None:
    """Write ``tree``'s flat view into the 1-D tensor ``out`` (one row of
    an update matrix) without building it first."""
    torch.cat([leaf.reshape(-1).to(out.dtype) for leaf in tree_leaves(tree)],
              out=out)
