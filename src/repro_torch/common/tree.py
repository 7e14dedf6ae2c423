"""Trees of tensors: nested dicts (keys in sorted order), ``NamedTuple``s
(fields in order), tuples and lists, with tensors or numbers as leaves —
the shape of the parameters, optimizer states and gradients (the port's
counterpart of :mod:`repro.common.tree` and the ``jax.tree_util``
functions the reference's training path uses).  :func:`_children` is the
one place that says how a tree is walked.

A path is a tuple of keys, field names and indices;
:func:`flatten_with_paths` joins it with dots, as
:func:`repro.common.tree.flatten_with_paths` writes it:
``blocks.p0_attn.wq``, ``mu.embed``, ``count``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.spec import TensorSpec

IsLeaf = Optional[Callable[[Any], bool]]


def _children(tree: Any, is_leaf: IsLeaf = None):
    """(names, children, rebuild) of an inner node, None at a leaf (a
    :class:`TensorSpec` is a leaf)."""
    if (is_leaf is not None and is_leaf(tree)) or isinstance(tree,
                                                            TensorSpec):
        return None
    if isinstance(tree, dict):
        keys = sorted(tree)
        return keys, [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree._fields), list(tree), lambda xs: type(tree)(*xs)
    if isinstance(tree, (tuple, list)):
        return [str(i) for i in range(len(tree))], list(tree), type(tree)
    return None


def map_with_paths(fn: Callable, tree: Any, is_leaf: IsLeaf = None,
                   path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` at every leaf, the structure kept; ``is_leaf``
    stops the walk early."""
    node = _children(tree, is_leaf)
    if node is None:
        return fn(path, tree)
    names, kids, rebuild = node
    return rebuild([map_with_paths(fn, x, is_leaf, path + (n,))
                    for n, x in zip(names, kids)])


def leaves_with_paths(tree: Any, is_leaf: IsLeaf = None,
                      path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in the reference's flattening order."""
    node = _children(tree, is_leaf)
    if node is None:
        yield path, tree
        return
    for n, x in zip(*node[:2]):
        yield from leaves_with_paths(x, is_leaf, path + (n,))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves of rest)`` at every leaf of ``tree``; ``rest``
    are trees of the same structure."""
    node = _children(tree)
    if node is None:
        return fn(tree, *rest)
    _, kids, rebuild = node
    others = [_children(r)[1] for r in rest]
    return rebuild([tree_map(fn, x, *(o[i] for o in others))
                    for i, x in enumerate(kids)])


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(dotted path, leaf) pairs in the reference's flattening order,
    ``None`` leaves left out."""
    return [(path_str(p), x) for p, x in leaves_with_paths(tree)
            if x is not None]


def path_str(path: Tuple[Any, ...]) -> str:
    """A path as the reference writes it: its keys, field names and
    indices joined with dots."""
    return ".".join(map(str, path))


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_field(tree: Any, i: int) -> Any:
    """Field ``i`` of the tuple at every leaf of a nested dict whose leaves
    are tuples (what :func:`tree_map` gives for a function returning
    several values)."""
    return map_with_paths(lambda _, t: t[i], tree,
                          lambda x: not isinstance(x, dict))


def _numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        # numpy has no bfloat16
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def tree_bytes(tree: Any) -> int:
    """Total bytes across the tree's array leaves: tensors, numpy arrays
    and shape-and-type specs (:class:`~repro_torch.common.spec.TensorSpec`)."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize
    return total


def tree_param_count(tree: Any) -> int:
    """Total elements across the tree's leaves that have a shape."""
    return sum(int(np.prod(leaf.shape)) for leaf in tree_leaves(tree)
               if hasattr(leaf, "shape"))


def assert_trees_all_close(a: Any, b: Any, rtol: float = 1e-5,
                           atol: float = 1e-5) -> None:
    """Both trees have as many leaves, and each pair in flattening order
    agrees within ``rtol`` and ``atol`` (tensors on any device)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), f"leaf count {len(la)} != {len(lb)}"
    for x, y in zip(la, lb):
        np.testing.assert_allclose(_numpy(x), _numpy(y), rtol=rtol,
                                   atol=atol)


def tree_as_dict(tree: Any) -> Dict[str, np.ndarray]:
    """{dotted path: the leaf as a numpy array} (bfloat16 as float32)."""
    return {k: _numpy(v) for k, v in flatten_with_paths(tree)}
