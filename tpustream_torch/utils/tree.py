"""Nested state dicts as flat leaf lists, in the JAX package's order.

A snapshot stores a program's state as one list of numpy arrays, in the
order ``jax.tree_util.tree_leaves`` walks the reference package's state
pytree: a dict's values by sorted key, a list's or tuple's items in
order, ``None`` as an empty subtree, anything else as one leaf. The
helpers here walk a nested dict/list state of numpy arrays the same way,
without JAX, so the port writes and reads the reference's leaf order.

``to_host`` turns one leaf of a live port state into an owned numpy
array; for a tensor on the ``meta`` device it returns a read-only array
of the right shape and dtype that takes no memory (a leaf spec).
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    out: List[Any] = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
        else:
            out.append(node)

    walk(tree)
    return out


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves`` (which must match in
    count)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def to_host(x: Any) -> np.ndarray:
    """One state leaf as an owned host array: a tensor copied off its
    device (never a view of the live state, which later steps write in
    place), a host array copied, a host int as a 0-d int64."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "meta":
            return np.broadcast_to(np.zeros((), numpy_dtype(x.dtype)),
                                   tuple(x.shape))
        return x.detach().to("cpu", copy=True).numpy()
    if isinstance(x, np.ndarray):
        return np.array(x)
    return np.asarray(int(x), dtype=np.int64)
