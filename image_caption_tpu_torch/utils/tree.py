"""Nested parameter containers (dicts, lists, tuples of tensors)."""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of nested dicts, lists and tuples
    (NamedTuples keep their type); other values are leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_stack(trees: Sequence[Any]) -> Any:
    """Trees of one structure -> one tree whose leaves stack the trees'
    leaves on a new dim 0 (``np.stack`` of arrays, ``torch.stack`` of
    tensors)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_stack(list(xs)) for xs in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack(list(xs)) for xs in zip(*trees))
    if isinstance(first, torch.Tensor):
        return torch.stack(list(trees))
    return np.stack(trees)
