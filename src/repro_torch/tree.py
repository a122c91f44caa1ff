"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

A tree is a dict (keys visited in sorted order, as JAX flattens a dict),
a list or tuple (visited by index), or a leaf.  A leaf's path is the
tuple of keys and indices that reach it, so ``flatten_with_path`` gives
the same leaves in the same order, under the same paths, as
``jax.tree_util.tree_flatten_with_path`` gives for the reference's
parameter dicts.
"""

from __future__ import annotations

from typing import Any, Callable


def flatten_with_path(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(path, leaf), ...] in JAX's flattening order."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in flatten_with_path(tree[key], prefix + (key,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in flatten_with_path(sub, prefix + (i,))]
    return [(prefix, tree)]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """The tree with ``fn`` applied to every leaf."""
    return map_with_path(lambda _path, leaf: fn(leaf), tree)


def map_with_path(fn: Callable[[tuple, Any], Any], tree: Any,
                  prefix: tuple = ()) -> Any:
    """The tree with ``fn(path, leaf)`` in place of every leaf."""
    if isinstance(tree, dict):
        return {key: map_with_path(fn, sub, prefix + (key,))
                for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, sub, prefix + (i,))
                          for i, sub in enumerate(tree))
    return fn(prefix, tree)


def at(tree: Any, path: tuple) -> Any:
    """The subtree (or leaf) of ``tree`` at ``path``."""
    for key in path:
        tree = tree[key]
    return tree
