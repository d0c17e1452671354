"""Nested containers of tensors ("trees") in the JAX package's leaf order.

`jax.tree.flatten` walks dicts in sorted-key order at every level, lists
and tuples in order, and treats None as an empty subtree. The parameter
server's shard split, the codecs' error-feedback keys and the int8
quantizer's random draws all follow that order, and checkpoints name
leaves by their path ("blocks/wq", "m/embed", "step"), so the port walks
its trees the same way.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(node):
    """[(path key, child)] of a container node, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten_with_path(tree) -> list[tuple[str, Any]]:
    """[(path, leaf)] in jax.tree order; a path joins the dict keys and
    sequence indices with "/"."""
    out: list = []
    _walk(tree, [], out)
    return out


# module-level recursions: a nested recursive closure is a reference
# cycle (function -> its cell -> function) that would keep the leaves it
# saw alive until the cyclic garbage collector runs
def _walk(node, prefix, out):
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append(("/".join(prefix), node))
        return
    for k, child in kids:
        _walk(child, prefix + [str(k)], out)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten_like(template, new_leaves):
    """A tree shaped like `template` whose leaves are `new_leaves`, taken
    in jax.tree order."""
    it = iter(new_leaves)
    out = _build(template, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}         # keep the caller's order
    if isinstance(node, (list, tuple)):
        return type(node)(_build(c, it) for c in node)
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    if not rest:
        return unflatten_like(tree, [fn(x) for x in leaves(tree)])
    cols = [leaves(t) for t in (tree,) + rest]
    if len({len(c) for c in cols}) != 1:
        raise ValueError("trees disagree on their leaf count")
    return unflatten_like(tree, [fn(*xs) for xs in zip(*cols)])
