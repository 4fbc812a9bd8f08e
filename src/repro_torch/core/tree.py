"""Nested dicts and lists of tensors (the port's parameter, optimizer
and training-state trees).

The order of the leaves is fixed and documented, because checkpoints
store leaves by index: a dict's values in the order of its sorted keys,
a list's or tuple's in order, recursively. For trees of dicts this is
``jax.tree_util``'s order, so a tree of the reference's layout flattens
to the reference's leaf order. ``treedef`` writes a tree's structure in
the form of JAX's ``PyTreeDef`` repr (``PyTreeDef({'a': *, 'b': [*,
*]})``), and ``parse_treedef`` reads it back, also from a manifest the
reference wrote.
"""
from __future__ import annotations

import ast


def paths(tree, prefix=()):
    """(path, leaf) pairs in leaf order; a path is a tuple of dict keys
    and list indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(skeleton, flat: list):
    """A tree of ``skeleton``'s structure with ``flat`` as its leaves,
    in leaf order."""
    n = sum(1 for _ in paths(skeleton))
    if n != len(flat):
        raise ValueError(f"unflatten: the structure has {n} leaves, "
                         f"got {len(flat)}")
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(skeleton)


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def set_in(tree, path, value) -> None:
    """``tree[path] = value``, making the dicts on the way (lists must
    exist)."""
    for k in path[:-1]:
        tree = tree[k] if isinstance(tree, list) else tree.setdefault(k, {})
    tree[path[-1]] = value


def treedef(tree) -> str:
    """The structure of ``tree`` as JAX's ``PyTreeDef`` repr writes it."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(walk(v) for v in t) \
                + ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def parse_treedef(text: str):
    """``treedef``'s string (or a reference manifest's) -> a skeleton
    tree with None at the leaves."""
    body = text.strip()
    if not (body.startswith("PyTreeDef(") and body.endswith(")")):
        raise ValueError(f"not a PyTreeDef string: {text[:60]!r}")
    body = body[len("PyTreeDef("):-1]
    marker = "__leaf__"
    skeleton = ast.literal_eval(body.replace("*", repr(marker)))
    return tree_map(lambda x: None, skeleton)
