"""Trees of tensors as the port keeps them (nested dicts, lists and
tuples; ``None`` holds no leaf), flattened in ``jax.tree_util``'s order
(dict keys sorted) with each leaf named by its ``keystr`` spelling
(``['blocks'][0]['attn']['wq']['w']``)."""
from __future__ import annotations


def flatten(tree, path: str = ""):
    """(paths, leaves) in ``jax.tree_util`` order: dict keys sorted."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [path], [tree]
    paths, leaves = [], []
    for key, sub in items:
        p, v = flatten(sub, path + key)
        paths += p
        leaves += v
    return paths, leaves


def unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterable ``leaves``."""
    return _fill(tree, iter(leaves))


def _fill(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _fill(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, it) for v in tree)
    return next(it)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the
    trees in ``rest`` (same structure)."""
    _, leaves = flatten(tree)
    others = [flatten(t)[1] for t in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves, *others,
                                                  strict=True)])
