"""Nests of tensors in ``jax.tree_util``'s order: the training state, and
the checkpoint manager's key strings.

The JAX package keeps parameters, moments and gradients as pytrees; the
port keeps the same nests of dicts and lists (a model's layers are a list of
per-layer dicts, :meth:`repro_torch.models.Model.params`).  :func:`leaves`
walks them as ``jax.tree.leaves`` does (dict keys sorted, lists in order,
``None`` holding no leaf), so a sum over the leaves, such as AdamW's global
gradient norm, adds them in the JAX package's order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_keys(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key string, leaf)`` pairs in ``jax.tree_util`` order, the key
    strings as ``jax.tree_util.keystr`` writes them (``['key']``, ``[i]``,
    ``.field``); ``None`` holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_keys(tree[k], f"{path}[{k!r}]")
    elif is_namedtuple(tree):
        for name in tree._fields:
            yield from flatten_with_keys(getattr(tree, name),
                                         f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from flatten_with_keys(x, f"{path}[{i}]")
    else:
        yield path, tree


def leaves(tree) -> Iterator[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    return (leaf for _, leaf in flatten_with_keys(tree))


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (nests of the same structure, or with a dict where ``tree`` has
    a leaf: a quantized moment's ``{"q", "scale"}``), keeping ``tree``'s
    structure; ``fn`` is called in :func:`leaves` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        got = {k: map_tree(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: got[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)
