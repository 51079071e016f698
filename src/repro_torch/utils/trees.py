"""Parameter-tree helpers on nested lists / tuples / dicts of tensors.

The reference's params are JAX pytrees; here they are plain containers.  The
leaf order is JAX's: sequences in order, dicts in SORTED key order, so a
layer ``{"w", "b"}`` flattens ``b`` before ``w`` and the flat plane is laid
out byte for byte as the reference's.  Paths are spelled like
``jax.tree_util.keystr`` (``[0]['b']``).

``ravel_leaves`` / ``split_flat`` are the flat-plane primitives:
one contiguous buffer per tree, leaves back to back in that order.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence, Tuple

import torch


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    """Returns ``([(path, leaf), ...], treedef)``; anything that is not a
    list, tuple or dict is a leaf."""
    out: List[Tuple[str, Any]] = []
    treedef = _walk(tree, "", out)
    return out, treedef


# The recursions are module-level functions: a nested function that calls
# itself is a reference cycle (function -> closure cell -> function) that
# would hold every leaf it saw, a full model's weights, until the garbage
# collector next runs.
def _walk(node, path, out):
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys), tuple(_walk(node[k], f"{path}[{k!r}]", out) for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, len(node),
                tuple(_walk(c, f"{path}[{i}]", out) for i, c in enumerate(node)))
    out.append((path, node))
    return None


def _build(node, it):
    if node is None:
        return next(it)
    kind, meta, children = node
    built = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(meta, built))
    return built if kind == "list" else tuple(built)


def tree_unflatten(treedef, leaves: Sequence[Any]):
    return _build(treedef, iter(leaves))


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]


def tree_map(fn: Callable, tree, *rest):
    leaves, treedef = tree_flatten_with_path(tree)
    others = [tree_leaves(t) for t in rest]
    return tree_unflatten(
        treedef, [fn(l, *(o[i] for o in others)) for i, (_, l) in enumerate(leaves)]
    )


def ravel_leaves(leaves, dtype=torch.float32, batch_dims: int = 0) -> torch.Tensor:
    """Concatenate ``leaves`` into ONE contiguous ``(*lead, P)`` buffer.

    ``batch_dims`` leading axes are preserved (1 for stacked per-client
    ``(C, *shape)`` leaves → ``(C, P)``); the rest is flattened and cast to
    ``dtype``."""
    segs = [l.reshape(*l.shape[:batch_dims], -1).to(dtype) for l in leaves]
    if len(segs) == 1:
        return segs[0].contiguous()
    return torch.cat(segs, dim=-1)


def split_flat(flat: torch.Tensor, shapes: Sequence[Tuple[int, ...]], dtypes=None):
    """Inverse of :func:`ravel_leaves`: slice a ``(*lead, P)`` buffer back
    into ``(*lead, *shape)`` leaves.  Each leaf is a VIEW of the buffer
    (autograd flows back to it) unless ``dtypes`` asks for a cast."""
    lead = flat.shape[:-1]
    out, off = [], 0
    for i, shape in enumerate(shapes):
        n = math.prod(shape)
        seg = flat[..., off:off + n].reshape(*lead, *shape)
        if dtypes is not None:
            seg = seg.to(dtypes[i])
        out.append(seg)
        off += n
    return out


def tree_bytes(tree) -> int:
    """Bytes of a tree's leaves in their dtypes."""
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree))
