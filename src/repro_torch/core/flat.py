"""The flat parameter plane: ravel a parameter tree ONCE, compute on one buffer.

Counterpart of ``repro.core.flat.FlatSpec``.  ``ravel(tree)`` gives one
contiguous ``(P,)`` buffer (default f32) in the reference's leaf order —
dict keys sorted, so each layer's ``b`` precedes its ``w`` — and
``unravel(flat)`` gives the tree back as views of the buffer.  Weights keep
the JAX layout ``(in, out)``, so the plane is byte-identical to the
reference's.  Buffers with leading batch axes reuse the same table: a
cohort plane is ``(C, P)`` and unravels to ``(C, *shape)`` leaves, which is
how the engine takes one cohort-wide gradient in a single backward.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.utils.trees import (
    ravel_leaves,
    split_flat,
    tree_flatten_with_path,
    tree_unflatten,
)


class LeafSpec(NamedTuple):
    """Static layout of one leaf inside the flat plane."""

    path: str  # jax.tree_util.keystr spelling of the leaf's key path
    shape: Tuple[int, ...]
    dtype: Any  # torch dtype
    offset: int  # first element in the plane
    size: int  # number of elements


class FlatSpec:
    """Static per-leaf offset/shape/dtype table for one tree structure."""

    __slots__ = ("treedef", "leaves", "size")

    def __init__(self, treedef, leaves: Tuple[LeafSpec, ...]):
        self.treedef = treedef
        self.leaves = leaves
        self.size = (leaves[-1].offset + leaves[-1].size) if leaves else 0

    @classmethod
    def from_tree(cls, tree) -> "FlatSpec":
        flat, treedef = tree_flatten_with_path(tree)
        specs, off = [], 0
        for path, leaf in flat:
            if not leaf.dtype.is_floating_point:
                raise TypeError(
                    f"flat plane requires floating leaves; {path} has dtype "
                    f"{leaf.dtype}"
                )
            size = math.prod(leaf.shape)
            specs.append(LeafSpec(path, tuple(leaf.shape), leaf.dtype, off, size))
            off += size
        return cls(treedef, tuple(specs))

    def ravel(self, tree, dtype=torch.float32, batch_dims: int = 0) -> torch.Tensor:
        """Tree → one contiguous ``(*lead, P)`` buffer in ``dtype``."""
        leaves, treedef = tree_flatten_with_path(tree)
        if treedef != self.treedef:
            raise ValueError("tree structure does not match this FlatSpec")
        return ravel_leaves([l for _, l in leaves], dtype=dtype, batch_dims=batch_dims)

    def unravel(self, flat: torch.Tensor, dtype=None):
        """Buffer ``(*lead, P)`` → tree of ``(*lead, *shape)`` leaves.

        Leaves are views of ``flat`` when no cast is needed; leaf dtypes are
        restored from the table unless ``dtype`` overrides them."""
        if flat.shape[-1] != self.size:
            raise ValueError(f"plane has {flat.shape[-1]} elements, spec {self.size}")
        dtypes = [dtype or l.dtype for l in self.leaves]
        casts = None if all(d == flat.dtype for d in dtypes) else dtypes
        leaves = split_flat(flat, [l.shape for l in self.leaves], casts)
        return tree_unflatten(self.treedef, leaves)

    @property
    def nbytes(self) -> int:
        """Bytes of the ORIGINAL tree (per-leaf dtypes): the wire format."""
        return sum(l.size * l.dtype.itemsize for l in self.leaves)

    def __repr__(self) -> str:
        return f"FlatSpec(n_leaves={len(self.leaves)}, size={self.size})"


class CohortUplink(NamedTuple):
    """One in-flight cohort's uplink: the unit of the async engine's ring.

    ``delta`` and ``extra`` are the raw ``(C, P)`` planes as they left the
    wire encoding — dense f32, a ``QPlane`` under int8 / bf16, and the
    delta a ``TopKPlane`` under top-k — so the ring holds the compressed
    form in flight.  ``state_delta`` is ``(C, P)`` too (dense or a
    ``QPlane``): the client-state scatter at fold time is per client.
    ``state_delta`` / ``extra`` are None for specs without them."""

    delta: Any  # (C, P) f32 / QPlane / TopKPlane
    state_delta: Optional[Any]  # (C, P) f32 / QPlane, or None
    extra: Optional[Any]  # (C, P) f32 / QPlane, or None
    ids: Any  # (C,) sampled client ids
    w: Any  # (C,) f32 post-fault weights
    eta_l: Any  # f32 η_l at launch (the fold reuses it)


def ring_push(pending: Sequence[CohortUplink], entry: CohortUplink):
    """Append the just-launched ``entry`` and pop the oldest for folding.
    Returns ``(oldest, new_pending)``; ``pending`` holds D − 1 entries in
    launch order, so with D = 1 it is empty and the entry folds the round
    it launches (the sync schedule)."""
    fifo = (*pending, entry)
    return fifo[0], fifo[1:]
