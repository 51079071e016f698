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
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import group_sq_norm, sum_partial
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
        return self.unravel_views(self.views(flat), dtype)

    def views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Buffer ``(*lead, P)`` → its ``(*lead, *shape)`` leaf views, in the
        table's order and ``flat``'s dtype."""
        return split_flat(flat, [l.shape for l in self.leaves])

    def unravel_views(self, views: Sequence[torch.Tensor], dtype=None):
        """Leaf views (``views``) → the tree, each leaf cast to its table
        dtype (or ``dtype``) where it differs; otherwise the view itself."""
        leaves = []
        for v, l in zip(views, self.leaves):
            d = dtype or l.dtype
            leaves.append(v if v.dtype == d else v.to(d))
        return tree_unflatten(self.treedef, leaves)

    def view_leaf(self, flat: torch.Tensor, key: Union[int, str], dtype=None) -> torch.Tensor:
        """One leaf of the plane ``(*lead, P)`` as ``(*lead, *shape)``, by
        index or by key path (``LeafSpec.path``), in its table dtype (or
        ``dtype``), without the tree: a view where no cast is needed."""
        if isinstance(key, str):
            matches = [i for i, l in enumerate(self.leaves) if l.path == key]
            if not matches:
                raise KeyError(f"no leaf {key!r}; paths: {[l.path for l in self.leaves]}")
            key = matches[0]
        spec = self.leaves[key]
        seg = flat[..., spec.offset:spec.offset + spec.size]
        return seg.reshape(*flat.shape[:-1], *spec.shape).to(dtype or spec.dtype)

    @property
    def nbytes(self) -> int:
        """Bytes of the ORIGINAL tree (per-leaf dtypes): the wire format."""
        return sum(l.size * l.dtype.itemsize for l in self.leaves)

    def __repr__(self) -> str:
        return f"FlatSpec(n_leaves={len(self.leaves)}, size={self.size})"


class GroupPlane(NamedTuple):
    """A flat plane over one rank's share of a model group's params (the
    reference's ``fed_dryrun`` layout: each client's model tensor-sharded
    over ``"model"``): the rank's plane is its share's leaves raveled, ``(C,
    P_r)`` for a cohort, so every elementwise step (the local steps, the
    fold, the post-steps) runs on the share as it is.  What reduces over P
    reads ``parts`` (``sharding.rules.group_parts`` of each leaf, in the
    plane's order): a gradient's partial parts are summed over the group,
    and a norm counts each replicated part once.  What reads a client's
    whole row reads ``dims`` (each leaf's ``rules.split_dim``) and
    ``whole_shapes``: the noise draw takes the whole plane's columns of the
    share (``columns``), and an escape hatch gets the whole planes
    (``gather_plane`` / ``gather_leaves``) and hands back their share
    (``share_plane`` / ``share_leaves``).  The whole plane's order is the
    unsharded tree's leaf order, row-major within each leaf.  Built by
    ``sharding.shard.group_plane``; the same methods serve the per-leaf
    tree path's ``(C, *share)`` leaves."""

    parallel: Any  # models.layers.ParallelContext
    parts: Tuple  # rules.group_parts of each leaf of the FlatSpec
    whole_size: int  # P of the unsharded plane
    whole_nbytes: int  # bytes of the unsharded tree (per-leaf dtypes)
    dims: Tuple = ()  # rules.split_dim of each leaf (None, an int or a Pieces)
    whole_shapes: Tuple = ()  # each leaf's unsharded shape

    def sum_partial(self, spec: "FlatSpec", grads: torch.Tensor) -> None:
        """Sum, in place, the partial parts of the gradient plane ``grads``
        (``(..., P_r)``) over the group."""
        sum_partial(spec.views(grads), self.parts, self.parallel, lead=grads.dim() - 1)

    def norm(self, spec: "FlatSpec", plane: torch.Tensor) -> torch.Tensor:
        """The L2 norm of the whole ``(P,)`` plane whose share ``plane`` is."""
        return self.tree_norm(spec.views(plane))

    def tree_norm(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        """The f32 L2 norm of the whole tree whose share ``leaves`` are."""
        return torch.sqrt(group_sq_norm(list(leaves), self.parts, self.parallel))

    def rows_sqnorm(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        """``(C,)`` f32: the squared L2 norm of each client's whole row,
        from this rank's ``(C, *share)`` leaves."""
        return group_sq_norm(list(leaves), self.parts, self.parallel, lead=1)

    def rows_finite(self, finite: torch.Tensor) -> torch.Tensor:
        """``(C,)`` bool: every rank's ``finite`` (each its share's rows)
        ANDed over the group."""
        bad = self.parallel.all_reduce((~finite).to(torch.float32))
        return bad == 0.0

    def _offsets(self) -> List[int]:
        out, at = [], 0
        for shape in self.whole_shapes:
            out.append(at)
            at += math.prod(shape)
        return out

    def columns(self, i: int, device) -> torch.Tensor:
        """This rank's columns of the whole plane in leaf ``i`` of its share,
        as a ``(n_i,)`` index in the share leaf's row-major order: the
        whole leaf's column indices, sliced as the share is (``shard.take``).
        int32 where the whole plane has fewer than 2^31 elements."""
        from repro_torch.sharding.shard import take

        dtype = torch.int32 if self.whole_size < 2 ** 31 else torch.int64
        off, shape = self._offsets()[i], self.whole_shapes[i]
        index = torch.arange(off, off + math.prod(shape), dtype=dtype, device=device)
        return take(index.view(shape), self.dims[i], self.parallel.rank,
                    self.parallel.size).reshape(-1)

    def _every(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked ``(N, ...)`` in rank order, moved as
        bytes (gloo refuses some dtypes)."""
        got = self.parallel.all_gather(_bytes(t)[None], 0)
        return got.view(t.dtype).reshape(self.parallel.size, *t.shape)

    def gather_leaves(self, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The whole leaves whose shares ``leaves`` are (one client's, in
        the share's order), joined from every rank's (``shard.join_shares``)."""
        from repro_torch.sharding.shard import join_shares

        return [join_shares(list(self._every(t)), d, self.parallel.size)
                for t, d in zip(leaves, self.dims)]

    def share_leaves(self, whole: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's share of each whole leaf (``shard.take``)."""
        from repro_torch.sharding.shard import take

        return [take(w, d, self.parallel.rank, self.parallel.size)
                for w, d in zip(whole, self.dims)]

    def gather_plane(self, spec: "FlatSpec", plane: torch.Tensor) -> torch.Tensor:
        """The whole ``(P,)`` plane whose share is ``plane`` (``(P_r,)``,
        laid out by ``spec``): one ``all_gather``, then each leaf joined."""
        from repro_torch.sharding.shard import join_shares

        views = [spec.views(row) for row in self._every(plane)]
        return torch.cat([join_shares([v[i] for v in views], d, self.parallel.size).reshape(-1)
                          for i, d in enumerate(self.dims)])

    def share_plane(self, spec: "FlatSpec", whole: torch.Tensor) -> torch.Tensor:
        """This rank's ``(P_r,)`` share of the whole ``(P,)`` plane ``whole``."""
        leaves = [whole[o:o + math.prod(s)].view(s)
                  for o, s in zip(self._offsets(), self.whole_shapes)]
        return torch.cat([t.reshape(-1) for t in self.share_leaves(leaves)])


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


def pad_cohort(a, target: int, mode: str = "edge"):
    """Pad the leading (cohort) axis of ``a`` — a tensor, a dict of tensors
    or None — to ``target`` rows.

    The cohort-parallel engine pads the drawn cohort to a multiple of the
    shard count AFTER the minibatch and client-state draws, so the
    generator's stream and every real client's inputs are the unsharded
    round's.  ``mode="edge"`` (data: batches, ids, gathered client-state
    rows, full batches) repeats the last real row, so pad clients compute
    on a real client's finite inputs; ``mode="zero"`` (the weight row and
    masks) pads exact zeros, so pad rows never count: a trailing ``+0.0``
    in the fold is exact."""
    if a is None:
        return None
    if isinstance(a, dict):
        return {k: pad_cohort(v, target, mode) for k, v in a.items()}
    extra = target - a.shape[0]
    if extra <= 0:
        return a
    if mode == "edge":
        tail = a[-1:].expand(extra, *a.shape[1:])
    else:
        tail = torch.zeros((extra, *a.shape[1:]), dtype=a.dtype, device=a.device)
    return torch.cat([a, tail])


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a uint8 tensor (last axis × itemsize).  The
    collectives here move data and reduce nothing, so they send bytes: any
    dtype crosses any transport (gloo refuses int16, for one)."""
    return t.contiguous().view(torch.uint8)


def gather_rows(rows: torch.Tensor, group, n_shards: int) -> torch.Tensor:
    """All-gather each rank's ``(C_loc, ...)`` rows into the ``(n·C_loc,
    ...)`` padded cohort, rank r's rows at ``[r·C_loc, (r+1)·C_loc)``."""
    send = _bytes(rows)
    parts = [torch.empty_like(send) for _ in range(n_shards)]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts).view(rows.dtype).reshape(n_shards * rows.shape[0],
                                                     *rows.shape[1:])


def cohort_to_columns(plane: torch.Tensor, group, n_shards: int) -> torch.Tensor:
    """This rank's ``(C_loc, P)`` rows → the ``(C_pad, chunk)`` column block
    ``r`` of the whole padded cohort, ``chunk = ceil(P / n_shards)``: pad
    P to ``n·chunk``, lay the rows out as ``(n, C_loc, chunk)`` (block s
    goes to rank s) and ``all_to_all``.  The received blocks stack in rank
    order, so rows come out in global client order BECAUSE rank r holds the
    r-th block of rows.

    This is the first half of a reduce-scatter: the fold then reduces over
    the COMPLETE cohort for its columns, in the unsharded order.  A
    ``reduce_scatter`` would pre-reduce each rank's rows and re-associate
    the f32 sum, and sharded ≡ unsharded bitwise would break."""
    send = columns_send(plane, n_shards)
    recv = torch.empty_like(send)
    dist.all_to_all_single(_bytes(recv), _bytes(send), group=group)
    return recv.reshape(-1, send.shape[-1])


def columns_send(plane: torch.Tensor, n_shards: int) -> torch.Tensor:
    """``cohort_to_columns``' send buffer: this rank's ``(C_loc, P)`` rows
    as a contiguous ``(n, C_loc, chunk)`` tensor whose block s, the rows'
    columns ``[s·chunk, (s+1)·chunk)`` of the plane padded to ``n·chunk``,
    goes to rank s.  Rank r receives block r of every rank, in rank
    order."""
    C_loc, Pn = plane.shape
    chunk = -(-Pn // n_shards)
    padded = torch.nn.functional.pad(plane, (0, chunk * n_shards - Pn))
    return padded.reshape(C_loc, n_shards, chunk).transpose(0, 1).contiguous()


def plane_chunk(vec: torch.Tensor, rank: int, n_shards: int) -> torch.Tensor:
    """Rank ``rank``'s column chunk of a replicated ``(P,)`` plane, aligned
    with ``cohort_to_columns``: a view at element ``rank·chunk`` of the
    plane padded to ``n·chunk`` (so any byte offset, not only 16-byte
    ones)."""
    chunk = -(-vec.shape[-1] // n_shards)
    padded = torch.nn.functional.pad(vec, (0, chunk * n_shards - vec.shape[-1]))
    return padded[rank * chunk:(rank + 1) * chunk]


def gather_plane(chunk: torch.Tensor, group, n_shards: int, size: int) -> torch.Tensor:
    """Inverse of ``plane_chunk``: all-gather the ranks' column chunks into
    the replicated ``(size,)`` plane (pad columns dropped)."""
    return gather_rows(chunk, group, n_shards)[:size]


def masked_mean(plane: torch.Tensor, w: torch.Tensor, n_active: torch.Tensor,
                agg_dtype=torch.float32) -> torch.Tensor:
    """Masked cohort mean ``(Σ_c w_c·plane_c) / max(n_active, 1)`` of a
    ``(C, P)`` plane as an f32 ``(P,)``, the reference's
    ``_masked_pmean``: plane and weights quantized to ``agg_dtype``, the
    products summed in f32 in ascending c, the sum rounded to
    ``agg_dtype``.  Each column's sum is its own, so a column block gives
    the same bits as the whole plane."""
    w = w.to(agg_dtype).to(torch.float32)
    acc = torch.zeros(plane.shape[-1], dtype=torch.float32, device=plane.device)
    for c in range(plane.shape[0]):
        acc = acc + w[c] * plane[c].to(agg_dtype).to(torch.float32)
    return acc.to(agg_dtype).to(torch.float32) / n_active.clamp(min=1.0)


def cohort_mean_scatter(plane: torch.Tensor, w: torch.Tensor, n_active: torch.Tensor, group,
                        n_shards: int, agg_dtype=torch.float32) -> torch.Tensor:
    """``masked_mean`` under cohort sharding, in each rank of ``group``:
    ``plane`` is this rank's ``(C_loc, P)`` rows, ``w`` the padded ``(C_pad,)``
    weights (zeros on pad rows).  ``cohort_to_columns`` gives the rank the
    whole cohort for its columns, the contraction runs there in the
    unsharded order, and ``gather_plane`` rebuilds the replicated ``(P,)``
    mean: bit for bit ``masked_mean`` of the whole padded plane."""
    cols = cohort_to_columns(plane, group, n_shards)
    return gather_plane(masked_mean(cols, w, n_active, agg_dtype), group, n_shards,
                        plane.shape[-1])


def ring_push(pending: Sequence[CohortUplink], entry: CohortUplink):
    """Append the just-launched ``entry`` and pop the oldest for folding.
    Returns ``(oldest, new_pending)``; ``pending`` holds D − 1 entries in
    launch order, so with D = 1 it is empty and the entry folds the round
    it launches (the sync schedule)."""
    fifo = (*pending, entry)
    return fifo[0], fifo[1:]
