"""Each rank's share of an LM's weights over a model group.

The rule of which dimension of which leaf a group splits is
``rules.split_dim`` (the reference's ``param_specs(..., mode="serve")``
along ``"model"``); rank r of N holds the r-th of N equal slices of it, or,
of a mamba2 leaf split by parts (``rules.Pieces``), its ranges of each part
joined.

``shard_params`` slices a whole tree (the port's own, or the reference's
parameters carried across by ``core.convert.params_from_numpy``).
``init_params_sharded`` draws a rank's share without the whole model: it
makes the same draws as ``transformer.init_params`` (``encdec.init_params``
for the encoder-decoder) from the same generator,
leaf by leaf, and keeps the rank's slice of each leaf as it is drawn, so the
share is bitwise that rank's slice of the unsharded draw while the rank
holds its share and at most one whole leaf.

    params = init_params_sharded(gen, cfg, rank, world, stage="cpu")

Training on a group (``rules.group_parts``): ``share_parts`` lists each
leaf's parts and uses in tree order, ``group_plane`` the same for a flat
plane over a rank's share (the federated engine's ``model_group``), and
``join_shares`` rebuilds whole leaves from every rank's share.

Training on a grid of ``data`` × ``model`` ranks (rank ``d·M + m``: model
rank m of data row d) stores the model share's FSDP slice: ``grid_take``
takes it (the model share, then the d-th of ``data`` slices along
``rules.fsdp_dim``), ``init_params_sharded(..., data=, data_rank=)`` draws
it, ``share_fsdp`` lists each leaf's FSDP dimension in tree order
(``fsdp_map``: by params-tree keys, for ``models.layers.fsdp_gather``), and
``join_shares(..., fsdp=, data=)`` rebuilds whole leaves from the grid's
shares.  ``snapshot_join`` / ``snapshot_take`` apply the two to the paths
of a ``{"params", "opt"}`` snapshot (``checkpoint.ckpt``).  Serving on a
grid takes shares in the layout's ``mode`` (``rules.fsdp_dim``):
``"train"``, FSDP storage, or ``"serve"``, the layout that keeps only the
``moe`` leaves' data slices (``Knobs.serve_params="replicated"``):
``grid_take``, ``init_params_sharded``, ``share_fsdp``, ``fsdp_map`` and
``snapshot_take`` take it, and ``share_bytes`` counts a rank's share of
either.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models import encdec, transformer
from repro_torch.sharding.rules import (
    Pieces, Split, _keys, check_model_parallel, fsdp_dim, group_parts, local_shape, split_dim,
)
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves, tree_map


def param_shapes(cfg) -> Any:
    """The params tree of ``cfg`` as ``meta`` tensors: the shapes and
    dtypes, nothing drawn and nothing allocated."""
    return _init(cfg)(torch.Generator(), cfg, device="meta")


def _init(cfg):
    return encdec.init_params if cfg.is_encoder_decoder else transformer.init_params


def take(leaf: torch.Tensor, dim: Split, rank: int, world: int, device=None) -> torch.Tensor:
    """Rank ``rank``'s slice of ``leaf`` along ``dim`` (the whole leaf when
    ``dim`` is None; its ranges of each part joined when ``dim`` is
    ``Pieces``), as a tensor of its own on ``device`` (default: the leaf's;
    a whole leaf already there is returned as it is).  A slice along a
    later dimension is copied a leading index at a time, so copying it to
    another device needs no whole-slice buffer beside the leaf.  Any other
    ``dim`` raises."""
    device = leaf.device if device is None else torch.device(device)
    if dim is None:
        return leaf.to(device)
    if isinstance(dim, Pieces):
        ranges = [(off + rank * (w // world), w // world) if sp else (off, w)
                  for off, w, sp in dim.parts]
        d = dim.dim
    elif isinstance(dim, int) and not isinstance(dim, bool):
        n = leaf.shape[dim] // world
        ranges, d = [(rank * n, n)], dim
    else:
        raise TypeError(f"no split rule of kind {dim!r}")
    out = torch.empty(local_shape(leaf.shape, dim, world), dtype=leaf.dtype, device=device)
    at = 0
    for off, w in ranges:
        part, dst = leaf.narrow(d, off, w), out.narrow(d, at, w)
        at += w
        if d == 0 or (part.is_contiguous() and dst.is_contiguous()):
            dst.copy_(part)
            continue
        for i in range(part.shape[0]):
            dst[i].copy_(part[i])
    return out


def shard_params(params: Any, specs: Any, rank: int, world: int) -> Any:
    """Rank ``rank``'s share of the whole tree ``params`` under ``specs``
    (``rules.param_specs(params, cfg, world)``)."""
    return tree_map(lambda leaf, dim: take(leaf, dim, rank, world), params, specs)


def grid_take(leaf: torch.Tensor, path: Sequence[str], cfg, rank: int, world: int,
              data_rank: int = 0, data: int = 1, device=None,
              mode: str = "train") -> torch.Tensor:
    """The share of the whole ``leaf`` at ``path`` that grid rank (``data_rank``,
    ``rank``) of a ``data`` × ``world`` grid stores in the layout ``mode``:
    the model share's ``data_rank``-th slice along ``rules.fsdp_dim`` (the
    model share itself where the leaf has none), on ``device``."""
    shape = tuple(leaf.shape)
    share = take(leaf, split_dim(path, shape, world, cfg), rank, world, device)
    return take(share, fsdp_dim(path, shape, data, world, cfg, mode), data_rank, data)


def init_params_sharded(generator: torch.Generator, cfg, rank: int, world: int,
                        stage: Optional[str] = None, *, data: int = 1,
                        data_rank: int = 0, mode: str = "train") -> Any:
    """Rank ``rank``'s share of ``transformer.init_params(generator, cfg)``
    (``encdec.init_params`` for the encoder-decoder), bitwise, drawn on the
    generator's device leaf by leaf; on a grid of ``data`` rows, data rank
    ``data_rank``'s slice of it in the layout ``mode`` (``grid_take``).  ``stage`` is a
    device where the kept slices wait until the last leaf is drawn (the
    host, so that a card holds one whole leaf at a time and never that
    leaf beside the share); the share is then moved to the generator's
    device.  Refuses an expert count the group does not divide
    (``rules.check_model_parallel``)."""
    check_model_parallel(cfg, world)

    def keep(path: Tuple[str, ...], leaf: torch.Tensor) -> torch.Tensor:
        return grid_take(leaf, path, cfg, rank, world, data_rank, data, stage, mode)

    params = _init(cfg)(generator, cfg, keep=keep)
    if stage is not None:
        params = tree_map(lambda t: t.to(generator.device), params)
    return params


def share_bytes(cfg, world: int, data: int = 1, mode: str = "train") -> int:
    """The bytes of one rank's share of ``cfg``'s params on a model group of
    ``world`` ranks (every rank's share is the same size; a mamba2 leaf's
    whole parts count on every rank), and on a grid of ``data`` such rows
    its slice in the layout ``mode``."""
    total = 0
    for p, leaf in tree_flatten_with_path(param_shapes(cfg))[0]:
        keys, shape = _keys(p), tuple(leaf.shape)
        local = list(local_shape(shape, split_dim(keys, shape, world, cfg), world))
        f = fsdp_dim(keys, shape, data, world, cfg, mode)
        if f is not None:
            local[f] //= data
        total += math.prod(local) * leaf.element_size()
    return total


# ------------------------------------------------------- training on a group
def share_parts(cfg, world: int) -> List:
    """``rules.group_parts`` of every leaf of ``cfg``'s params tree, in the
    tree's leaf order (the order of ``tree_leaves`` and of a ``FlatSpec``
    over a rank's share)."""
    return [group_parts(_keys(p), tuple(leaf.shape), world, cfg)
            for p, leaf in tree_flatten_with_path(param_shapes(cfg))[0]]


def share_fsdp(cfg, world: int, data: int, mode: str = "train") -> List[Optional[int]]:
    """``rules.fsdp_dim`` of every leaf of ``cfg``'s params tree on a grid of
    ``data`` × ``world`` ranks in the layout ``mode``, in the tree's leaf
    order."""
    return [fsdp_dim(_keys(p), tuple(leaf.shape), data, world, cfg, mode)
            for p, leaf in tree_flatten_with_path(param_shapes(cfg))[0]]


def fsdp_map(cfg, world: int, data: int, mode: str = "train") -> Dict[Tuple[str, ...], int]:
    """The leaves of ``cfg``'s params tree that a grid of ``data`` ×
    ``world`` ranks stores in data slices in the layout ``mode``:
    params-tree keys → ``rules.fsdp_dim``
    counted from the last dimension (negative), so that it names the same
    dimension in a stacked leaf and in one period's slice of it.  What
    ``models.layers.fsdp_gather`` gathers (``ParallelContext.fsdp``)."""
    out = {}
    for p, leaf in tree_flatten_with_path(param_shapes(cfg))[0]:
        keys, shape = _keys(p), tuple(leaf.shape)
        d = fsdp_dim(keys, shape, data, world, cfg, mode)
        if d is not None:
            out[keys] = d - len(shape)
    return out


def group_plane(spec, cfg, parallel):
    """The ``core.flat.GroupPlane`` of ``spec``, the ``FlatSpec`` of this
    rank's share of ``cfg``'s params on the model group ``parallel``."""
    from repro_torch.core.flat import GroupPlane

    flat = tree_flatten_with_path(param_shapes(cfg))[0]
    if len(flat) != len(spec.leaves):
        raise ValueError(f"the plane has {len(spec.leaves)} leaves, {cfg.name}'s params "
                         f"{len(flat)}")
    shapes = [t for _, t in flat]
    return GroupPlane(parallel, tuple(share_parts(cfg, parallel.size)),
                      sum(t.numel() for t in shapes),
                      sum(t.numel() * t.element_size() for t in shapes),
                      tuple(split_dim(_keys(p), tuple(t.shape), parallel.size, cfg)
                            for p, t in flat),
                      tuple(tuple(t.shape) for t in shapes))


def join_shares(shares: Sequence[torch.Tensor], dim: Split, world: int,
                fsdp: Optional[int] = None, data: int = 1) -> torch.Tensor:
    """The whole leaf from every rank's share of it (rank order), split by
    ``dim``: the inverse of ``take``.  A whole leaf is rank 0's.  On a grid
    (``data`` rows, ``fsdp`` the leaf's ``rules.fsdp_dim``) ``shares`` are
    the ``data × world`` grid ranks' in rank order ``d·world + m``: the
    inverse of ``grid_take``."""
    if data > 1:
        shares = [shares[m] if fsdp is None else
                  torch.cat([shares[d * world + m] for d in range(data)], dim=fsdp)
                  for m in range(world)]
    if dim is None:
        return shares[0]
    if not isinstance(dim, Pieces):
        return torch.cat(list(shares), dim=dim)
    pieces, at = [], 0
    for _, w, sp in dim.parts:
        width = w // world if sp else w
        pieces += ([s.narrow(dim.dim, at, width) for s in shares] if sp
                   else [shares[0].narrow(dim.dim, at, width)])
        at += width
    return torch.cat(pieces, dim=dim.dim)


# ------------------------------------------------------ snapshots of a group
def _param_keys(path: str, shapes) -> Optional[Tuple[str, ...]]:
    """The params-tree keys of a snapshot path (``params/…`` or an AdamW
    moment's ``opt/<i>/…``; ``checkpoint.ckpt``'s spelling), None for a leaf
    of no param's shape (the optimizer's step)."""
    parts = tuple(path.split("/"))
    for i in range(1, len(parts)):
        if parts[i:] in shapes:
            return parts[i:]
    return None


def _whole_shapes(cfg):
    return {_keys(p): tuple(t.shape) for p, t in tree_flatten_with_path(param_shapes(cfg))[0]}


def snapshot_join(cfg, world: int, data: int = 1):
    """``join(path, shares)`` for ``checkpoint.ckpt.save_checkpoint_shares``:
    the whole leaf of a ``{"params", "opt"}`` snapshot path from the shares
    of the ``data`` × ``world`` grid's ranks (``join_shares``); a leaf that
    is no param's (the step) is rank 0's."""
    shapes = _whole_shapes(cfg)

    def join(path: str, shares: Sequence[torch.Tensor]) -> torch.Tensor:
        keys = _param_keys(path, shapes)
        if keys is None:
            return shares[0]
        shape = shapes[keys]
        return join_shares(shares, split_dim(keys, shape, world, cfg), world,
                           fsdp_dim(keys, shape, data, world, cfg), data)

    return join


def snapshot_take(cfg, rank: int, world: int, data_rank: int = 0, data: int = 1,
                  mode: str = "train"):
    """``take(path, whole)`` for ``checkpoint.ckpt.load_checkpoint``: grid
    rank (``data_rank``, ``rank``)'s share of a snapshot's whole leaf in the
    layout ``mode`` (``grid_take``); a leaf that is no param's as it is."""
    shapes = _whole_shapes(cfg)

    def take_share(path: str, whole: torch.Tensor) -> torch.Tensor:
        keys = _param_keys(path, shapes)
        if keys is None:
            return whole
        return grid_take(whole, keys, cfg, rank, world, data_rank, data, mode=mode)

    return take_share
