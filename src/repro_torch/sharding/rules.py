"""Layout rules over a ``torch.distributed`` group: the cohort's and the model's.

Counterpart of ``repro.sharding.rules``.  The cohort part
(``padded_cohort``, ``cohort_axis_size``): where the reference shards the
cohort over a ``("clients",)`` mesh axis, the port shards it over the ranks
of a process group, one process a shard; rank r owns rows ``[r·C_loc,
(r+1)·C_loc)`` of the padded cohort.

The model part (``param_specs``, ``split_dim``): the ``"model"``-axis half
of the reference's ``param_specs(..., mode="serve")``.  Each leaf is split
along at most one dimension over the ranks of a model group, rank r holding
the r-th of N equal slices, under the reference's divisibility guard (a
dimension that N does not divide stays whole).  The mamba2 leaves whose
last dimension packs several parts (``w_in``: z, x, B, C, dt; ``conv_w`` /
``conv_b``: x, B, C) are split part by part (``Pieces``), so that a rank
holds whole SSD heads.

The data part (``fsdp_dim``): the reference's storage over its data axes.
On a grid of data × model ranks (``launch.mesh.make_grid``) each large
leaf's model share is split once more over the data group, along the
dimension the reference's helper ``f`` names — ``d_model`` of every leaf
it catches — under the same divisibility guard.  ``mode="train"`` (FSDP
storage: training's layout, and serving's by default) catches every such
leaf; ``mode="serve"`` (``Knobs.serve_params="replicated"``) only the
leaves under ``moe`` — the expert banks, whose replicated copies would
not fit a card — and replicates the rest over data.  The training batch
is split over data as ``batch_specs`` splits it (each data rank its block
of rows).

Serving on a grid (``serve_splits_batch``, ``row_block``, ``seq_slab``)
follows the reference's ``batch_specs`` / ``cache_specs``: where the data
group's size D divides the batch B, each data rank serves its block of
rows and caches them; where it does not (long_500k's B = 1), every data
rank serves the whole batch and holds a contiguous slab ``[d·S/D,
(d+1)·S/D)`` of every attention cache's sequence (self and cross K/V).
One route difference: the reference puts the sequence over its data axes
and ``"model"`` together and leaves the heads whole, while the port keeps
the model group's head split and puts the sequence over the data group
only.  At M = 1 the two are one layout; at any M the values are the same,
and so are the bytes a rank holds wherever M divides the kv heads.

Training on a group reads one more answer a leaf (``group_use``,
``group_parts``): split (each rank holds and reads its slice), whole
(every rank holds and reads all of it: the whole gradient on every rank),
or partial (every rank holds all of it but reads a part, so each rank's
gradient is partial and the ranks' are summed).  Over the data group a
leaf is either held in part (``fsdp_dim`` not None: its gradient is
reduce-scattered where the model gathers it) or replicated (its data
ranks' gradients are averaged, ``sum_over_data``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.utils.trees import tree_flatten_with_path, tree_unflatten


def cohort_axis_size(group) -> int:
    """Validate a cohort process group and return its size (the number of
    shards).  ``group`` is a ``torch.distributed`` process group of this
    process (``dist.group.WORLD`` for the default one)."""
    if not dist.is_initialized():
        raise ValueError("the cohort-parallel engine needs an initialized process group; "
                         "start the ranks with repro_torch.launch.mesh.spawn_cohort "
                         "(CLI: --cohort-shard N)")
    if group is None or dist.get_rank(group) < 0:
        raise ValueError(f"this process is not a member of the cohort group {group!r}")
    return dist.get_world_size(group)


def padded_cohort(capacity: int, n_shards: int) -> int:
    """The padded cohort length: ``capacity`` rounded up to a multiple of
    ``n_shards`` so every rank owns the same number of rows.  Pad rows carry
    zero fold weight (``repro_torch.core.flat.pad_cohort``)."""
    return -(-capacity // n_shards) * n_shards


# ------------------------------------------------------------- the model group
@dataclass(frozen=True)
class Pieces:
    """A leaf split part by part along ``dim``: ``parts`` are ``(offset,
    width, split)`` ranges of that dimension, in order and back to back.
    Rank r of N holds, of each part, the r-th of N slices when ``split``,
    else the whole part, joined in the parts' order."""

    dim: int
    parts: Tuple[Tuple[int, int, bool], ...]

    def width(self, world: int) -> int:
        """The joined width of one rank's ranges."""
        return sum(w // world if sp else w for _, w, sp in self.parts)


# The mamba2 leaves the reference splits over "model".  w_out (…, d_inner,
# D) and norm_z (…, d_inner) split over d_inner as there; w_in's output packs
# [z | x | B | C | dt] and the conv runs over [x | B | C], so those are split
# by parts (``mamba_split``), where the reference splits plain columns.
MAMBA_SPLIT_KEYS = ("w_in", "w_out", "conv_w", "conv_b", "norm_z")
Split = Union[int, None, Pieces]


def _ok(dim: int, size: int) -> bool:
    """The reference's divisibility guard."""
    return dim % size == 0 and dim >= size


def split_dim(path: Sequence[str], shape: Sequence[int], world: int, cfg=None) -> Split:
    """The dimension of the leaf at ``path`` (its dict keys) and of
    ``shape`` that a model group of ``world`` ranks splits, None when the
    leaf stays whole, or the ``Pieces`` of a packed mamba2 leaf (whose
    split reads ``cfg``: ``mamba_split``).
    The rule is the reference's, key by key: ``embed`` (V, D) and
    ``unembed`` (D, V) over V; ``wq`` / ``wk`` / ``wv`` (…, D, H, hd) and
    ``wo`` (…, H, hd, D) over their heads; a dense MLP's ``w_gate`` /
    ``w_up`` (…, D, F) and ``w_down`` (…, F, D) over F; an expert bank's
    ``w_*`` (…, E, ·, ·) over E; the mamba2 leaves over the SSD heads; the
    router and everything else whole (mamba2's ``A_log``, ``D_skip`` and
    ``dt_bias`` too: the block reads its heads' entries).

    One leaf differs from the reference on purpose: the shared expert's MLP
    under ``moe`` (maverick).  The reference's rule catches it with the
    expert banks (``"moe" in path``), and for its 3-d stacked leaves that
    splits the periods axis, a storage layout GSPMD gathers back a layer at
    a time; here it is split over F like every MLP, since it runs as the
    group's MLP (ROADMAP queue C)."""
    key = path[-1] if path else ""
    nd = len(shape)

    def m(i: int) -> Optional[int]:
        return i if _ok(shape[i], world) else None

    if key in MAMBA_SPLIT_KEYS:
        return mamba_split(key, nd, world, cfg)
    if key == "embed":
        return m(0)
    if key == "unembed":
        return m(1)
    if key in ("wq", "wk", "wv"):
        return m(nd - 2)
    if key == "wo":
        return m(nd - 3)
    bank = "moe" in path and "shared" not in path
    if key in ("w_gate", "w_up"):
        return m(nd - 3) if bank else m(nd - 1)
    if key == "w_down":
        return m(nd - 3) if bank else m(nd - 2)
    return None


def mamba_split(key: str, nd: int, world: int, cfg) -> Split:
    """The split of the mamba2 leaf ``key`` (``nd`` dimensions) over
    ``world`` ranks: none when ``world`` does not divide ``cfg.ssm_heads``
    (the block then runs whole on every rank); else rank r takes heads
    ``[r·H/N, (r+1)·H/N)``: their d_inner rows of ``w_out`` and entries of
    ``norm_z``, their z, x and dt columns of ``w_in`` and x channels of
    ``conv_w`` / ``conv_b``, with B's and C's N columns each whole."""
    if cfg is None:
        raise ValueError(f"the split of mamba2's {key} reads the config's widths: pass cfg")
    if not _ok(cfg.ssm_heads, world):
        return None
    if key == "w_out":
        return nd - 2
    if key == "norm_z":
        return nd - 1
    d_inner, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    if key == "w_in":  # [z | x | B, C | dt]
        return Pieces(nd - 1, ((0, d_inner, True), (d_inner, d_inner, True),
                               (2 * d_inner, 2 * N, False),
                               (2 * d_inner + 2 * N, cfg.ssm_heads, True)))
    return Pieces(nd - 1, ((0, d_inner, True), (d_inner, 2 * N, False)))  # [x | B, C]


def local_shape(shape: Sequence[int], dim: Split, world: int) -> Tuple[int, ...]:
    """The shape of one rank's share of a leaf of ``shape`` split by ``dim``."""
    out = list(shape)
    if isinstance(dim, Pieces):
        out[dim.dim] = dim.width(world)
    elif dim is not None:
        out[dim] //= world
    return tuple(out)


def _keys(path: str) -> Tuple[str, ...]:
    """``['periods']['slot0']['attn']['wq']`` → ``("periods", "slot0", "attn", "wq")``."""
    return tuple(part.strip("'\"") for part in path[1:-1].split("][")) if path else ()


def param_specs(params: Any, cfg, world: int) -> Any:
    """The tree of ``split_dim`` for every leaf of ``params`` (tensors, or
    ``meta`` tensors of the shapes alone), for a model group of ``world``
    ranks.  ``cfg`` is the config the tree was built from (the mamba2
    leaves' split reads its widths)."""
    leaves, treedef = tree_flatten_with_path(params)
    return tree_unflatten(treedef, [split_dim(_keys(p), tuple(leaf.shape), world, cfg)
                                    for p, leaf in leaves])


def fsdp_axis(path: Sequence[str], nd: int) -> Optional[int]:
    """The dimension of an ``nd``-dimensional leaf at ``path`` that the
    reference's train-mode helper ``f`` shards over its data axes, before
    its divisibility guard: ``D`` of ``embed`` (V, D) and ``unembed`` (D,
    V), of ``wq`` / ``wk`` / ``wv`` (…, D, H, hd), ``wo`` (…, H, hd, D),
    ``router`` (…, D, E), the dense and MoE ``w_gate`` / ``w_up`` (…, D, F)
    / (…, E, D, F) and ``w_down`` (…, F, D) / (…, E, F, D), and mamba2's
    ``w_in`` (…, D, ·) and ``w_out`` (…, d_inner, D); None for conv, norms,
    biases and the small leaves.  The same index in a period's leaf (the
    stacked leaf less its leading axis) but for ``embed`` / ``unembed``,
    which are not stacked."""
    key = path[-1] if path else ""
    if key in ("embed", "unembed"):
        return 1 if key == "embed" else 0
    if key in ("wq", "wk", "wv"):
        return nd - 3
    if key in ("wo", "w_down", "w_out"):
        return nd - 1
    if key in ("router", "w_gate", "w_up", "w_in"):
        return nd - 2
    return None


PARAM_MODES = ("train", "serve")


def fsdp_dim(path: Sequence[str], shape: Sequence[int], data: int, model: int = 1,
             cfg=None, mode: str = "train") -> Optional[int]:
    """The dimension of the leaf at ``path`` (whole ``shape``) that a data
    group of ``data`` ranks splits, on the leaf's share of a model group of
    ``model``: ``fsdp_axis``'s, under the reference's divisibility guard;
    None when ``data`` is 1, for the leaves ``f`` does not catch, where
    ``data`` does not divide the dimension, and in ``mode="serve"`` for
    every leaf whose path holds no ``moe`` (the reference's ``f`` reads
    ``"moe" not in pstr``: the expert banks, the router and a shared expert
    under ``moe`` keep their slices).  The model group never splits that
    dimension, so the guard reads the whole leaf's size of it."""
    if mode not in PARAM_MODES:
        raise ValueError(f"param layout mode must be one of {PARAM_MODES}, got {mode!r}")
    dim = fsdp_axis(path, len(shape))
    if dim is None or data <= 1:
        return None
    if mode == "serve" and not any("moe" in k for k in path):
        return None
    local = local_shape(shape, split_dim(path, shape, model, cfg), model) if model > 1 \
        else tuple(shape)
    return dim if _ok(local[dim], data) else None


# ----------------------------------------------------------- serving on a grid
def serve_splits_batch(batch: int, data: int) -> bool:
    """Whether a data group of ``data`` ranks splits a served batch of
    ``batch`` rows over its ranks (``data`` divides it: each data rank
    serves and caches its block of rows), or else the caches' sequence
    (every data rank serves every row and holds a slab of each attention
    cache): the reference's ``B % fsdp_size == 0`` test."""
    if batch < 1 or data < 1:
        raise ValueError(f"a batch of {batch} rows on a data group of {data} ranks")
    return batch % data == 0


def row_block(batch: int, data: int, data_rank: int) -> Tuple[int, int]:
    """``(start, rows)`` of data rank ``data_rank``'s block of a batch of
    ``batch`` rows that ``data`` ranks split: ``[d·B/D, (d+1)·B/D)``."""
    if batch % data:
        raise ValueError(f"a batch of {batch} rows does not split over {data} data ranks")
    n = batch // data
    return data_rank * n, n


def seq_slab(length: int, data: int, data_rank: int) -> Tuple[int, int]:
    """``(start, length)`` of data rank ``data_rank``'s contiguous slab of a
    cache sequence of ``length`` positions that ``data`` ranks split:
    ``[d·S/D, (d+1)·S/D)``.  Refuses a length that ``data`` does not
    divide, as the reference's shard-local cache write needs too."""
    if length % data:
        raise ValueError(f"a cache of {length} positions does not split into {data} equal "
                         f"slabs over the data group: make its length a multiple of {data}")
    n = length // data
    return data_rank * n, n


def check_model_parallel(cfg, world: int) -> None:
    """Refuse an expert count that a model group of ``world`` > 1 ranks does
    not divide (the reference's expert-parallel MoE asserts the same)."""
    if world > 1 and cfg.n_experts and cfg.n_experts % world:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not split over a model "
                         f"group of {world}")


# ------------------------------------------------------- training on a group
GROUP_USES = ("split", "whole", "partial")
# (offset, width, use) of a part of a rank's share along the part dimension
GroupPart = Tuple[int, int, str]


def group_use(path: Sequence[str], shape: Sequence[int], world: int, cfg) -> str:
    """How the ranks of a model group of ``world`` use the leaf at ``path``
    (its whole ``shape``): ``"split"`` when ``split_dim`` splits it (a
    mamba2 leaf split by parts: its split parts; its whole parts are
    ``"partial"``, ``group_parts``); of the leaves kept whole,
    ``"partial"`` where a rank reads only its part — ``wk`` / ``wv`` (a
    rank's q heads read some kv heads) and the QK-norms' scales (applied to
    a rank's heads) when the heads split, mamba2's ``A_log`` / ``D_skip`` /
    ``dt_bias`` (a rank's SSD heads' entries) when the SSD heads split, and
    the MoE router (each rank's gates weigh its experts' outputs, and it
    adds 1/N of the load-balance loss's gradient) when the experts split;
    ``"whole"`` for every other leaf: norms, biases and the leaves of a
    layer that runs whole on every rank."""
    if split_dim(path, shape, world, cfg) is not None:
        return "split"
    key = path[-1] if path else ""
    if key in ("wk", "wv", "q_norm", "k_norm"):
        return "partial" if _ok(cfg.n_heads, world) else "whole"
    if key in ("A_log", "D_skip", "dt_bias"):
        return "partial" if cfg.ssm_heads and _ok(cfg.ssm_heads, world) else "whole"
    if key == "router":
        return "partial" if cfg.n_experts and _ok(cfg.n_experts, world) else "whole"
    return "whole"


def group_parts(path: Sequence[str], shape: Sequence[int], world: int, cfg
                ) -> Tuple[Optional[int], Tuple[GroupPart, ...]]:
    """A rank's share of the leaf at ``path`` (whole ``shape``) as ``(dim,
    parts)``: a mamba2 leaf split by ``Pieces`` has one part a piece along
    ``dim`` of its share, the split pieces ``"split"`` and the whole ones
    (B's and C's columns, read by every rank's heads) ``"partial"``; any
    other leaf is one part, the whole share (``dim`` None), of its
    ``group_use``."""
    dim = split_dim(path, shape, world, cfg)
    if isinstance(dim, Pieces):
        parts, at = [], 0
        for _, w, sp in dim.parts:
            width = w // world if sp else w
            parts.append((at, width, "split" if sp else "partial"))
            at += width
        return dim.dim, tuple(parts)
    return None, ((0, 0, group_use(path, shape, world, cfg)),)


def _segments(t: torch.Tensor, parts, use: str, lead: int):
    dim, pieces = parts
    for off, width, u in pieces:
        if u == use:
            yield t if dim is None else t.narrow(lead + dim, off, width)


def _all_reduce_segments(segs, reduce) -> None:
    """``reduce`` (an in-place ``all_reduce``) of the tensors ``segs``, one
    call a dtype over their concatenation, written back into each."""
    by_dtype = {}
    for seg in segs:
        by_dtype.setdefault(seg.dtype, []).append(seg)
    for segs in by_dtype.values():
        flat = torch.cat([seg.reshape(-1) for seg in segs])
        reduce(flat)
        at = 0
        for seg in segs:
            seg.copy_(flat[at:at + seg.numel()].view(seg.shape))
            at += seg.numel()


def sum_partial(tensors, parts, parallel, lead: int = 0) -> None:
    """Sum over the group, in place, the ``"partial"`` parts of each of
    ``tensors`` (a rank's gradients, in the order of ``parts``; ``lead``
    leading batch dims before each leaf's own), one ``all_reduce`` a
    dtype."""
    _all_reduce_segments([seg for t, p in zip(tensors, parts)
                          for seg in _segments(t, p, "partial", lead)], parallel.all_reduce)


def sum_over_data(tensors, fsdp, parallel) -> None:
    """Sum over the data group, in place, each of ``tensors`` (a rank's
    gradients, in the order of ``fsdp``: each leaf's ``fsdp_dim``) that the
    data group replicates, one ``all_reduce`` a dtype.  The leaves it holds
    in part had theirs reduce-scattered where the model gathered them."""
    _all_reduce_segments([t for t, f in zip(tensors, fsdp) if f is None],
                         parallel.data_all_reduce)


def group_sq_norm(tensors, parts, parallel, fsdp: Optional[Sequence] = None,
                  lead: int = 0) -> torch.Tensor:
    """The f32 squared L2 norm of the whole tree whose shares ``tensors``
    are (each rank passes its own, in the order of ``parts``): the split
    parts summed over the group, every replicated part (whole or partial,
    the same on every rank) counted once, on rank 0, so that no part is
    counted N times and no 1/N enters.  On a grid (``fsdp``: each leaf's
    ``fsdp_dim``) the same over the data group: a leaf held in part there is
    summed over it, a replicated one counted on data rank 0 alone.  With
    ``lead`` leading batch dims before each leaf's own (a cohort's rows),
    one norm for each index of them: shape ``tensors[0].shape[:lead]``."""
    uses = ("split",) if parallel.rank else GROUP_USES
    fsdp = fsdp or [None] * len(parts)
    rows = tuple(tensors[0].shape[:lead])
    total = torch.zeros(rows, dtype=torch.float32, device=tensors[0].device)
    for t, p, f in zip(tensors, parts, fsdp):
        if f is None and parallel.data_rank:
            continue
        for use in uses:
            for seg in _segments(t, p, use, lead):
                sq = torch.square(seg.to(torch.float32))
                total = total + (torch.sum(sq) if not lead else sq.reshape(*rows, -1).sum(-1))
    total = parallel.all_reduce(total)
    return parallel.data_all_reduce(total) if parallel.data_size > 1 else total
