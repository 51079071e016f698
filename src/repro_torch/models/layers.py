"""Layers (counterpart of ``repro.models.layers``): the initializers, norms,
rotary embeddings, self- and cross-attention, the MLPs (gated SiLU and tanh
GELU) and the capacity-based mixture of experts, as plain functions over
dict param trees with the reference's keys and layouts.

Conventions as in the reference: activations ``(B, S, D)``, attention heads
``(B, S, H, hd)``; norms and softmax compute in f32 whatever the activation
dtype; every weight is cast to the activation dtype where it is used.
Prefill attention with ``use_kernels`` goes through the flash-attention
kernel (``repro_torch.kernels.flash_attention``), which has no backward;
without it, and always in training, it takes the reference's plain route:
``attend_direct`` (a materialized score matrix) below
``BLOCKED_ATTENTION_THRESHOLD`` tokens and ``attend_blocked`` (online
softmax over blocks) at or above it.  Decode and cross-attention with one
query attend with plain PyTorch ops, as the reference does.

Every layer takes ``parallel`` (a ``ParallelContext`` or None), the
reference's model-axis branches on a ``torch.distributed`` group: each rank
holds its share of the weights (``repro_torch.sharding``) — its heads of
attention, its columns of the MLP's hidden layer, its experts — and one
``all_reduce`` of the layer's output sums the shares.  A leaf that the
group's size does not divide stays whole on every rank, and its layer then
runs whole, with no collective.  ``parallel=None`` is the unsharded model.

Training on a group: every rank computes the same loss from the same
(replicated) activations.  Where grad is enabled the group's collectives
are differentiable (``ParallelContext.sum`` / ``join`` / ``copy_in``): a
layer's input enters its rank-split work through ``copy_in`` (identity
forward; backward sums the ranks' partial input gradients) and leaves it
through ``sum`` (the ``all_reduce``; backward identity), so each rank gets
the whole gradient of every replicated activation and of every leaf it
reads whole, and its own slice's gradient of every split leaf.  A leaf
kept whole that a rank reads only in part (``sharding.rules.group_use``:
"partial") gets a partial gradient on each rank, which the train step sums
over the group.  ``torch.distributed.nn.functional.all_reduce`` is not
used: its backward sums the gradient, which under a replicated loss
multiplies every gradient upstream of it by the group's size.

A grid (``ParallelContext.data_group``, the reference's ``("data",
"model")`` mesh) adds a data group to the model group.  The layers do not
see it: in training each rank stores its FSDP slice of its model share
(``sharding.rules.fsdp_dim``, listed on ``ParallelContext.fsdp``), and the
model gathers a period's slices into the model share where its stack
selects the period, and ``embed`` / ``unembed`` where it reads them
(``fsdp_gather``: forward an ``all_gather`` over the data group, backward
the reduce-scatter of the gradient, so each rank keeps its slice's).
Under ``remat`` the gather lies inside the checkpointed region, so it is
redone in backward and never saved; under ``remat="none"`` autograd keeps
each period's gathered weights for its backward, so a step holds the
whole model share and FSDP saves no memory.

Serving on a grid (the reference's ``batch_specs`` / ``cache_specs``,
``sharding.rules.serve_splits_batch``): where the data group divides the
batch each data row serves its block of rows and the layers see nothing
new.  Where it does not (long_500k's B = 1, ``ParallelContext.seq_split``)
every data rank serves the whole batch on the same activations and holds a
contiguous slab of each attention cache's sequence (``cache_extent``).  A
decode step writes the token's K/V only on the rank whose slab holds its
position (the reference's shard-local ``_cache_write_shardmap``), and the
attention over the cache combines the slabs' partial softmaxes over the
data group (``attend_slabs``: an ``all_reduce`` of the max, then of the
sums and of the outputs), which gives every data rank the same values;
the cross-attention over a source sequence split so does the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.sharding.rules import _keys, row_block, seq_slab
from repro_torch.utils.trees import tree_flatten_with_path, tree_unflatten


# ------------------------------------------------------------ parallel context
@dataclass(frozen=True)
class ParallelContext:
    """The model group (the reference's mesh with its ``"model"`` axis): a
    ``torch.distributed`` process group, this process's rank in it and its
    size.  ``counts`` tallies the collectives the layers issue
    (``all_reduce``, ``all_gather``), the bytes each rank sends into them,
    and the mamba2 blocks that ran whole on every rank because the group's
    size does not divide their heads (``mamba_whole``); on a grid also the
    FSDP gathers over the data group and their gradients' reduce-scatters
    (``data_all_gather``, ``data_reduce_scatter``), and the ``all_reduce``s
    over it (``data_all_reduce``: training's gradient and loss sums, and
    serving's combine of a cache's slabs)."""

    group: Any
    rank: int
    size: int
    # the grid's data group (``launch.mesh.make_grid``): None, rank 0 and
    # size 1 off a grid
    data_group: Any = None
    data_rank: int = 0
    data_size: int = 1
    # on a grid, the params-tree keys of the leaves stored in FSDP slices
    # → the sliced dimension counted from the last (``sharding.shard.fsdp_map``)
    fsdp: Optional[Dict[Tuple[str, ...], int]] = field(default=None, compare=False)
    # serving on a grid whose data group does not divide the batch
    # (``sharding.rules.serve_splits_batch``): every data rank serves the
    # whole batch and holds slab ``data_rank`` of each attention cache's
    # sequence (``slab_start``); False where the data group splits the batch
    seq_split: bool = False
    counts: Dict[str, int] = field(default_factory=lambda: {
        "all_reduce": 0, "all_gather": 0, "bytes": 0, "mamba_whole": 0, "data_all_gather": 0,
        "data_reduce_scatter": 0, "data_all_reduce": 0}, compare=False)

    def data_all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The reduction ``op`` (a sum by default) over the data group, in
        ``x``'s dtype, written into ``x``."""
        self.counts["data_all_reduce"] += 1
        dist.all_reduce(x, op=op, group=self.data_group)
        return x

    def slab_start(self, length: int) -> int:
        """The first position of this rank's slab of a cache sequence whose
        slab holds ``length`` positions: ``data_rank · length`` where the
        data group splits the sequence, else 0 (the rank holds it all)."""
        return self.data_rank * length if self.seq_split else 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group, in ``x``'s dtype, written into ``x``."""
        self.counts["all_reduce"] += 1
        self.counts["bytes"] += x.numel() * x.element_size()
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` joined along ``dim`` in rank order."""
        self.counts["all_gather"] += 1
        self.counts["bytes"] += x.numel() * x.element_size()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    # The differentiable forms, taken where ``x`` carries a gradient; with
    # no gradient (serving) ``sum`` and ``join`` are the calls above and
    # ``copy_in`` is nothing, so serving's collectives and counts are as
    # they were.
    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group of the ranks' partial ``x`` (forward
        ``all_reduce``, backward identity: the sum's gradient is each
        part's).  Written into ``x`` when it carries no gradient."""
        if _tracks(x):
            return _SumOverGroup.apply(x, self)
        return self.all_reduce(x)

    def join(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` joined along ``dim`` (forward ``all_gather``,
        backward this rank's slice of the gradient)."""
        if _tracks(x):
            return _JoinOverGroup.apply(x, self, dim)
        return self.all_gather(x, dim)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated ``x`` entering rank-split work (forward identity,
        backward the ``all_reduce`` of the ranks' partial gradients)."""
        if _tracks(x):
            return _CopyIntoGroup.apply(x, self)
        return x


def _tracks(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, parallel):
        return parallel.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _JoinOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, parallel, dim):
        ctx.rank, ctx.dim, ctx.width = parallel.rank, dim, x.shape[dim]
        return parallel.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width).contiguous(), None, None


class _CopyIntoGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, parallel):
        ctx.parallel = parallel
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.parallel.all_reduce(g.clone(memory_format=torch.contiguous_format)), None


# ------------------------------------------------------------- FSDP on a grid
def _cat_flat(ts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts])


def _data_gather(parallel: ParallelContext, shares, dims):
    """Every data rank's slice of each of ``shares`` (one dtype) joined
    along its dim of ``dims``, in one ``all_gather``."""
    parallel.counts["data_all_gather"] += 1
    flat = _cat_flat(shares)
    parts = [torch.empty_like(flat) for _ in range(parallel.data_size)]
    dist.all_gather(parts, flat, group=parallel.data_group)
    del flat  # a serving step's expert banks: one copy of the slices fewer at the peak
    out, at = [], 0
    for s, d in zip(shares, dims):
        n = s.numel()
        out.append(torch.cat([p[at:at + n].view(s.shape) for p in parts], dim=d))
        at += n
    return out


def _data_reduce_scatter(parallel: ParallelContext, grads, dims):
    """This rank's slice of the sum over the data group of each of
    ``grads`` (one dtype; the gathered leaves' gradients) along its dim, in
    one collective: ``reduce_scatter_tensor``, but on gloo, which has none,
    an ``all_reduce`` of every rank's block and this rank's block of it.
    Both sum in a fixed order."""
    parallel.counts["data_reduce_scatter"] += 1
    n_d, r = parallel.data_size, parallel.data_rank
    blocks = [_cat_flat([g.narrow(d, i * (g.shape[d] // n_d), g.shape[d] // n_d)
                         for g, d in zip(grads, dims)]) for i in range(n_d)]
    if dist.get_backend(parallel.data_group) == "gloo":
        every = torch.cat(blocks)
        dist.all_reduce(every, group=parallel.data_group)
        mine = every.view(n_d, -1)[r]
    else:
        mine = torch.empty_like(blocks[0])
        dist.reduce_scatter_tensor(mine, torch.cat(blocks), group=parallel.data_group)
    out, at = [], 0
    for g, d in zip(grads, dims):
        shape = list(g.shape)
        shape[d] //= n_d
        n = math.prod(shape)
        out.append(mine[at:at + n].view(shape).clone())
        at += n
    return out


class _GatherOverData(torch.autograd.Function):
    """Forward: the data group's slices of each share joined (one
    ``all_gather`` a dtype); backward: the reduce-scatter of the gradients
    (one a dtype), each rank its slice's."""

    @staticmethod
    def forward(ctx, parallel, dims, *shares):
        ctx.parallel, ctx.dims = parallel, dims
        out = [None] * len(shares)
        for idx in _by_dtype(shares):
            for i, t in zip(idx, _data_gather(parallel, [shares[i] for i in idx],
                                              [dims[i] for i in idx])):
                out[i] = t
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        parallel, dims = ctx.parallel, ctx.dims
        out = [None] * len(grads)
        for idx in _by_dtype(grads):
            for i, g in zip(idx, _data_reduce_scatter(parallel, [grads[i] for i in idx],
                                                      [dims[i] for i in idx])):
                out[i] = g
        return (None, None, *out)


def _by_dtype(ts) -> List[List[int]]:
    groups: Dict[Any, List[int]] = {}
    for i, t in enumerate(ts):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


def fsdp_gather(tree, parallel: Optional[ParallelContext], at: Tuple[str, ...] = ()):
    """``tree`` (a period's params, a layer's, or ``{"embed": …}``; ``at``
    its keys in the params tree) with every leaf that this rank holds an
    FSDP slice of (``parallel.fsdp``) gathered into its model share over the
    data group (``_GatherOverData``: one ``all_gather`` a dtype, and in
    backward one reduce-scatter); as it is off a grid."""
    if parallel is None or parallel.data_size == 1:
        return tree
    if parallel.fsdp is None:
        raise ValueError("a grid's ParallelContext needs the map of its FSDP leaves "
                         "(launch.steps.make_parallel(..., cfg=))")
    leaves, treedef = tree_flatten_with_path(tree)
    picks, dims = [], []
    for i, (path, t) in enumerate(leaves):
        d = parallel.fsdp.get(at + _keys(path))
        if d is not None:
            picks.append(i)
            dims.append(t.dim() + d)
    if not picks:
        return tree
    vals = [t for _, t in leaves]
    for i, t in zip(picks, _GatherOverData.apply(parallel, tuple(dims),
                                                 *[vals[i] for i in picks])):
        vals[i] = t
    return tree_unflatten(treedef, vals)


def cache_extent(batch: int, length: int, parallel: Optional[ParallelContext]
                 ) -> Tuple[int, int]:
    """``(rows, positions)`` of the cache this rank holds for a served batch
    of ``batch`` rows and a cache sequence of ``length`` positions: all of
    both off a grid; on one, its block of rows where the data group splits
    the batch, or every row and its slab of the sequence where it does not
    (``ParallelContext.seq_split``; ``sharding.rules.row_block`` /
    ``seq_slab``, which refuse what the data group does not divide)."""
    if parallel is None or parallel.data_size == 1:
        return batch, length
    if parallel.seq_split:
        return batch, seq_slab(length, parallel.data_size, parallel.data_rank)[1]
    return row_block(batch, parallel.data_size, parallel.data_rank)[1], length


def seq_split(parallel: Optional[ParallelContext]) -> bool:
    """Whether ``parallel``'s data group splits the caches' sequence."""
    return parallel is not None and parallel.seq_split and parallel.data_size > 1


def split(parallel: Optional[ParallelContext], local: int, whole: int) -> bool:
    """Whether a dimension of ``whole`` entries that this rank holds
    ``local`` of is split over the group (else it is whole on every rank)."""
    return parallel is not None and local != whole


def into_heads(x: torch.Tensor, wq: torch.Tensor, cfg,
               parallel: Optional[ParallelContext]) -> torch.Tensor:
    """``x`` as it enters an attention whose q heads (``wq`` (…, D, H, hd),
    this rank's) may be split over the group: ``copy_in`` when they are."""
    return parallel.copy_in(x) if split(parallel, wq.shape[-2], cfg.n_heads) else x


def kv_heads_used(cfg, parallel: Optional[ParallelContext]) -> Optional[List[int]]:
    """The kv heads this rank's q heads read when the q heads are split
    over the group but ``n_kv_heads`` is not (the divisibility guard keeps
    ``wk`` / ``wv`` whole): q head h reads kv head h // (H / Hkv).  When
    each of those kv heads serves as many local q heads as the next, they
    are the local GQA groups; otherwise each local q head gets its own
    copy of its kv head (MHA).  None when nothing needs picking."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if parallel is None or H % parallel.size or Hkv % parallel.size == 0:
        return None
    h_loc = H // parallel.size
    used = [(parallel.rank * h_loc + j) // (H // Hkv) for j in range(h_loc)]
    uniq = sorted(set(used))
    return uniq if h_loc % len(uniq) == 0 and all(
        used.count(u) == h_loc // len(uniq) for u in uniq) else used


def kv_heads_of(cfg, parallel: Optional[ParallelContext]) -> List[int]:
    """The model's kv heads that this rank's attention (and its decode
    cache) holds, in order: ``kv_heads_used``'s pick, the rank's block of
    ``n_kv_heads / N`` when they split with the q heads, else all."""
    used = kv_heads_used(cfg, parallel)
    if used is not None:
        return used
    Hkv = cfg.n_kv_heads
    if parallel is None or cfg.n_heads % parallel.size:
        return list(range(Hkv))
    n = Hkv // parallel.size
    return list(range(parallel.rank * n, (parallel.rank + 1) * n))


def pick_kv_heads(t: torch.Tensor, cfg, parallel: Optional[ParallelContext]) -> torch.Tensor:
    """K or V ``(B, S, Hkv, hd)`` at the kv heads this rank's q heads read
    (``kv_heads_used``), or as it is when nothing needs picking."""
    used = kv_heads_used(cfg, parallel)
    if used is None:
        return t
    return t.index_select(2, torch.tensor(used, device=t.device))


def heads_out(a: torch.Tensor, wo: torch.Tensor, cfg,
              parallel: Optional[ParallelContext]) -> torch.Tensor:
    """Attention heads ``a`` (B, S, H, hd) through ``wo`` (H, hd, D): over a
    group the rank's heads through its rows of ``wo``, and one
    ``all_reduce`` sums the partial outputs when the heads split."""
    B, S = a.shape[:2]
    o = torch.matmul(a.reshape(B, S, -1), wo.to(a.dtype).reshape(-1, wo.shape[-1]))
    if split(parallel, wo.shape[-3], cfg.n_heads):
        o = parallel.sum(o)
    return o


# A ``keep(path, leaf)`` callback of the initializers maps each leaf, the
# moment it is drawn, to what is kept of it (a rank's share: see
# ``repro_torch.sharding.shard``); ``path`` is the leaf's keys under the
# initializer's tree.  The draws are the same whatever is kept.
Keep = Callable[[Tuple[str, ...], torch.Tensor], torch.Tensor]


def keep_whole(path: Tuple[str, ...], leaf: torch.Tensor) -> torch.Tensor:
    return leaf


def keep_under(keep: Keep, *keys: str) -> Keep:
    """``keep`` for the sub-tree at ``keys``."""
    if keep is keep_whole:
        return keep
    return lambda path, leaf: keep(keys + path, leaf)


def dense_init(generator: torch.Generator, shape: Sequence[int],
               in_axis_size: Optional[int] = None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Scaled normal init: std = 1/sqrt(fan_in), drawn from ``generator``."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(std).to(dtype)  # in place: a full-width leaf is tens of GB


def embed_init(generator: torch.Generator, shape: Sequence[int], dtype=torch.float32,
               device=None) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32, device=device)
    return w.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32; ``scale`` is stored as (scale − 1)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def init_rmsnorm(d: int, dtype=torch.float32, lead: Sequence[int] = (), device=None):
    return torch.zeros((*lead, d), dtype=dtype, device=device)  # stored as (scale - 1)


# --------------------------------------------------------------- rotary embeddings
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (hd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) int.  Split-halves convention."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions.to(torch.float32)[:, None] * freqs  # (S, hd/2)
    angles = angles[None, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ attention
def init_attention(generator, cfg, dtype=torch.float32, lead: Sequence[int] = (),
                   device=None, keep: Keep = keep_whole) -> Dict[str, torch.Tensor]:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": keep(("wq",), dense_init(generator, (*lead, D, H, hd), in_axis_size=D, dtype=dtype,
                                       device=device)),
        "wk": keep(("wk",), dense_init(generator, (*lead, D, Hkv, hd), in_axis_size=D,
                                       dtype=dtype, device=device)),
        "wv": keep(("wv",), dense_init(generator, (*lead, D, Hkv, hd), in_axis_size=D,
                                       dtype=dtype, device=device)),
        "wo": keep(("wo",), dense_init(generator, (*lead, H, hd, D), in_axis_size=H * hd,
                                       dtype=dtype, device=device)),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, lead, device)
        p["k_norm"] = init_rmsnorm(hd, dtype, lead, device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``: (B, S, D) × (D, H, hd) → (B, S, H, hd)."""
    B, S, D = x.shape
    return torch.matmul(x, w.to(x.dtype).reshape(D, -1)).reshape(B, S, *w.shape[1:])


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,hd)  k: (B,Skv,Hkv,hd) -> (B,H,Sq,Skv) f32, GQA-grouped.  The
    product runs in the input dtype and is upcast after, as in the reference."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32)
    return s.reshape(B, H, Sq, k.shape[1])


def _gqa_combine(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,H,Sq,Skv)  v: (B,Skv,Hkv,hd) -> (B,Sq,H,hd)."""
    B, H, Sq, Skv = probs.shape
    Hkv = v.shape[2]
    pg = probs.reshape(B, Hkv, H // Hkv, Sq, Skv)
    out = torch.einsum("bkgqs,bskh->bqkgh", pg, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def attend_direct(q, k, v, mask, scale: float) -> torch.Tensor:
    """Attention with a materialized score matrix.  mask: broadcastable to
    (B,H,Sq,Skv), True = keep; a masked score is −1e30, as in the reference."""
    s = _gqa_scores(q, k) * scale
    s = torch.where(mask, s, torch.full((), -1e30, dtype=torch.float32, device=s.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_combine(p, v)


def attend_slabs(q, k, v, mask, scale: float, parallel: ParallelContext) -> torch.Tensor:
    """``attend_direct`` over a K/V sequence that the data group holds in
    slabs, this rank's ``k`` / ``v`` (B, S_slab, Hkv, hd) and ``mask`` its
    slab's columns: the slabs' partial softmaxes combined by three
    ``all_reduce``s over the data group, in f32 — the max of each query
    head's scores, then the sum of ``exp(s − max)``, then, with ``p =
    exp(s − max) / sum`` cast to the activation dtype as ``attend_direct``
    casts its softmax, the sum of the partial products ``p @ V``.  A slab
    with no valid position adds exactly zero (its scores are −1e30, the
    max is a valid slab's).  Every data rank gets the same result."""
    s = _gqa_scores(q, k) * scale
    s = torch.where(mask, s, torch.full((), -1e30, dtype=torch.float32, device=s.device))
    m = parallel.data_all_reduce(s.amax(dim=-1, keepdim=True), dist.ReduceOp.MAX)
    e = torch.exp(s - m)
    total = parallel.data_all_reduce(e.sum(dim=-1, keepdim=True))
    p = (e / total).to(q.dtype)
    out = parallel.data_all_reduce(_gqa_combine(p, v).to(torch.float32))
    return out.to(q.dtype)


def attend_blocked(q, k, v, *, causal: bool, window: Optional[int], scale: float,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor, q_block: int = 512,
                   kv_block: int = 1024) -> torch.Tensor:
    """Blocked online-softmax attention in plain PyTorch ops (the reference's
    ``attend_blocked``, its scans as Python loops over the same blocks).

    Each q block visits kv blocks with a running (max, sum, acc), so memory
    is O(q_block · kv_block) a step.  With ``window`` and ``causal`` each q
    block sees a slice of K/V of static length ≥ window + q_block (its
    start clamped into range, as ``lax.dynamic_slice`` clamps it).  Causal
    without a window, q block i visits only the kv blocks up to its diagonal
    (the reference's ``causal_skip``): a block past it is all masked and
    adds exactly 0, so the values are those of visiting every block.
    Padded query rows carry position −1 and padded keys 2^30; both are
    masked."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    dev = q.device
    nq = -(-Sq // q_block)
    q_pad = nq * q_block - Sq
    qp = F.pad(q, (0, 0, 0, 0, 0, q_pad))
    qpos = F.pad(q_positions, (0, q_pad), value=-1)
    neg = torch.full((), -1e30, dtype=torch.float32, device=dev)

    def kv_inner(qblk, qpos_blk, kblocks):
        """Online softmax of one q block over ``kblocks`` [(k, v, kpos)]."""
        m = torch.full((B, H, q_block), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, q_block, H, hd), dtype=torch.float32, device=dev)
        for kblk, vblk, kpos_blk in kblocks:
            s = _gqa_scores(qblk, kblk) * scale  # (B, H, qb, kvb) f32
            msk = (qpos_blk[:, None] >= 0) & (kpos_blk[None, :] < 2 ** 30)
            if causal:
                msk = msk & (qpos_blk[:, None] >= kpos_blk[None, :])
            if window is not None:
                msk = msk & (qpos_blk[:, None] - kpos_blk[None, :] < window)
            s = torch.where(msk[None, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = _gqa_combine(p.to(qblk.dtype), vblk)  # (B, qb, H, hd)
            acc = acc * corr.transpose(1, 2)[..., None] + pv.to(torch.float32)
            m = m_new
        lT = l.transpose(1, 2)[..., None]
        return (acc / torch.clamp(lT, min=1e-30)).to(qblk.dtype)

    def blocks(kp, vp, kpos, lo, n):
        return [(kp[:, lo + j * kv_block:lo + (j + 1) * kv_block],
                 vp[:, lo + j * kv_block:lo + (j + 1) * kv_block],
                 kpos[lo + j * kv_block:lo + (j + 1) * kv_block]) for j in range(n)]

    def q_blk(i):
        return qp[:, i * q_block:(i + 1) * q_block], qpos[i * q_block:(i + 1) * q_block]

    if window is not None and causal:
        w_up = -(-window // kv_block) * kv_block
        n_in = -(-(w_up + q_block) // kv_block)
        span = n_in * kv_block
        kp = F.pad(k, (0, 0, 0, 0, w_up, q_pad))
        vp = F.pad(v, (0, 0, 0, 0, w_up, q_pad))
        kpos = F.pad(kv_positions, (w_up, q_pad), value=2 ** 30)
        outs = []
        for i in range(nq):
            st = min(i * q_block, kp.shape[1] - span)  # dynamic_slice's clamp
            outs.append(kv_inner(*q_blk(i), blocks(kp, vp, kpos, st, n_in)))
        return torch.cat(outs, dim=1)[:, :Sq]

    nkv = -(-Skv // kv_block)
    kv_pad = nkv * kv_block - Skv
    kp = F.pad(k, (0, 0, 0, 0, 0, kv_pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, kv_pad))
    kpos = F.pad(kv_positions, (0, kv_pad), value=2 ** 30)
    kblocks = blocks(kp, vp, kpos, 0, nkv)
    outs = []
    for i in range(nq):
        n = min(nkv, -(-((i + 1) * q_block) // kv_block)) if causal else nkv
        outs.append(kv_inner(*q_blk(i), kblocks[:n]))
    return torch.cat(outs, dim=1)[:, :Sq]


BLOCKED_ATTENTION_THRESHOLD = 4096


def self_attention(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    cfg,
    positions: torch.Tensor,  # (S,) absolute positions of x's tokens
    is_global: bool,  # full attention vs sliding window
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k","v"}: (B, S_max, Hkv, hd)
    cache_pos: Optional[int] = None,  # decode: write index
    return_kv: bool = False,  # prefill: emit this segment's K/V as a cache
    use_kernels: bool = True,  # prefill: the flash kernel, else the plain route
    parallel: Optional[ParallelContext] = None,
):
    """Returns ``(out, new_cache)``; decode mode iff ``cache`` is given.

    Prefill runs causal attention over x itself: through the flash-attention
    kernel with ``use_kernels``, else on the reference's plain route
    (``attend_direct``, or ``attend_blocked`` from
    ``BLOCKED_ATTENTION_THRESHOLD`` tokens).  Decode writes the token's k/v
    into ``cache`` at ``cache_pos`` IN PLACE (the reference's serving loop
    donates the cache to the same end) and attends over the cache;
    ``new_cache`` holds the same tensors.

    Over a group each rank holds its q heads of ``wq`` and their rows of
    ``wo``, and its kv heads of ``wk`` / ``wv`` (or, when ``n_kv_heads``
    does not split, the whole of them, from which it picks the kv heads its
    q heads read: ``kv_heads_used``); attention (the flash kernel in
    prefill) runs on the local heads, whose GQA ratio is the model's, and
    one ``all_reduce`` sums the partial outputs of ``wo``.  QK-norm, RoPE
    and the window act per head.  The decode cache holds the local kv
    heads (the reference splits its cache's sequence over ``"model"``
    instead, a GSPMD layout choice: the values are the same).

    On a grid whose data group splits the cache's sequence (``seq_split``)
    ``cache`` is this rank's slab, from position ``parallel.slab_start``:
    the token's K/V are written only where its position falls in the slab,
    the masks read the slab's absolute positions, and ``attend_slabs``
    combines the slabs over the data group before ``wo``."""
    S = x.shape[1]
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    x = into_heads(x, params["wq"], cfg, parallel)
    q = _project(x, params["wq"])
    k = pick_kv_heads(_project(x, params["wk"]), cfg, parallel)
    v = pick_kv_heads(_project(x, params["wv"]), cfg, parallel)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = None if is_global else cfg.sliding_window

    if cache is None:
        if use_kernels:
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                                  window=window, scale=scale)
        elif S >= BLOCKED_ATTENTION_THRESHOLD:
            out = attend_blocked(q, k, v, causal=True, window=window, scale=scale,
                                 q_positions=positions, kv_positions=positions)
        else:
            msk = positions[:, None] >= positions[None, :]
            if window is not None:
                msk = msk & (positions[:, None] - positions[None, :] < window)
            out = attend_direct(q, k, v, msk[None, None], scale)
        new_cache = {"k": k, "v": v} if return_kv else None
    else:
        kc, vc = cache["k"], cache["v"]
        S_slab = kc.shape[1]
        start = 0 if parallel is None else parallel.slab_start(S_slab)
        # the positions [cache_pos, cache_pos + S) that fall in this rank's slab
        lo, hi = max(cache_pos, start), min(cache_pos + S, start + S_slab)
        if lo < hi:
            kc[:, lo - start:hi - start] = k[:, lo - cache_pos:hi - cache_pos].to(kc.dtype)
            vc[:, lo - start:hi - start] = v[:, lo - cache_pos:hi - cache_pos].to(vc.dtype)
        kv_positions = torch.arange(start, start + S_slab, device=x.device)
        valid = kv_positions <= cache_pos
        if window is not None:
            valid &= kv_positions > cache_pos - window
        if seq_split(parallel):
            out = attend_slabs(q, kc, vc, valid[None, None, None, :], scale, parallel)
        else:
            out = attend_direct(q, kc, vc, valid[None, None, None, :], scale)
        new_cache = {"k": kc, "v": vc}

    return heads_out(out, params["wo"], cfg, parallel), new_cache


# ------------------------------------------------- cross attention (encoder-decoder)
def cross_attention(params: Dict[str, torch.Tensor], x: torch.Tensor,
                    enc_kv: Dict[str, torch.Tensor], *, cfg,
                    parallel: Optional[ParallelContext] = None) -> torch.Tensor:
    """x: (B, Sq, D) queries; enc_kv: {"k", "v"}: (B, S_src, Hkv, hd).  No
    mask and no positions; ``attend_blocked`` once either length reaches
    ``BLOCKED_ATTENTION_THRESHOLD``, as in the reference.  Over a group the
    rank's q heads attend over the kv heads ``enc_kv`` holds (``encode_kv``
    with ``parallel``), and one ``all_reduce`` sums the partial outputs of
    ``wo``.  Where a grid's data group splits the source sequence
    (``seq_split``) ``enc_kv`` is this rank's slab of it, combined over the
    data group by ``attend_slabs``."""
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    Sq = x.shape[1]
    q = _project(into_heads(x, params["wq"], cfg, parallel), params["wq"])
    k = enc_kv["k"].to(x.dtype)
    v = enc_kv["v"].to(x.dtype)
    S_src = k.shape[1]
    if seq_split(parallel):
        everywhere = torch.ones((1, 1, Sq, S_src), dtype=torch.bool, device=x.device)
        out = attend_slabs(q, k, v, everywhere, scale, parallel)
    elif max(Sq, S_src) >= BLOCKED_ATTENTION_THRESHOLD:
        out = attend_blocked(q, k, v, causal=False, window=None, scale=scale,
                             q_positions=torch.arange(Sq, device=x.device),
                             kv_positions=torch.arange(S_src, device=x.device))
    else:
        out = attend_direct(q, k, v, torch.ones((1, 1, Sq, S_src), dtype=torch.bool,
                                                device=x.device), scale)
    return heads_out(out, params["wo"], cfg, parallel)


def encode_kv(params: Dict[str, torch.Tensor], enc_out: torch.Tensor, *, cfg,
              parallel: Optional[ParallelContext] = None) -> Dict[str, torch.Tensor]:
    """Cross-attention K/V of the encoder output (computed once a layer);
    over a group the kv heads this rank's q heads read, from its share of
    ``wk`` / ``wv`` (``kv_heads_of``)."""
    enc_out = into_heads(enc_out, params["wq"], cfg, parallel)
    return {"k": pick_kv_heads(_project(enc_out, params["wk"]), cfg, parallel),
            "v": pick_kv_heads(_project(enc_out, params["wv"]), cfg, parallel)}


# ------------------------------------------------------------------------ MLP
def init_mlp(generator, cfg, d_ff: Optional[int] = None, dtype=torch.float32,
             lead: Sequence[int] = (), device=None, keep: Keep = keep_whole
             ) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    names = ("w_gate", "w_up") if cfg.mlp_type == "gated_silu" else ("w_up",)
    p = {n: keep((n,), dense_init(generator, (*lead, D, Fd), in_axis_size=D, dtype=dtype,
                                  device=device))
         for n in names}
    p["w_down"] = keep(("w_down",), dense_init(generator, (*lead, Fd, D), in_axis_size=Fd,
                                               dtype=dtype, device=device))
    return p


def mlp(params: Dict[str, Any], x: torch.Tensor, *, cfg,
        parallel: Optional[ParallelContext] = None) -> torch.Tensor:
    """Gated SiLU, or (``mlp_type="gelu"``) GELU in the tanh approximation,
    which is ``jax.nn.gelu``'s default.  Over a group each rank holds the
    columns ``w_gate`` / ``w_up`` and the rows of ``w_down`` of its slice of
    the hidden layer, and one ``all_reduce`` sums the partial outputs (the
    reference's ``"model"``-sharded hidden layer)."""
    sharded = split(parallel, params["w_down"].shape[-2], cfg.d_ff)
    if sharded:
        x = parallel.copy_in(x)
    if cfg.mlp_type == "gated_silu":
        g = torch.matmul(x, params["w_gate"].to(x.dtype))
        u = torch.matmul(x, params["w_up"].to(x.dtype))
        h = F.silu(g) * u
    else:
        h = F.gelu(torch.matmul(x, params["w_up"].to(x.dtype)), approximate="tanh")
    out = torch.matmul(h, params["w_down"].to(x.dtype))
    if sharded:
        out = parallel.sum(out)
    return out


# ---------------------------------------------------------- mixture of experts
def init_moe(generator, cfg, dtype=torch.float32, lead: Sequence[int] = (),
             device=None, keep: Keep = keep_whole) -> Dict[str, Any]:
    """Router (D, E), kept f32 whatever ``dtype`` is; experts (E, D, F) /
    (E, F, D); the shared expert an MLP."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p: Dict[str, Any] = {
        "router": keep(("router",), dense_init(generator, (*lead, D, E), in_axis_size=D,
                                               dtype=torch.float32, device=device)),
        "w_gate": keep(("w_gate",), dense_init(generator, (*lead, E, D, Fd), in_axis_size=D,
                                               dtype=dtype, device=device)),
        "w_up": keep(("w_up",), dense_init(generator, (*lead, E, D, Fd), in_axis_size=D,
                                           dtype=dtype, device=device)),
        "w_down": keep(("w_down",), dense_init(generator, (*lead, E, Fd, D), in_axis_size=Fd,
                                               dtype=dtype, device=device)),
    }
    if cfg.shared_expert:
        p["shared"] = init_mlp(generator, cfg, dtype=dtype, lead=lead, device=device,
                               keep=keep_under(keep, "shared"))
    return p


def _router(params, x: torch.Tensor, cfg):
    """x (T, D) → ``(gates (T, k) f32, experts (T, k), probs (T, E), aux)``:
    f32 logits and softmax, top-k, gates renormalised over the k; aux is
    the load-balance (Switch) loss plus the router z-loss, f32.  A router
    held in bf16 (the dry-run's ``Knobs.param_dtype``) is promoted to f32,
    as the reference's einsum promotes it."""
    T = x.shape[0]
    logits = torch.matmul(x.to(torch.float32), params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    # expert counts are integers, exact in f32 in any order; a scatter of ones
    # (not bincount, whose output length reads the data: a dry-run's fake
    # tensors have none)
    flat = experts.reshape(-1)
    ce = torch.zeros(cfg.n_experts, dtype=torch.float32, device=x.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x.device))
    ce = ce / (T * cfg.top_k)
    lb = cfg.n_experts * torch.sum(me * ce) * cfg.load_balance_loss
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.router_z_loss
    return gates, experts, probs, lb + z


def moe_ref(params, x: torch.Tensor, *, cfg):
    """Dense oracle: every expert on every token, combined by the gates
    (O(T·E·D·F); tests only).  Returns ``(out (B, S, D), aux)``."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    gates, experts, _, aux = _router(params, xt, cfg)
    comb = torch.zeros((xt.shape[0], cfg.n_experts), dtype=x.dtype, device=x.device)
    comb.scatter_add_(1, experts, gates.to(x.dtype))
    h = F.silu(torch.matmul(xt, params["w_gate"].to(x.dtype))) * \
        torch.matmul(xt, params["w_up"].to(x.dtype))  # (E, T, F)
    outs = torch.matmul(h, params["w_down"].to(x.dtype))  # (E, T, D)
    out = torch.einsum("te,etd->td", comb, outs)
    if cfg.shared_expert:
        out = out + mlp(params["shared"], x, cfg=cfg).reshape(-1, D)
    return out.reshape(B, S, D), aux


def moe_capacity(cfg, tokens: int) -> int:
    """Slots per expert: ⌈T·k / E · capacity_factor⌉ rounded up to 8, at least 8."""
    c = int(math.ceil(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)


def moe_dropping(params, x: torch.Tensor, *, cfg, parallel: Optional[ParallelContext] = None):
    """Capacity-based MoE (the reference's ``moe_dropping``): each (token,
    choice) takes the next slot of its expert's queue in token-major
    order, so a full expert drops the same choices as the reference;
    expert GEMMs over ``(E, C, D)`` slot buffers.  Returns ``(out, aux)``.

    Over a group (the reference's ``shard_map`` branch) each rank holds
    ``E / N`` experts ``[e_lo, e_lo + E / N)`` and runs the choices that
    land there; the router stays whole and f32, so routing and the
    capacity, computed over all E, drop the same choices as the unsharded
    model.  ``out`` is summed by an ``all_reduce`` and ``aux`` (the same on
    every rank) by an ``all_reduce`` over N; the shared expert is the
    group's MLP."""
    B, S, D = x.shape
    e_loc = params["w_gate"].shape[-3]
    sharded = split(parallel, e_loc, cfg.n_experts)
    xs = parallel.copy_in(x) if sharded else x  # the shared expert takes x itself
    out, aux = _moe_local(params, xs.reshape(-1, D), cfg=cfg,
                          e_lo=parallel.rank * e_loc if sharded else 0)
    out = out.reshape(B, S, D)
    if sharded:
        out = parallel.sum(out)
        aux = parallel.sum(aux) / parallel.size
    if cfg.shared_expert:
        out = out + mlp(params["shared"], x, cfg=cfg, parallel=parallel)
    return out, aux


def _moe_local(params, xt: torch.Tensor, *, cfg, e_lo: int = 0):
    """Tokens ``xt`` (T, D) through the experts ``params`` holds, ``[e_lo,
    e_lo + E_local)``, with capacity slots; the choices routed elsewhere
    read zeros."""
    T, D = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = params["w_gate"].shape[0]
    C = moe_capacity(cfg, T)
    gates, experts, _, aux = _router(params, xt, cfg)

    flat_e = experts.reshape(-1)  # (T·k,), token-major
    # queue position per expert, over all E, so capacity drops as unsharded
    pos = torch.cumsum(F.one_hot(flat_e, E), dim=0) - 1
    pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    local = (flat_e >= e_lo) & (flat_e < e_lo + E_loc) & (pos < C)
    slot = torch.where(local, (flat_e - e_lo) * C + pos, E_loc * C)  # E_loc·C: the drop row
    tok_idx = torch.arange(T, device=xt.device).repeat_interleave(k)
    # every kept slot is written once (0 + x in the reference: x exactly);
    # the drop row takes many writes in no set order and is never read
    buf = xt.new_zeros((E_loc * C + 1, D))
    buf[slot] = xt[tok_idx]
    buf = buf[:-1].reshape(E_loc, C, D)

    h = torch.bmm(buf, params["w_gate"].to(xt.dtype))
    u = torch.bmm(buf, params["w_up"].to(xt.dtype))
    eout = torch.bmm(F.silu(h) * u, params["w_down"].to(xt.dtype)).reshape(E_loc * C, D)
    eout = torch.cat([eout, xt.new_zeros((1, D))])  # a dropped choice reads zeros

    gathered = (eout[slot] * gates.reshape(-1)[:, None].to(xt.dtype)).reshape(T, k, D)
    out = gathered[:, 0]
    for j in range(1, k):  # the k choices summed in ascending order: no atomics
        out = out + gathered[:, j]
    return out, aux
