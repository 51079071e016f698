"""The LM train step and the serving steps (counterpart of
``repro.launch.steps``): loss → grads (optionally accumulated over
microbatches) → global-norm clip → AdamW → new params; and the prefill and
decode steps of a decoder-only model, unsharded or on a model group.

``build_train_step(cfg, knobs).fn(params, opt_state, batch)`` returns
``(params, opt_state, {"loss", "grad_norm"})`` as new trees and leaves its
inputs alone, as the reference's jitted step does (which then donates
them).  Gradients come from ``torch.autograd`` through the model's plain
route (``loss_fn(..., use_kernels=False)``): the hand-written kernels have
no backward, as the reference's Pallas kernels have none.

The ``Knobs`` fields keep the reference's names and defaults: gradients
accumulate over microbatches in ``grad_accum_dtype`` and the AdamW moments
are stored in ``moment_dtype`` (both f32 by default).  ``param_dtype``
(bf16 by default) is the dtype the dry-run holds every floating leaf of a
rank's share in (``launch.dryrun.share_layout``, the reference's
``_params_sds``); a step itself keeps the dtype of the weights it is
handed (``model.init`` gives the config's ``param_dtype``) and updates
them in f32.  ``seq_shard_acts`` is a lowering knob the reference only
reports (its dry-run's JSON); the port's dry-run reports it too.
``serve_params`` is the serving layout's name, as the reference's:
``"fsdp"`` (the default) stores the params as training does, FSDP over the
data group, and ``"replicated"`` in the reference's ``mode="serve"``
layout, which keeps only the expert banks' data slices (``param_mode``);
a serving grid's context reads it (``make_parallel(..., knobs=)``).
Left out is ``scan_unroll``: eager code runs every layer.

``build_train_step(cfg, knobs, parallel)`` trains on a model group: every
rank calls the step with its share of the params and of the AdamW state
(``repro_torch.sharding.shard``) and the same batch.  The model's
collectives carry the gradient (``models.layers``); the gradients of the
leaves a rank reads only in part are summed over the group
(``rules.sum_partial``); the clip takes the group's norm (the split parts
summed over the ranks, each replicated part counted once,
``rules.group_sq_norm``); AdamW and the f32 update run on the share.  Every
rank gets the same loss and grad norm.

On a grid (``parallel.data_group``, ``launch.mesh.make_grid``) each rank
calls the step with its FSDP share (``sharding.shard.grid_take``), its
AdamW state on that share, and its data row's block of the batch (rows
``[d·B/D, (d+1)·B/D)``, the reference's ``batch_specs``); microbatches
split those rows.  The model gathers each period's slices as it uses them
and reduce-scatters their gradients (``models.layers.fsdp_gather``); the
leaves replicated over data have their gradients summed over the data
group (``rules.sum_over_data``, one ``all_reduce`` a dtype); every
gradient and the loss then take a factor 1/D, the mean over the data
group of each rank's mean over its rows.  The clip's norm sums the FSDP
slices over both groups and counts each replicated part once (on data
rank 0 and model rank 0).  A MoE routes each data rank's tokens at the
capacity of its own tokens, as the reference's mesh does, and its
load-balance loss is averaged over the data group with the rest of the
loss: where a token drops, the grid's step is not the unsharded one.

``make_parallel`` / ``build_prefill_step`` / ``build_serve_step`` are the
reference's step builders as plain functions (no jit bundles, no
shardings): the group's ranks each call the step with their share of the
params (``repro_torch.sharding.shard``) and the same tokens.  On a grid
(``make_parallel(..., knobs=, batch=)``) each rank holds its share in the
``knobs.serve_params`` layout; where the data group divides the batch each data
row calls the steps with its block of the rows (and a MoE routes them at
its own capacity, as the reference's mesh does), and where it does not
every rank calls them with every row and holds its slab of each attention
cache's sequence (``ParallelContext.seq_split``).  The reference prefills
in the train layout and decodes in the ``serve_params`` one; a serving
process of the port holds one layout for both (a route difference: the
values are the same).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.models.layers import ParallelContext
from repro_torch.models.model import Model, build_model
from repro_torch.models.transformer import check_remat
from repro_torch.optim.optimizers import Optimizer, adamw, clip_by_global_norm
from repro_torch.sharding.rules import (
    group_sq_norm, serve_splits_batch, sum_over_data, sum_partial,
)
from repro_torch.sharding.shard import fsdp_map, share_fsdp, share_parts
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves, tree_map, tree_unflatten

F32 = torch.float32
DTYPES = ("float32", "bfloat16")
# Knobs.serve_params → the layout mode of ``sharding.rules.fsdp_dim``
SERVE_PARAMS = {"fsdp": "train", "replicated": "serve"}


@dataclass(frozen=True)
class Knobs:
    microbatches: int = 1  # grad-accumulation chunks of the global batch
    remat: str = "full"  # "none" | "full" | "dots" (models.transformer.remat_call)
    param_dtype: str = "bfloat16"  # the dry-run's share of the weights (launch.dryrun)
    learning_rate: Any = 3e-4  # a float or a schedule step -> lr
    grad_clip: float = 1.0
    use_kernels: bool = False  # only False: True raises, no kernel has a backward
    moment_dtype: str = "float32"  # AdamW's moments; bf16 halves their memory
    seq_shard_acts: bool = False  # reported only, as the reference's dry-run does
    grad_accum_dtype: str = "float32"  # the microbatch gradient accumulator
    serve_params: str = "fsdp"  # "fsdp" | "replicated": the serving layout (param_mode)


def param_mode(knobs: Knobs) -> str:
    """The layout mode (``sharding.rules.fsdp_dim``) of ``knobs.serve_params``:
    ``"fsdp"`` → ``"train"``, ``"replicated"`` → ``"serve"``."""
    if knobs.serve_params not in SERVE_PARAMS:
        raise ValueError(f"serve_params must be one of {tuple(SERVE_PARAMS)}, got "
                         f"{knobs.serve_params!r}")
    return SERVE_PARAMS[knobs.serve_params]


class TrainStep(NamedTuple):
    fn: Callable[..., Any]  # (params, opt_state, batch) -> (params, opt_state, metrics)
    opt: Optimizer
    model: Model


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)`` by autograd,
    each gradient in its param's dtype (zeros for a leaf the loss does not
    reach)."""
    leaves, treedef = tree_flatten_with_path(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for _, p in leaves]
        loss, metrics = loss_fn(tree_unflatten(treedef, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return (loss.detach(), tree_map(torch.Tensor.detach, metrics)), tree_unflatten(treedef, grads)


def build_train_step(cfg, knobs: Knobs = Knobs(),
                     parallel: Optional[ParallelContext] = None) -> TrainStep:
    """The train step of ``cfg`` under ``knobs``; with ``parallel`` each
    rank of that model group steps its share (see the module docstring)."""
    if knobs.use_kernels:
        raise NotImplementedError(
            "Knobs.use_kernels=True: the flash-attention and SSD kernels have no backward (nor "
            "have the JAX package's Pallas kernels); training takes the plain route")
    check_remat(knobs.remat)
    for name in ("param_dtype", "moment_dtype", "grad_accum_dtype"):
        if getattr(knobs, name) not in DTYPES:
            raise ValueError(f"Knobs.{name} must be one of {DTYPES}, got "
                             f"{getattr(knobs, name)!r}")
    model = build_model(cfg)
    opt = adamw(knobs.learning_rate, moment_dtype=getattr(torch, knobs.moment_dtype))
    acc_dtype = getattr(torch, knobs.grad_accum_dtype)
    M = knobs.microbatches
    parts = fsdp = None
    if parallel is not None:
        parts = share_parts(cfg, parallel.size)
        fsdp = share_fsdp(cfg, parallel.size, parallel.data_size)
    n_data = 1 if parallel is None else parallel.data_size

    def loss_fn(params, mb):
        return model.loss_fn(params, mb, parallel=parallel, remat=knobs.remat,
                             use_kernels=False)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        if M == 1:
            (loss, _), grads = value_and_grad(loss_fn, params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % M:
                raise ValueError(f"batch {B} is not a multiple of {M} microbatches")
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype, device=p.device),
                             params)
            loss = torch.zeros((), dtype=F32, device=next(iter(batch.values())).device)
            for i in range(M):
                mb = {k: v.reshape(M, B // M, *v.shape[1:])[i] for k, v in batch.items()}
                (l, _), g = value_and_grad(loss_fn, params, mb)
                grads = tree_map(lambda a, gi: a + gi.to(a.dtype), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / M, grads)
            loss = loss / M
        with torch.no_grad():
            norm = None
            if n_data > 1:  # the mean over the data group of each rank's rows' loss
                sum_over_data(tree_leaves(grads), fsdp, parallel)
                grads = tree_map(lambda g: g / n_data, grads)
                loss = parallel.data_all_reduce(loss.clone()) / n_data
            if parallel is not None:
                sum_partial(tree_leaves(grads), parts, parallel)
                norm = torch.sqrt(group_sq_norm(tree_leaves(grads), parts, parallel, fsdp))
            grads, gnorm = clip_by_global_norm(grads, knobs.grad_clip, norm)
            updates, opt_state = opt.update(grads, opt_state, params)
            del grads
            # p + u in f32, written into the update (a fresh tensor) when it is f32
            params = tree_map(lambda p, u: u.to(F32).add_(p.to(F32)).to(p.dtype), params,
                              updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return TrainStep(train_step, opt, model)


# ------------------------------------------------------------------ serving
def make_parallel(group=None, data_group=None, cfg=None, knobs: Optional[Knobs] = None,
                  batch: Optional[int] = None) -> Optional[ParallelContext]:
    """The model group's context for this process, over the
    ``torch.distributed`` process group ``group`` (None: unsharded), with a
    grid's ``data_group`` beside it (``launch.mesh.make_grid``) and the
    leaves of ``cfg``'s params that the grid stores in data slices
    (``sharding.shard.fsdp_map``): in the layout of a serving process's
    ``knobs.serve_params`` (``param_mode``), or training's FSDP layout where
    ``knobs`` is None.  ``batch``, the rows a grid serves: where the data
    group does not divide them it splits the caches' sequence instead
    (``ParallelContext.seq_split``)."""
    if group is None:
        return None
    size = dist.get_world_size(group)
    if data_group is None:
        return ParallelContext(group, dist.get_rank(group), size)
    data = dist.get_world_size(data_group)
    if cfg is None and data > 1:
        raise ValueError("a grid's context needs the model's config (cfg=) for its FSDP leaves")
    return ParallelContext(group, dist.get_rank(group), size, data_group,
                           dist.get_rank(data_group), data,
                           fsdp=None if cfg is None else fsdp_map(
                               cfg, size, data, "train" if knobs is None else param_mode(knobs)),
                           seq_split=batch is not None and not serve_splits_batch(batch, data))


def build_prefill_step(model: Model, parallel: Optional[ParallelContext] = None) -> Callable:
    """``fn(params, tokens) -> (logits of the last position (B, V), cache)``
    through the kernels, as the reference's prefill step.  On a grid the
    cache holds every prompt position; ``launch.serve.merge_prefill`` keeps
    the rank's slab of it."""
    def prefill_step(params, tokens):
        logits, cache, _ = model.apply(params, tokens, return_cache=True, parallel=parallel)
        return logits[:, -1], cache

    return prefill_step


def build_serve_step(model: Model, parallel: Optional[ParallelContext] = None) -> Callable:
    """``fn(params, token (B, 1), cache, pos) -> (next token (B, 1), cache)``:
    one greedy decode step, the cache written in place (on a grid that
    splits the sequence, on the one rank whose slab holds ``pos``)."""
    def serve_step(params, token, cache, pos):
        logits, cache = model.decode_step(params, token, cache, pos, parallel=parallel)
        return torch.argmax(logits[:, -1].to(F32), dim=-1)[:, None], cache

    return serve_step
