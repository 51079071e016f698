"""Rank bodies of the grid-serving tests (tests/test_torch_grid_serve.py).

Spawned ranks import this module by name, so it imports torch and the port
only: no JAX.  A grid is ``data`` × ``model`` gloo ranks
(``launch.mesh.make_grid``: world rank ``d·model + m``).  ``serve_grid_case``
runs the same in a rank of a grid (its share of the weights in the job's
layout, taken from the whole tree it is handed; its data row's block of
the rows, or every row and its slab of the caches' sequence) and,
unsharded, in the test process on the rows it is given, so one body gives
both sides of the comparison.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.convert import params_from_numpy, to_numpy
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_grid, make_model_group
from repro_torch.launch.steps import Knobs, make_parallel, param_mode
from repro_torch.models import encdec
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import _keys
from repro_torch.sharding.shard import grid_take
from repro_torch.utils.trees import tree_flatten_with_path, tree_unflatten


def share(cfg, whole, parallel, mode: str):
    """This rank's share of the whole tensor tree ``whole`` in the layout
    ``mode`` (the whole tree unsharded)."""
    if parallel is None:
        return whole
    leaves, treedef = tree_flatten_with_path(whole)
    return tree_unflatten(treedef, [
        grid_take(t, _keys(p), cfg, parallel.rank, parallel.size, parallel.data_rank,
                  parallel.data_size, mode=mode) for p, t in leaves])


def _cache_out(cache):
    flat = tree_flatten_with_path(cache)[0]
    return [to_numpy(x) for _, x in flat], [_keys(p)[-1] for p, _ in flat]


def _first_kv(cache):
    """The first attention K leaf of the cache (None without attention)."""
    return next((x for p, x in tree_flatten_with_path(cache)[0] if _keys(p)[-1] == "k"), None)


def serve_grid_case(job, parallel=None, rows=None):
    """Prefill ``job["tokens"][:, :job["prompt"]]`` of the rows this rank
    serves (``rows`` unsharded: default all) into a cache of
    ``job["cache_len"]`` positions and decode the next tokens of
    ``job["tokens"]`` teacher-forced (the encoder-decoder: encode
    ``job["src"]``, then decode ``job["tgt"]`` from BOS 0).  Returns the
    prefill logits (the encoder output), each step's logits, the cache
    leaves after the prefill and after the last step with the last key of
    each leaf's path, for each step whether the first attention cache leaf
    changed on this rank and how many ``all_reduce``s the data group ran,
    and the collective counts."""
    torch.set_num_threads(1)
    cfg, mode = job["cfg"], param_mode(job.get("knobs", Knobs()))
    model = build_model(cfg)
    params = share(cfg, params_from_numpy(job["params"]), parallel, mode)
    B = job["batch"]
    if rows is None:
        rows = slice(0, B) if parallel is None else serve._rows(B, parallel)
    grid = parallel is not None and parallel.data_size > 1
    if parallel is not None:
        for k in parallel.counts:
            parallel.counts[k] = 0
    out = {"decode": [], "written": [], "step_data_all_reduce": []}
    if cfg.is_encoder_decoder:
        src = torch.as_tensor(job["src"])[rows]
        enc = encdec.encode(params, src, cfg=cfg, use_kernels=True, parallel=parallel)
        out["prefill"] = to_numpy(enc)
        cache = model.init_cache(params, B if grid else src.shape[0], job["cache_len"],
                                 enc_out=enc, parallel=parallel)
        # BOS 0 at position 0, then the target tokens
        feed = torch.cat([torch.zeros((src.shape[0], 1), dtype=torch.long),
                          torch.as_tensor(job["tgt"])[rows]], dim=1)
        first = 0
    else:
        toks = torch.as_tensor(job["tokens"])[rows]
        S = job["prompt"]
        logits, pre, _ = model.apply(params, toks[:, :S], return_cache=True, parallel=parallel)
        out["prefill"] = to_numpy(logits)
        cache = serve.merge_prefill(model.init_cache(params, B if grid else toks.shape[0],
                                                     job["cache_len"], parallel), pre, parallel)
        feed, first = toks, S
    out["cache_prefill"], out["cache_keys"] = _cache_out(cache)
    for i in range(first, first + job["steps"]):
        kv = _first_kv(cache)
        before = None if kv is None else kv.clone()
        n0 = 0 if parallel is None else parallel.counts["data_all_reduce"]
        lg, cache = model.decode_step(params, feed[:, i:i + 1], cache, i, parallel)
        out["decode"].append(to_numpy(lg))
        out["written"].append(None if kv is None else bool((kv != before).any()))
        out["step_data_all_reduce"].append(
            0 if parallel is None else parallel.counts["data_all_reduce"] - n0)
    out["cache"] = _cache_out(cache)[0]
    out["counts"] = None if parallel is None else dict(parallel.counts)
    return out


def grid_world(rank, device, grids, jobs, follow=None):
    """A rank's body on a world of ``data · model`` ranks: on each
    ``(data, model)`` grid of ``grids`` every job of ``jobs`` on the grid's
    serving context (``make_parallel(..., knobs=, batch=)``); at ``data`` = 1
    also on the model group of the world (``make_model_group``, the path a
    model group took before grids), under ``"group"``; then ``follow_case``
    of ``follow`` on the grid its command line names.  The results by grid,
    and the follow case's under ``"follow"``."""
    torch.set_num_threads(1)
    out = {}
    for data, model in grids:
        groups = make_grid(data, model)
        rows = []
        for job in jobs:
            ctx = make_parallel(*groups, cfg=job["cfg"], knobs=job.get("knobs", Knobs()),
                                batch=job["batch"])
            got = serve_grid_case(job, ctx)
            if data == 1:
                got["group"] = serve_grid_case(job, make_model_group(model))
            rows.append(got)
        out[(data, model)] = rows
    if follow is not None:
        args = serve.build_parser().parse_args(follow["argv"])
        out["follow"] = follow_case(follow, serve.grid_context(args, serve.serve_config(args)))
    return out


def follow_case(job, parallel=None):
    """``serve.run`` of ``job["argv"]`` (its ``--ckpt`` a publisher
    directory, ``--follow``) on ``parallel``; after decode step
    ``job["publish_after"]`` world rank 0 publishes ``job["later"]`` (a
    numpy tree) into ``job["dir"]``.  The tokens, the decode steps at which
    the params were swapped and the versions swapped in."""
    from repro_torch.fleet import publisher

    torch.set_num_threads(1)
    args = serve.build_parser().parse_args(job["argv"])
    pub = publisher.ModelPublisher(job["dir"], retain=2)
    later = params_from_numpy(job["later"])
    lead = parallel is None or dist.get_rank() == 0

    def on_step(stats):
        if lead and stats.steps == job["publish_after"]:
            pub.publish(later, step=pub.version + 1)

    res = serve.run(args, on_step=on_step, parallel=parallel)
    return {"tokens": res.tokens, "swap_steps": list(res.stats.swap_steps),
            "versions": list(res.stats.versions)}
