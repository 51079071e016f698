"""Rank bodies of the model-group tests (tests/test_torch_model_parallel.py).

Spawned ranks import this module by name, so it imports torch and the port
only: no JAX.  ``serve_case`` runs the same in a rank of a model group
(its share of the weights, sliced from the whole tree it is handed) and,
unsharded, in the test process, so one body gives both sides of the
comparison.
"""
from __future__ import annotations

import torch

from repro_torch.core.convert import params_from_numpy, to_numpy
from repro_torch.launch.mesh import make_model_group
from repro_torch.launch.serve import merge
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import layers
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import param_specs
from repro_torch.sharding.shard import shard_params
from repro_torch.utils.trees import tree_leaves, tree_map


def serve_case(job, parallel=None):
    """Prefill ``job["tokens"]`` (B, S) and decode ``job["steps"]`` greedy
    tokens with ``job["params"]`` (a numpy tree of the whole model) under
    ``job["cfg"]``: the prefill logits, each decode step's logits, the
    greedy tokens, the experts every router call chose, this rank's cache
    leaves after the last step, and the group's collective counts.  The
    same run through ``launch.steps``' prefill and serve steps gives the
    tokens ``step_tokens``."""
    torch.set_num_threads(1)
    cfg = job["cfg"]
    model = build_model(cfg)
    params = params_from_numpy(job["params"])
    if parallel is not None:
        params = shard_params(params, param_specs(params, cfg, parallel.size), parallel.rank,
                              parallel.size)
    toks = torch.as_tensor(job["tokens"])
    B, S = toks.shape
    routes = []
    router = layers._router

    def recording_router(p, x, c):
        got = router(p, x, c)
        routes.append(to_numpy(got[1]))
        return got

    layers._router = recording_router
    try:
        logits, pre, _ = model.apply(params, toks, return_cache=True, parallel=parallel)
        cache = tree_map(merge, model.init_cache(params, B, S + job["steps"], parallel), pre)
        out = {"prefill": to_numpy(logits), "decode": []}
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        tokens = [tok]
        for i in range(job["steps"]):
            lg, cache = model.decode_step(params, tok, cache, S + i, parallel)
            out["decode"].append(to_numpy(lg))
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
            tokens.append(tok)
    finally:
        layers._router = router
    out["tokens"] = to_numpy(torch.cat(tokens, dim=1))
    out["routes"] = routes
    out["cache"] = [to_numpy(x) for x in tree_leaves(cache)]
    out["counts"] = None if parallel is None else dict(parallel.counts)

    prefill, step = build_prefill_step(model, parallel), build_serve_step(model, parallel)
    last, pre = prefill(params, toks)
    cache = tree_map(merge, model.init_cache(params, B, S + job["steps"], parallel), pre)
    tok = torch.argmax(last, dim=-1)[:, None]
    tokens = [tok]
    for i in range(job["steps"]):
        tok, cache = step(params, tok, cache, S + i)
        tokens.append(tok)
    out["step_tokens"] = to_numpy(torch.cat(tokens, dim=1))
    return out


def world(rank, device, jobs):
    """A rank's body: every job of ``jobs`` on the model group, in order,
    each with the collective counts from 0."""
    return [serve_case(job, make_model_group()) for job in jobs]
