"""Rank bodies of the model-group tests (tests/test_torch_model_parallel.py).

Spawned ranks import this module by name, so it imports torch and the port
only: no JAX.  ``serve_case`` (a decoder-only model) and ``encdec_case``
(the encoder-decoder) run the same in a rank of a model group (its share
of the weights, sliced from the whole tree it is handed) and, unsharded,
in the test process, so one body gives both sides of the comparison.
tests/test_torch_model_parallel_ssm.py uses them too.
"""
from __future__ import annotations

import torch

from repro_torch.core.convert import params_from_numpy, to_numpy
from repro_torch.launch.mesh import make_model_group
from repro_torch.launch.serve import merge
from repro_torch.launch.steps import build_prefill_step, build_serve_step
from repro_torch.models import encdec, layers
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import _keys, param_specs
from repro_torch.sharding.shard import shard_params
from repro_torch.utils.trees import tree_flatten_with_path, tree_map


def _share(job, parallel):
    """The model, its config and this rank's params (the whole tree
    unsharded)."""
    torch.set_num_threads(1)
    cfg = job["cfg"]
    params = params_from_numpy(job["params"])
    if parallel is not None:
        params = shard_params(params, param_specs(params, cfg, parallel.size), parallel.rank,
                              parallel.size)
    return build_model(cfg), cfg, params


def _cache_out(out, cache):
    """The cache leaves as numpy, with the last key of each leaf's path."""
    flat = tree_flatten_with_path(cache)[0]
    out["cache"] = [to_numpy(x) for _, x in flat]
    out["cache_keys"] = [_keys(p)[-1] for p, _ in flat]


def serve_case(job, parallel=None):
    """Prefill ``job["tokens"]`` (B, S) and decode ``job["steps"]`` greedy
    tokens with ``job["params"]`` (a numpy tree of the whole model) under
    ``job["cfg"]``: the prefill logits, each decode step's logits, the
    greedy tokens, the experts every router call chose, this rank's cache
    leaves after the last step, and the group's collective counts.  The
    same run through ``launch.steps``' prefill and serve steps gives the
    tokens ``step_tokens``."""
    model, cfg, params = _share(job, parallel)
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
    _cache_out(out, cache)
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


def encdec_case(job, parallel=None):
    """The encoder-decoder under ``job["cfg"]`` with ``job["params"]``:
    encode ``job["src"]`` (B, S_src, D) on the serving route, the
    teacher-forced logits of ``job["tgt"]`` (B, S_tgt), then
    ``job["steps"]`` greedy decode steps from BOS 0: the encoder output,
    those logits, each step's logits, the tokens, this rank's cache leaves
    after the last step and the group's collective counts."""
    model, cfg, params = _share(job, parallel)
    src = torch.as_tensor(job["src"])
    B = src.shape[0]
    enc = encdec.encode(params, src, cfg=cfg, use_kernels=True, parallel=parallel)
    out = {"enc": to_numpy(enc),
           "train": to_numpy(encdec.decode_train(params, torch.as_tensor(job["tgt"]), enc,
                                                 cfg=cfg, parallel=parallel)),
           "decode": []}
    cache = model.init_cache(params, B, job["steps"], enc_out=enc, parallel=parallel)
    tok = torch.zeros((B, 1), dtype=torch.long)
    tokens = []
    for i in range(job["steps"]):
        lg, cache = model.decode_step(params, tok, cache, i, parallel)
        out["decode"].append(to_numpy(lg))
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        tokens.append(tok)
    out["tokens"] = to_numpy(torch.cat(tokens, dim=1))
    _cache_out(out, cache)
    out["counts"] = None if parallel is None else dict(parallel.counts)
    return out


def run_case(job, parallel=None):
    """``encdec_case`` for the encoder-decoder, else ``serve_case``."""
    return (encdec_case if job["cfg"].is_encoder_decoder else serve_case)(job, parallel)


def world(rank, device, jobs):
    """A rank's body: every job of ``jobs`` on the model group, in order,
    each with the collective counts from 0."""
    return [run_case(job, make_model_group()) for job in jobs]
