"""Rank bodies of the training-on-a-group tests (tests/test_torch_train_group.py
and tests/test_torch_fed_lm_group.py).

Spawned ranks import this module by name, so it imports torch and the port
only: no JAX.  Each body runs the same in a rank of a model group (its
share of the weights, sliced from the whole tree it is handed) and,
unsharded, in the test process, so one body gives both sides of the
comparison.
"""
from __future__ import annotations

import hashlib

import torch

from repro_torch.core.convert import params_from_numpy, to_numpy
from repro_torch.core.engine import FederatedEngine, metrics_to_host
from repro_torch.core.flat import FlatSpec
from repro_torch.data.pipeline import LMFederatedData
from repro_torch.launch.mesh import make_model_group
from repro_torch.launch.steps import Knobs, build_train_step
from repro_torch.models.model import build_model, cohort_loss_fn
from repro_torch.sharding.rules import param_specs
from repro_torch.sharding.shard import group_plane, shard_params, share_parts
from repro_torch.utils.trees import tree_leaves


def _share(cfg, whole_np, parallel):
    """This rank's params (the whole tree unsharded)."""
    torch.set_num_threads(1)
    params = params_from_numpy(whole_np)
    if parallel is not None:
        params = shard_params(params, param_specs(params, cfg, parallel.size), parallel.rank,
                              parallel.size)
    return params


def replicated_digest(leaves, parts) -> str:
    """A hash of the bytes of every part the group replicates (whole and
    partial), in order: equal on every rank iff they are bitwise equal."""
    h = hashlib.sha256()
    for t, (dim, pieces) in zip(leaves, parts):
        for off, width, use in pieces:
            if use != "split":
                seg = t if dim is None else t.narrow(dim, off, width)
                h.update(seg.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def train_case(job, parallel=None):
    """``job["steps"]`` train steps of ``job["cfg"]`` from ``job["params"]``
    (a numpy tree of the whole model) on ``job["batch"]`` under each
    ``Knobs(**kw)`` of ``job["knobs"]``: per knobs, this rank's params and
    AdamW moments after the steps (numpy leaves), each step's loss and grad
    norm, and (on a group) the digest of the replicated parts."""
    cfg = job["cfg"]
    params = _share(cfg, job["params"], parallel)
    batch = {k: torch.as_tensor(v) for k, v in job["batch"].items()}
    out = []
    for kw in job["knobs"]:
        step = build_train_step(cfg, Knobs(**kw), parallel)
        p, o, metrics = params, step.opt.init(params), []
        for _ in range(job["steps"]):
            p, o, m = step.fn(p, o, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        res = {"params": [to_numpy(x) for x in tree_leaves(p)],
               "m": [to_numpy(x) for x in tree_leaves(o[1])],
               "v": [to_numpy(x) for x in tree_leaves(o[2])], "metrics": metrics}
        if parallel is not None:
            parts = share_parts(cfg, parallel.size)
            res["digest"] = [replicated_digest(tree_leaves(t), parts) for t in (p, o[1], o[2])]
        out.append(res)
    return out


def fed_case(job, parallel=None):
    """FedCM-family rounds (``job["fed"]``, a port ``FedConfig``) of the LM
    ``job["cfg"]`` from ``job["params"]`` through
    ``FederatedEngine.round_step`` on the injected draws of
    ``job["rounds"]`` (each ``{"batches", "ids", "mask"}`` and, for a
    full-batch spec, ``"full"``, as numpy): this rank's params, momentum
    and second-moment planes after the rounds and each round's metrics.
    With ``job["run_rounds"]`` = n, then n rounds of ``run_rounds`` from
    the same start on the engine's own draws from a generator seeded
    alike on every rank (``"drawn"``: the params plane after them)."""
    cfg, fed = job["cfg"], job["fed"]
    model = build_model(cfg)
    params = _share(cfg, job["params"], parallel)
    spec = FlatSpec.from_tree(params)
    group = None if parallel is None else group_plane(spec, cfg, parallel)
    eng = FederatedEngine(fed, cohort_loss_fn(model, parallel), spec, batch_size=job["B"],
                          device="cpu", model_group=group)
    state = start = eng.init(params, torch.Generator().manual_seed(job.get("seed", 0)))
    rows = []
    for d in job["rounds"]:
        full = None if d.get("full") is None else {k: torch.as_tensor(v)
                                                   for k, v in d["full"].items()}
        state, m = eng.round_step(state, {k: torch.as_tensor(v) for k, v in d["batches"].items()},
                                  torch.as_tensor(d["ids"]), torch.as_tensor(d["mask"]),
                                  full_batches=full)
        rows.append({k: float(v[0]) for k, v in metrics_to_host(m).items()})
    sm = state.server.second_moment
    out = {"params": to_numpy(state.params), "momentum": to_numpy(state.server.momentum),
           "second_moment": None if sm is None else to_numpy(sm), "metrics": rows}
    if job.get("run_rounds"):
        data = LMFederatedData(job["tokens"], device="cpu")
        drawn, _ = eng.run_rounds(start, data, job["run_rounds"])
        out["drawn"] = to_numpy(drawn.params)
    return out


def world(rank, device, jobs):
    """A rank's body: every job of ``jobs`` on the model group, in order
    (``job["kind"]``: ``"train"`` or ``"fed"``)."""
    bodies = {"train": train_case, "fed": fed_case}
    return [bodies[job["kind"]](job, make_model_group()) for job in jobs]
