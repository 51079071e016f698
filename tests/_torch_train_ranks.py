"""Rank bodies of the training-on-a-group tests (tests/test_torch_train_group.py
and tests/test_torch_fed_lm_group.py).

Spawned ranks import this module by name, so it imports torch and the port
only: no JAX.  Each body runs the same in a rank of a model group (its
share of the weights, sliced from the whole tree it is handed) and,
unsharded, in the test process, so one body gives both sides of the
comparison.
"""
from __future__ import annotations

import contextlib
import hashlib

import numpy as np
import torch

from _torch_user_specs import registered
from repro_torch.core import engine as engine_mod
from repro_torch.core.convert import params_from_numpy, to_numpy
from repro_torch.core.engine import FederatedEngine, RoundDraws, metrics_to_host
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


def plane(x):
    """A state plane as one numpy row: the flat plane itself, or on the tree
    path the tree's leaves raveled in order (the share plane's layout)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.concatenate([to_numpy(leaf).reshape(-1) for leaf in tree_leaves(x)])


@contextlib.contextmanager
def quarantine_margins(mult: float, out: list):
    """Record, for each quarantine decision by norm, the least relative
    distance of an active row's norm from ``mult`` × the median (the
    engine's threshold): how far the decision is from flipping."""
    real = engine_mod.nanmedian_midpoint

    def spy(v):
        med = real(v)
        act = ~torch.isnan(v)
        if bool(act.any()) and mult > 0.0:
            out.append(float(((v[act] - mult * med).abs() / (mult * med)).min()))
        return med

    engine_mod.nanmedian_midpoint = spy
    try:
        yield
    finally:
        engine_mod.nanmedian_midpoint = real


def fed_case(job, parallel=None, cohort_group=None):
    """FedCM-family rounds (``job["fed"]``, a port ``FedConfig``) of the LM
    ``job["cfg"]`` from ``job["params"]`` through
    ``FederatedEngine.round_step`` on the injected draws of
    ``job["rounds"]`` (each ``{"batches", "ids", "mask"}`` and, for a
    full-batch spec, ``"full"``, and with faults ``"draws"``, the
    ``RoundDraws`` fields, as numpy): this rank's params, momentum and
    second-moment planes after the rounds (``plane``), each round's metrics
    and the quarantine's margins; the cohort split over ``cohort_group``
    when given (a grid's data group).  ``job["specs"]`` names the user specs of
    ``_torch_user_specs`` it registers.  With ``job["run_rounds"]`` = n,
    then n rounds of ``run_rounds`` from the same start on the engine's own
    draws (the fault layer's hash draws too) from a generator seeded alike
    on every rank (``"drawn"``: the params plane after them;
    ``"drawn_metrics"``)."""
    mult = 0.0 if job["fed"].fault is None else job["fed"].fault.quarantine_norm_mult
    margins: list = []
    with registered(job.get("specs", ())), quarantine_margins(mult, margins):
        out = _fed_rounds(job, parallel, cohort_group)
    return {**out, "margins": margins}


def _fed_rounds(job, parallel, cohort_group):
    cfg, fed = job["cfg"], job["fed"]
    model = build_model(cfg)
    params = _share(cfg, job["params"], parallel)
    spec = FlatSpec.from_tree(params)
    group = None if parallel is None else group_plane(spec, cfg, parallel)
    eng = FederatedEngine(fed, cohort_loss_fn(model, parallel), spec, batch_size=job["B"],
                          device="cpu", cohort_group=cohort_group, model_group=group)
    state = start = eng.init(params, torch.Generator().manual_seed(job.get("seed", 0)))
    rows = []
    for d in job["rounds"]:
        full = None if d.get("full") is None else {k: torch.as_tensor(v)
                                                   for k, v in d["full"].items()}
        draws = None if d.get("draws") is None else RoundDraws(
            **{k: torch.as_tensor(v) for k, v in d["draws"].items()})
        state, m = eng.round_step(state, {k: torch.as_tensor(v) for k, v in d["batches"].items()},
                                  torch.as_tensor(d["ids"]), torch.as_tensor(d["mask"]),
                                  draws=draws, full_batches=full)
        rows.append({k: float(v[0]) for k, v in metrics_to_host(m).items()})
    out = {"params": plane(state.params), "momentum": plane(state.server.momentum),
           "second_moment": plane(state.server.second_moment), "metrics": rows}
    if job.get("run_rounds"):
        data = LMFederatedData(job["tokens"], device="cpu")
        drawn, ms = eng.run_rounds(start, data, job["run_rounds"])
        out["drawn"] = plane(drawn.params)
        host = metrics_to_host(ms)
        out["drawn_metrics"] = [{k: float(v[i]) for k, v in host.items()}
                                for i in range(job["run_rounds"])]
    return out


def world(rank, device, jobs):
    """A rank's body: every job of ``jobs`` on the model group, in order
    (``job["kind"]``: ``"train"`` or ``"fed"``)."""
    bodies = {"train": train_case, "fed": fed_case}
    return [bodies[job["kind"]](job, make_model_group()) for job in jobs]
