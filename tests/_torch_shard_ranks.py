"""Rank bodies of the cohort-sharding tests (tests/test_torch_cohort_shard.py).

Spawned ranks import this module by name, so it imports torch and the port
only: no JAX, and nothing of ``_torch_parity`` (which imports JAX).  Each
function here runs the same in a rank of a cohort world (``group`` the
default process group) and, unsharded, in the test process (``group``
None), so one body gives both sides of a bitwise comparison.

The shapes are the reference's tests/test_cohort_shard.py: 32 clients, a
cohort of 16 (or a ragged 10, padded to 12 over 4 ranks), K = 2 local
steps, batch 8, an MLP 8-16-4 on a 4-class synthetic task.  The specs of
tests/_torch_user_specs.py (runtime-registered, escape hatches) are
registered in every rank.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
from repro_torch.core.convert import state_from_numpy, state_to_numpy
from repro_torch.core.engine import FederatedEngine, metrics_to_host
from repro_torch.core.flat import (
    FlatSpec, cohort_mean_scatter, cohort_to_columns, masked_mean, pad_cohort,
)
from repro_torch.data import FederatedData, make_synthetic_classification
from repro_torch.models.small import classification_loss, mlp_classifier
from repro_torch.sharding.rules import padded_cohort

from _torch_user_specs import registered

DIMS = (8, 16, 4)
N_CLIENTS, K, B = 32, 2, 8
# the adaptive specs take the reference benchmark's absolute-lr step
ALGO_SETTINGS = {a: {"eta_g": 0.03, "alpha": 0.1} for a in ("fedadam", "fedadagrad", "fedyogi")}


def case(name, algo, cohort=16, participation="fixed", rounds=3, ring=None, compression=None,
         fault=None, cohort_shard=0):
    """One engine run: ``ring = (D, S)`` runs ``run_rounds_async`` (drained),
    else ``run_rounds``; ``compression`` a kind, ``fault`` FaultConfig
    keywords; ``cohort_shard`` > 0 asks for the default group through the
    config instead of passing it to the engine."""
    return {"name": name, "algo": algo, "cohort": cohort, "participation": participation,
            "rounds": rounds, "ring": ring, "compression": compression, "fault": fault,
            "cohort_shard": cohort_shard}


def config(c) -> FedConfig:
    comp = None if c["compression"] is None else CompressionConfig(kind=c["compression"],
                                                                   topk_frac=0.25)
    fault = None if c["fault"] is None else FaultConfig(**c["fault"])
    return FedConfig(algo=c["algo"], num_clients=N_CLIENTS, cohort_size=c["cohort"],
                     local_steps=K, participation=c["participation"], compression=comp,
                     fault=fault, cohort_shard=c["cohort_shard"],
                     **ALGO_SETTINGS.get(c["algo"], {}))


def _group():
    return dist.group.WORLD if dist.is_initialized() else None


def run_case(c, device="cpu", group=None):
    """``c``'s run from a fixed seed: ``{"state": numpy planes, "metrics":
    numpy per-round metrics, "shards": the cohort group's size (0 when
    unsharded)}``."""
    cfg = config(c)
    x, y, _, _ = make_synthetic_classification(n_classes=DIMS[-1], dim=DIMS[0], n_train=3200,
                                               n_test=8, seed=0)
    data = FederatedData(x, y, N_CLIENTS, seed=0, device=device)
    model = mlp_classifier(DIMS)
    params = model.init(torch.Generator().manual_seed(0))
    eng = FederatedEngine(cfg, classification_loss(model.apply), FlatSpec.from_tree(params),
                          batch_size=B, device=device, cohort_group=group)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    state = eng.init(params, gen)
    if c["ring"] is None:
        state, ms = eng.run_rounds(state, data, c["rounds"])
    else:
        state, ms = eng.run_rounds_async(state, data, c["rounds"], pipeline_depth=c["ring"][0],
                                         staleness=c["ring"][1])
    return {"state": state_to_numpy(state), "metrics": metrics_to_host(ms),
            "shards": 0 if eng.cohort_group is None else dist.get_world_size(eng.cohort_group)}


def run_injected(job, device="cpu", group=None):
    """Rounds on injected draws (the reference's, made in the test process)
    from a numpy start state: ``job`` holds the port config, the numpy
    params / momentum / client states, the MLP's dims and batch size, and
    one dict of numpy draws a round (``batches``, ``ids``, ``mask``).
    Returns the numpy planes after the rounds and the per-round metrics."""
    cfg = job["cfg"]
    state, spec = state_from_numpy(job["params"], cfg, momentum=job["momentum"],
                                   client_states=job["client_states"], device=device)
    model = mlp_classifier(job["dims"])
    eng = FederatedEngine(cfg, classification_loss(model.apply), spec, batch_size=job["batch"],
                          device=device, cohort_group=group)
    rows = []
    for d in job["draws"]:
        batches = {"x": torch.tensor(d["batches"]["x"], device=device),
                   "y": torch.tensor(d["batches"]["y"], device=device).long()}
        state, ms = eng.round_step(state, batches, torch.tensor(d["ids"], device=device),
                                   torch.tensor(d["mask"], device=device))
        rows.append(metrics_to_host(ms))
    return {"state": state_to_numpy(state),
            "metrics": {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}}


def columns_block(dtype: str, rank: int, n_shards: int, C_pad: int = 12, P: int = 37):
    """``cohort_to_columns`` of rank ``rank``'s rows of a seeded ``(C_pad,
    P)`` plane against the column block the layout promises: the whole
    cohort's columns ``[r·chunk, (r+1)·chunk)`` of the plane padded to
    ``n·chunk``.  Returns True when they are equal bit for bit."""
    g = torch.Generator().manual_seed(7)
    full = (torch.randn(C_pad, P, generator=g) * 50).to(getattr(torch, dtype))
    c_loc, chunk = C_pad // n_shards, -(-P // n_shards)
    got = cohort_to_columns(full[rank * c_loc:(rank + 1) * c_loc], dist.group.WORLD, n_shards)
    want = torch.nn.functional.pad(full, (0, chunk * n_shards - P))[:, rank * chunk:
                                                                    (rank + 1) * chunk]
    return got.dtype == want.dtype and torch.equal(got, want)


def mean_inputs(C: int = 10, P: int = 37):
    """A seeded ``(C, P)`` plane, a 0/1 weight row with inactive rows, and
    its count: the inputs of the ``cohort_mean_scatter`` jobs."""
    g = torch.Generator().manual_seed(11)
    plane = torch.randn(C, P, generator=g)
    w = (torch.rand(C, generator=g) < 0.7).to(torch.float32)
    return plane, w, w.sum()


def mean_scatter(agg: str, rank: int, n_shards: int):
    """``cohort_mean_scatter`` of this rank's rows of ``mean_inputs`` padded
    to the sharded cohort (pad rows weigh 0), as numpy."""
    plane, w, n_active = mean_inputs()
    c_pad = padded_cohort(plane.shape[0], n_shards)
    c_loc = c_pad // n_shards
    rows = pad_cohort(plane, c_pad)[rank * c_loc:(rank + 1) * c_loc]
    return cohort_mean_scatter(rows, pad_cohort(w, c_pad, "zero"), n_active, dist.group.WORLD,
                               n_shards, getattr(torch, agg)).numpy()


def unsharded_mean(agg: str):
    """``masked_mean`` of the whole ``mean_inputs`` plane, as numpy."""
    return masked_mean(*mean_inputs(), getattr(torch, agg)).numpy()


def world(rank, device, jobs):
    """A rank's body: run every ``(kind, job)`` of ``jobs`` in order on the
    cohort group and return the results in the same order.  The specs of
    tests/_torch_user_specs.py are registered throughout."""
    n = dist.get_world_size()
    out = []
    with registered():
        for kind, job in jobs:
            if kind == "case":
                out.append(run_case(job, device, None if job["cohort_shard"] else _group()))
            elif kind == "injected":
                out.append(run_injected(job, device, _group()))
            elif kind == "columns":
                out.append(columns_block(job, rank, n))
            elif kind == "mean_scatter":
                out.append(mean_scatter(job, rank, n))
            elif kind == "refusal":
                out.append(refusal(job, device))
            else:
                raise ValueError(f"unknown job kind {kind!r}")
    return out


def refusal(job, device):
    """The engine's refusal of ``job`` in this world, as text."""
    try:
        run_case(job, device)
    except ValueError as e:
        return str(e)
    return None


def killed_rank(rank, device):
    """A world whose rank 1 dies (no clean-up, no report) while rank 0 waits
    in a collective."""
    if rank == 1:
        os._exit(9)
    dist.barrier()
    return rank


def hang(rank, device, seconds):
    """A world whose ranks outlive its deadline."""
    time.sleep(seconds)
    return rank
