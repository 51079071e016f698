"""Rank bodies of tests/test_torch_dryrun.py: the real side of the dry-run's
comparison, on a 2 x 2 grid of gloo ranks.

Spawned ranks import this module by name, so it imports torch and the port
only: no JAX.  Each case builds the step that ``launch.dryrun.run_one``
builds (``dryrun.build_step``, the same knobs, layout and rows), on real CPU
tensors, and runs it under the same instruments (``dryrun.measure``: the
flop counter, the census and MemTracker); ``ParallelContext.counts`` is what
the model's collectives tallied.  Then one FedCM round of
``launch.federated_llm.run`` in its ``--cohort-shard 2 --model-parallel 2``
layout, and one on the per-leaf tree path over each model group.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import dryrun, federated_llm
from repro_torch.launch.hlo_stats import comparable_counts
from repro_torch.launch.mesh import make_grid
from repro_torch.launch.steps import make_parallel, param_mode

GRID = (2, 2)  # (data, model)
B, S = 4, 16  # the batch's rows and length
SHAPE = {"train": "train_4k", "decode": "decode_32k"}
KNOBS = {"microbatches": 1, "remat": "none"}
# Each case's step runs REPEATS times and its least MemTracker peak is kept:
# gloo's worker thread may still hold a collective's buffers for a moment
# after the call returns (the fake group holds none), so a buffer freed right
# after an all_gather (``layers._data_gather``'s parts) can outlive the next
# allocation in one run and not in another; the least peak is the step's own
REPEATS = 2
# the FedCM round: federated_llm.run's arguments (a cohort the data group divides)
FED_RUN = dict(n_clients=8, cohort=4, local_steps=1, batch=2, seq=16, rounds=1)


def case_config(arch: str):
    """The arch's reduced config at one period: one layer (seamless one
    encoder and one decoder layer)."""
    cfg = reduced(get_config(arch))
    cut = {"n_layers": 1, "n_encoder_layers": 1} if cfg.is_encoder_decoder else {"n_layers": 1}
    return dataclasses.replace(cfg, **cut)


def case_step(arch: str, kind: str, groups, device):
    """``(parallel, inputs, step)`` of ``run_one(arch, SHAPE[kind], *GRID,
    cfg=case_config(arch), overrides=KNOBS, batch=B, seq=S)`` on this rank."""
    cfg = case_config(arch)
    knobs = dryrun.knobs_for(arch, SHAPE[kind], KNOBS)
    train = kind == "train"
    parallel = dryrun.grid_parallel(cfg, *GRID, groups, None if train else knobs,
                                    None if train else B)
    layout = dryrun.share_layout(cfg, *GRID, "train" if train else param_mode(knobs),
                                 knobs.param_dtype)
    inputs, step = dryrun.build_step(cfg, kind, knobs, parallel, layout, B, S, device=device)
    return parallel, inputs, step


def world(rank, device, cases):
    """Each ``(arch, kind)`` of ``cases``, then the FedCM round, on this
    rank of the 2 x 2 grid: the step's ``ParallelContext.counts``, its
    flops and MemTracker peak; the round's launches and counts."""
    torch.set_num_threads(1)
    groups = make_grid(*GRID)
    out = {}
    for arch, kind in cases:
        peaks = []
        for i in range(REPEATS):
            parallel, inputs, step = case_step(arch, kind, groups, device)
            made = inputs()
            res = dryrun.measure({"model": groups[0], "data": groups[1]}, lambda: made, step,
                                 exec_only=i > 0)
            del made
            peaks.append(res["memory"]["total"])
            if i == 0:
                first = {"counts": comparable_counts(parallel.counts), "flops": res["flops"],
                         "census": res["census"].collective_stats()}
        out[(arch, kind)] = {**first, "peak": min(peaks)}
    fed = federated_llm.run(case_config("llama3.2-1b"), device=str(device),
                            parallel=make_parallel(groups[0]), cohort_group=groups[1],
                            **FED_RUN)
    out["fed"] = {"counts": comparable_counts(fed.by_rank[0]["collectives"]),
                  "launches": fed.by_rank[0]["launches"]}
    # the per-leaf tree path on the model group alone (each data row runs its own)
    tree = federated_llm.run(case_config("llama3.2-1b"), device=str(device),
                             parallel=make_parallel(groups[0]),
                             variant={"use_flat_plane": False}, **FED_RUN)
    out["fed_tree"] = {"counts": comparable_counts(tree.by_rank[0]["collectives"]),
                       "launches": tree.by_rank[0]["launches"]}
    return out
