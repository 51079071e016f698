"""The FedCM round's dry-run: one rank of a cohort × model grid on fake
tensors, with no card (counterpart of ``repro.launch.fed_dryrun``).

Runs ``rounds`` whole FedCM rounds (Algorithm 2) of a llama3-family LM cut
to ``N_LAYERS`` layers at its published widths, in the layout of
``launch.federated_llm``'s ``--cohort-shard D --model-parallel M``
(``_model_parallel_rank``): ``D · M`` ranks on a grid, the cohort split
over each data group (the fold's ``all_to_all`` to column blocks and
``all_gather`` back, ``kernels.server_update.ops.scatter_fold``) and each
client over each model group (the model's ``all_reduce``s).  This process
acts as one rank of a fake world (``launch.mesh.fake_world``) under
``FakeTensorMode``, the census (``launch.hlo_stats.CensusMode``), the flop
counter and ``MemTracker``, as ``launch.dryrun`` does; the kernels take
their ``FakeTensor`` branch, ``fed_direction`` K times a round and
``server_update`` once a fold row.

The reference falls back to its per-leaf tree path when the params are
tensor-sharded over ``"model"`` (``_tensor_sharded_reason``: a flat
concatenate would all-gather them).  The port keeps the flat plane
(``flat_plane_reason``): a rank's plane is its own share's columns
(``sharding.shard.group_plane``), so nothing is gathered into it — a route
difference.  The port's tree path runs on a model group too (its fault
layer and escape hatches as well), but not yet with the cohort over data
beside it, this layout (ROADMAP A.16 (e) 5).  The round's data are each
client's corpus of ``n_seqs`` sequences on every rank, as
``federated_llm`` holds them; the round draws its cohort and minibatches
from them.

    PYTHONPATH=src python -m repro_torch.launch.fed_dryrun [--algo fedavg]
        [--momentum-dtype bfloat16] [--cohort 16] [--k 2] [--variant tag]
        [--mesh 2x2] [--rank 3] [--rounds 1]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional

import torch

from repro_torch.launch.dryrun import DEVICE, OUT_DIR, parse_mesh

N_LAYERS = 4
BATCH = 8
SEQ = 1024
ARCH = "llama3.2-1b"


def flat_plane_reason(parallel) -> str:
    """Why the round keeps the flat plane on a model group (the reference's
    ``_tensor_sharded_reason`` falls back to the tree path there)."""
    if parallel is None:
        return "params unsharded: the flat (P,) plane holds the whole model"
    return ("each rank's plane is its model group share's columns "
            "(sharding.shard.group_plane): nothing is gathered into it")


def run(variant: str = "baseline", *, algo: str = "fedcm", cohort: int = 16,
        local_steps: int = 2, momentum_dtype: str = "float32", param_dtype: str = "float32",
        aggregate_dtype: str = "float32", data: int = 16, model: int = 16, rank: int = 0,
        rounds: int = 1, n_clients: int = 4096, n_seqs: int = BATCH, batch: int = BATCH,
        seq: int = SEQ, eta_l: float = 0.05, cfg=None, cfg_overrides: Optional[dict] = None,
        exec_only: bool = False, out: Optional[Path] = OUT_DIR, quiet: bool = False,
        tag: str = "", use_flat_plane: bool = True) -> dict:
    """One rank's dry-run of ``rounds`` FedCM rounds over ``ARCH`` (cut to
    ``N_LAYERS`` layers unless ``cfg_overrides`` says otherwise) with the
    cohort over ``data`` ranks and each client over ``model`` ranks, the
    round ``launch.federated_llm`` builds (``fed_config``, ``build_engine``,
    ``LMFederatedData``) over each client's corpus of ``n_seqs`` sequences;
    returns the result and, with ``out``, writes ``fedround_<variant>.json``
    there (``tag`` names the file in place of the variant).  ``cfg`` runs
    another llama config (a reduced one) as it is, ``cfg_overrides`` cut
    it.  ``use_flat_plane=False`` runs the per-leaf tree path (on a model
    group alone: with the cohort over data it raises, ROADMAP
    A.16 (e) 5)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import LMFederatedData
    from repro_torch.launch.dryrun import fake_share, grid_parallel, measure, share_layout
    from repro_torch.launch.federated_llm import build_engine, fed_config
    from repro_torch.launch.hlo_stats import blas_workspace_bytes, op_census, parallel_counts
    from repro_torch.launch.mesh import (
        HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32, fake_world,
    )
    from repro_torch.sharding.rules import check_model_parallel

    if cfg is None:
        cfg = dataclasses.replace(get_config(ARCH), n_layers=N_LAYERS, name="llama3-fedround",
                                  param_dtype=param_dtype)
    cfg = dataclasses.replace(cfg, **(cfg_overrides or {}))
    check_model_parallel(cfg, model)
    fed = fed_config(n_clients=n_clients, cohort=cohort, local_steps=local_steps, eta_l=eta_l,
                     rounds=rounds, algo=algo, momentum_dtype=momentum_dtype,
                     aggregate_dtype=aggregate_dtype, use_flat_plane=use_flat_plane)
    layout = share_layout(cfg, 1, model)  # a client's model share, no FSDP slice

    with fake_world(data, model, rank) as groups, FakeTensorMode(allow_non_fake_inputs=True):
        # federated_llm's ranks: the model group's context alone (the world's
        # at data 1), and the data group as the cohort group
        parallel = grid_parallel(cfg, 1, model, (groups[0], None)) if model > 1 else None
        cohort_group = groups[1] if data > 1 else None

        def inputs():
            toks = torch.zeros((n_clients, n_seqs, seq + 1), dtype=torch.int64, device=DEVICE)
            return {"Parameter": fake_share(layout, DEVICE), "Other": toks,
                    "corpus": LMFederatedData(toks, device=DEVICE)}

        def step(made):
            params, corpus = made.pop("Parameter"), made["corpus"]
            eng, _, _ = build_engine(cfg, fed, params, batch=batch, device=DEVICE,
                                     parallel=parallel, cohort_group=cohort_group)
            state = eng.init(params, torch.Generator())
            del params  # as federated_llm: the engine holds the flat plane
            for _ in range(rounds):
                state, _ = eng.run_round(state, corpus)
            return state

        res = measure({"model": groups[0], "cohort": groups[1]}, inputs, step, exec_only,
                      device=DEVICE)
    census = res["census"]
    coll = census.collective_stats()
    flops = res["flops"] or 0
    coll_bytes = coll["total"]["bytes"]
    peak_flops = PEAK_FLOPS_BF16 if cfg.dtype == "bfloat16" else PEAK_FLOPS_F32
    result = {
        "variant": variant, "algo": algo, "cohort": cohort, "local_steps": local_steps,
        "rounds": rounds, "momentum_dtype": momentum_dtype, "param_dtype": param_dtype,
        "aggregate_dtype": aggregate_dtype, "arch": ARCH, "n_layers": cfg.n_layers,
        "batch": batch, "seq": seq, "n_clients": n_clients, "n_seqs": n_seqs,
        "mesh": f"{data}x{model}", "chips": data * model, "rank": rank,
        "resolved_mesh": {"axes": ["data", "model"], "shape": [data, model]},
        "cohort_axis": "data", "cohort_parallelism": "process group (scatter_fold)",
        "use_flat_plane": fed.use_flat_plane, "flat_fallback_reason": None,
        "flat_plane_reason": flat_plane_reason(parallel),
        "seconds": round(res["seconds"], 3),
        "flops_per_device": res["flops"], "kernel_flops": census.kernel_flops,
        "op_bytes_per_device": census.op_bytes, "kernel_bytes": census.kernel_bytes,
        "collective_bytes_per_device": coll_bytes,
        "collectives": {k: v for k, v in coll.items() if k != "total"},
        "collectives_by_group": {g: census.group_stats(g) for g in sorted(census.by_group)},
        "parallel_counts": parallel_counts(census),
        "launches": dict(sorted(census.launches.items())),
        "host_reads": census.host_reads, "op_census": op_census(census.ops),
        "memory": res["memory"], "blas_workspace_bytes": blas_workspace_bytes(census),
        "peak_bytes": res["memory"].get("total", 0) + blas_workspace_bytes(census),
        "roofline": {
            "compute_s": (flops + census.kernel_flops) / peak_flops,
            "memory_s": (census.op_bytes + census.kernel_bytes) / HBM_BW,
            "collective_s": coll_bytes / NVLINK_BW,
        },
    }
    terms = result["roofline"]
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"), key=terms.get)
    if out is not None:
        out = Path(out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{tag or 'fedround_' + variant}.json").write_text(json.dumps(result, indent=1))
    if not quiet:
        r = result["roofline"]
        print(f"== fed round [{variant}] algo={algo} cohort={cohort} K={local_steps} "
              f"rounds={rounds} mesh={data}x{model} rank {rank} mdtype={momentum_dtype} ==")
        print(f"  {result['seconds']} s  use_flat_plane={fed.use_flat_plane} "
              f"({result['flat_plane_reason']})  peak={result['peak_bytes'] / 2 ** 30:.2f}GiB")
        print(f"  FLOPs={flops:.3e} (+ kernels {census.kernel_flops:.3e})  "
              f"op bytes={census.op_bytes:.3e}  coll={coll_bytes:.3e}  "
              f"launches {result['launches']}")
        print("  collectives: " + ", ".join(
            f"{g}/{k} {v['count']}x {v['bytes']:.3e}B"
            for g, st in result["collectives_by_group"].items()
            for k, v in st.items() if k != "total" and v["count"]))
        print(f"  roofline: compute={r['compute_s'] * 1e3:.3f}ms memory={r['memory_s'] * 1e3:.3f}ms "
              f"collective={r['collective_s'] * 1e3:.3f}ms → {r['bottleneck']}")
    return result


def run_classifier(cfg, dirichlet: float = 0.6, *, eval_every: int = 25, seed: int = 0,
                   exec_only: bool = False) -> dict:
    """``launch.fed_train.run_federated``'s synchronous run of ``cfg`` (the
    MLP classifier over the synthetic Dirichlet-split task, the port's main
    path) on one rank, as ``run`` dry-runs the LM's: ``build_federated``'s
    data, model, engine and test set on fake tensors, then chunks of
    ``eval_every`` rounds (``run_rounds``), each followed by the test
    set's evaluation, whose host read the census answers.  Returns the
    launches, the census's counts, the peak and the FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.engine import make_eval_fn
    from repro_torch.launch.dryrun import measure
    from repro_torch.launch.hlo_stats import blas_workspace_bytes
    from repro_torch.launch.fed_train import build_federated
    from repro_torch.launch.mesh import fake_world

    with fake_world(1, 1) as groups, FakeTensorMode(allow_non_fake_inputs=True):
        def inputs():
            data, model, params, eng, x_te, y_te = build_federated(cfg, dirichlet, seed=seed,
                                                                   device=DEVICE)
            return {"Parameter": params, "Other": (data.client_x, data.client_y, x_te, y_te),
                    "run": (data, model, eng, x_te, y_te)}

        def step(made):
            params, (data, model, eng, x_te, y_te) = made.pop("Parameter"), made["run"]
            evaluate = make_eval_fn(model.apply)
            state = eng.init(params, torch.Generator())
            r = 0
            while r < cfg.rounds:
                chunk = min(eval_every, cfg.rounds - r)
                state, _ = eng.run_rounds(state, data, chunk)
                r += chunk
                evaluate(eng.params_tree(state), x_te, y_te)
            return state

        res = measure({"model": groups[0], "data": groups[1]}, inputs, step, exec_only,
                      device=DEVICE)
    census = res["census"]
    return {"launches": dict(sorted(census.launches.items())), "host_reads": census.host_reads,
            "flops_per_device": res["flops"], "op_bytes_per_device": census.op_bytes,
            "memory": res["memory"], "blas_workspace_bytes": blas_workspace_bytes(census),
            "peak_bytes": res["memory"].get("total", 0) + blas_workspace_bytes(census),
            "collectives": census.collective_stats(), "seconds": round(res["seconds"], 3)}


def main(argv=None) -> int:
    from repro_torch.launch.mesh import make_production_grid

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--algo", default="fedcm")
    ap.add_argument("--cohort", type=int, default=16)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--momentum-dtype", default="float32")
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--multi-pod", action="store_true", help="the 32 x 16 grid")
    ap.add_argument("--mesh", type=parse_mesh, metavar="DxM", help="any grid (cohort x model)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--out", type=Path, default=OUT_DIR)
    args = ap.parse_args(argv)
    data, model = args.mesh or make_production_grid(args.multi_pod)
    run(args.variant, algo=args.algo, cohort=args.cohort, local_steps=args.k,
        momentum_dtype=args.momentum_dtype, param_dtype=args.param_dtype, data=data,
        model=model, rank=args.rank, rounds=args.rounds, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
