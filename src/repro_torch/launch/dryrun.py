"""The dry-run: one rank's share of a train, prefill or decode step on a
``data`` × ``model`` grid, on fake tensors, with no card (counterpart of
``repro.launch.dryrun``).

For each (arch × shape × grid) it builds that rank's share of the params as
``FakeTensor``s (shapes, dtypes and a device, ``meta``: no memory), opens a
fake world of ``data · model`` ranks in this one process
(``launch.mesh.fake_world``), builds the port's own step for the layout —
``launch.steps.build_train_step`` with FSDP over data, or
``build_prefill_step`` / ``build_serve_step`` with the batch split over data
where ``rules.serve_splits_batch`` says so and else each attention cache's
sequence slab — and runs it once under ``FakeTensorMode``,
``FlopCounterMode``, the census (``launch.hlo_stats.CensusMode``) and torch's
``MemTracker``.  Eager PyTorch runs every layer, so nothing is extrapolated:
the reference compiles 2- and 4-period programs and extrapolates its full
depth, since XLA counts a loop body once.  The hand kernels take their
``FakeTensor`` branch (``kernels.is_fake``): each allocates what its launch
would and records the launch, and nothing is built, so the dry-run needs no
``nvcc`` either.

What one rank reports (``run_one``; JSON under ``--out``, ``build/dryrun/``
by default): its share's shapes and bytes; ``peak_bytes`` and MemTracker's
categories (``memory``, the card's tensors: the functional model registers
no modules, so gradients count as activations, and the params, the
optimizer state and the step's inputs are tagged by the dry-run) plus the
cuBLAS workspaces the step's GEMMs take on the card
(``blas_workspace_bytes``); ``flops_per_device`` (matmul and
attention FLOPs of the aten ops, from the flop counter) beside
``kernel_flops`` (the hand kernels'); ``op_bytes_per_device``, the inputs
plus outputs of every aten op — what eager PyTorch moves with no fusion,
not XLA's "bytes accessed" — beside ``kernel_bytes``; ``launches`` by
kernel; the collective census (``collectives``, by kind and, in
``collectives_by_group``, by group; the bytes of a collective are its result
on this rank, ``sent`` its input); the aten ``op_census``; and an H100
roofline (``launch.mesh`` constants: compute at the activation dtype's peak,
memory at HBM, collectives at one NVLink direction) with its bottleneck.

Each rank's share holds every floating leaf in ``Knobs.param_dtype`` (bf16
by default; integer leaves keep theirs, maverick's f32 router is cast like
the rest), as the reference's ``_params_sds`` casts them; the step's update
stays f32.  ``seq_shard_acts`` is carried into the JSON's knobs, as the
reference reports it.

Route differences from the reference: token ids are int64 (the reference's
int32); the port's knobs have no ``scan_unroll`` (eager code runs every
layer); a fake group is no NCCL world, but the
FSDP gradients take NCCL's ``reduce_scatter`` route on it (the card's);
prefill and decode use one param layout, ``Knobs.serve_params``'s (the
reference prefills in the train layout); the decode cache holds the
model group's kv heads, split over data by rows or by a sequence slab.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--quiet]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape prefill_32k \\
        --mesh 2x2 --rank 3
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from contextlib import ExitStack
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
# the fake tensors' device: any but the CPU takes the card's route through the
# kernel wrappers (``ops.py`` sends only CPU tensors to the plain version);
# fake ``cuda`` tensors cannot be indexed where torch has no CUDA device guard
# (a CPU-only build, or a host with no card visible), ``meta`` ones can
DEVICE = "meta"

# per-arch knobs of the train step, the reference's (its scan_unroll dropped:
# eager code runs every layer); microbatches and the moment dtype are train-only
ARCH_KNOBS = {
    "llama4-maverick-400b-a17b": dict(moment_dtype="bfloat16", microbatches=16,
                                      grad_accum_dtype="bfloat16"),
    "dbrx-132b": dict(microbatches=8, grad_accum_dtype="bfloat16"),
    "chameleon-34b": dict(microbatches=16),
    "gemma3-12b": dict(microbatches=4),
    "qwen3-14b": dict(microbatches=8),
    "starcoder2-7b": dict(microbatches=4),
    "seamless-m4t-large-v2": dict(microbatches=2),
    "zamba2-7b": dict(microbatches=4),
    "llama3.2-1b": dict(microbatches=2),
    "mamba2-1.3b": dict(microbatches=4),
}

# long_500k: sub-quadratic archs only
LONG_OK = {"mamba2-1.3b", "zamba2-7b", "gemma3-12b", "starcoder2-7b"}

# MemTracker's categories → the dry-run's names
CATEGORIES = {"Parameter": "params", "Gradient": "gradients", "Optstate": "optimizer_state",
              "Activation": "activations", "Temp": "temporaries", "Other": "inputs",
              "Buffer": "buffers"}


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    """Why ``arch`` does not run ``shape_name``, or None when it does."""
    if shape_name == "long_500k" and arch not in LONG_OK:
        return "full-attention family: long_500k requires sub-quadratic attention (DESIGN.md §6)"
    return None


def knobs_for(arch: str, shape_name: str, overrides: Optional[dict] = None):
    """The step's ``launch.steps.Knobs`` for ``arch`` at ``shape_name``:
    ``ARCH_KNOBS`` (microbatches and the moment dtype for training only)
    updated by ``overrides``."""
    from repro_torch.launch.steps import Knobs

    kw = dict(ARCH_KNOBS.get(arch, {}))
    if SHAPES[shape_name].kind != "train":
        kw.pop("microbatches", None)  # grad accumulation is train-only
        kw.pop("moment_dtype", None)
    if overrides:
        kw.update(overrides)
    return Knobs(**kw)


def share_layout(cfg, data: int, model: int, mode: str = "train",
                 param_dtype: Optional[str] = None):
    """``(treedef, [(path, shape, dtype)])``: each leaf of ``cfg``'s params
    tree with its shape on one rank of a ``data`` × ``model`` grid in the
    layout ``mode`` — the model group's share (``rules.split_dim``), then its
    data slice (``rules.fsdp_dim``) — and its dtype: the init's, or every
    floating leaf's ``param_dtype`` when given (``Knobs.param_dtype``, the
    reference's ``_params_sds``).  Every rank's is the same.  Built from
    ``meta`` tensors; call it outside a ``FakeTensorMode``, under which the
    whole model's would be fake tensors that a ``MemTracker`` counts."""
    from repro_torch.sharding.rules import _keys, fsdp_dim, local_shape, split_dim
    from repro_torch.sharding.shard import param_shapes
    from repro_torch.utils.trees import tree_flatten_with_path

    leaves, treedef = tree_flatten_with_path(param_shapes(cfg))
    out = []
    for p, leaf in leaves:
        keys, shape = _keys(p), tuple(leaf.shape)
        local = list(local_shape(shape, split_dim(keys, shape, model, cfg), model)
                     if model > 1 else shape)
        f = fsdp_dim(keys, shape, data, model, cfg, mode)
        if f is not None:
            local[f] //= data
        dtype = leaf.dtype
        if param_dtype is not None and dtype.is_floating_point:
            dtype = getattr(torch, param_dtype)
        out.append((p, tuple(local), dtype))
    return treedef, out


def share_shapes(cfg, data: int, model: int, mode: str = "train") -> Dict[str, tuple]:
    """``share_layout``'s shapes by params-tree path."""
    return {p: shape for p, shape, _ in share_layout(cfg, data, model, mode)[1]}


def fake_share(layout, device=DEVICE) -> Any:
    """The rank's share of a ``share_layout`` as zeros on ``device`` (under
    ``FakeTensorMode``: fake tensors, no memory), in the params tree."""
    from repro_torch.utils.trees import tree_unflatten

    treedef, leaves = layout
    return tree_unflatten(treedef, [torch.zeros(shape, dtype=dtype, device=device)
                                    for _, shape, dtype in leaves])


def grid_parallel(cfg, data: int, model: int, groups, knobs=None, batch: Optional[int] = None):
    """The rank's ``ParallelContext`` on the world of ``make_grid``'s
    ``groups``, as the port's launchers make it: none on one rank, the
    model group's alone at data 1, else the grid's (training's FSDP layout
    when ``knobs`` is None, else ``knobs.serve_params``'s, serving
    ``batch`` rows)."""
    from repro_torch.launch.steps import make_parallel

    model_group, data_group = groups
    if data * model == 1:
        return None
    if data == 1:
        return make_parallel(model_group)
    return make_parallel(model_group, data_group, cfg=cfg, knobs=knobs, batch=batch)


class _Tracker:
    """MemTracker with the dry-run's own tensors tagged by category."""

    def __init__(self) -> None:
        from torch.distributed._tools.mem_tracker import MemTracker

        self.mt = MemTracker()

    def tag(self, tree, category: str) -> None:
        """Count ``tree``'s tensors under MemTracker's ``category``
        (``"Parameter"``, ``"Optstate"``, ``"Other"``)."""
        from torch.distributed._tools import mem_tracker as mtm
        from torch.utils._pytree import tree_leaves

        ref = getattr(mtm._MemRefType, {"Parameter": "PARAM", "Optstate": "OPT"}.get(
            category, "OTH"))
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):  # MemTracker's own tagging (torch 2.11–2.13)
                self.mt._update_and_maybe_create_winfos(t, ref)

    def snapshot(self, kind: str = "peak", device=None) -> Dict[str, int]:
        """The categories' bytes, summed over the devices, or ``device``'s
        alone (the card's memory, as ``max_memory_allocated`` counts it)."""
        snap = self.mt.get_tracker_snapshot(kind)
        total: Dict[str, int] = {}
        for dev, dev_snap in snap.items():
            if device is not None and torch.device(dev).type != torch.device(device).type:
                continue
            for k, v in dev_snap.items():
                name = "total" if k == "Total" else CATEGORIES.get(str(getattr(k, "value", k)),
                                                                   str(k))
                total[name] = total.get(name, 0) + int(v)
        return total


def measure(groups: Dict[str, Any], inputs, step, exec_only: bool = False,
            device=None) -> Dict[str, Any]:
    """Run ``step()`` once under the flop counter (unless ``exec_only``),
    the census and MemTracker: inside the caller's ``FakeTensorMode`` (a
    dry-run) or on real tensors (the same step on a real rank).
    ``inputs()`` makes the step's inputs first, inside MemTracker, as
    ``{category: tree}``, each tree tagged with its category
    (``"Parameter"``, ``"Optstate"``, ``"Other"``); ``step`` takes that
    dict and pops what the run it stands for lets go of (the train step's
    old params and moments, the round's params tree once the engine holds
    its plane), so that they are freed where the run frees them.  Memory
    counts ``device``'s tensors alone where it is given (a dry-run's: not
    the host's, which the card's peak does not hold).  Returns the census,
    FLOPs, memory and wall seconds."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.hlo_stats import CensusMode

    tracker = _Tracker()
    census = CensusMode(groups)
    t0 = time.perf_counter()
    with tracker.mt:
        made = inputs()
        for category, tree in made.items():
            tracker.tag(tree, category)
        before = tracker.snapshot("current", device).get("total", 0)
        with ExitStack() as stack:
            flops = None if exec_only else stack.enter_context(FlopCounterMode(display=False))
            stack.enter_context(census)
            out = step(made)
        del made, out
    return {"census": census, "flops": None if flops is None else int(flops.get_total_flops()),
            "memory": tracker.snapshot("peak", device), "inputs_bytes": before,
            "seconds": time.perf_counter() - t0}


def build_step(cfg, kind: str, knobs, parallel, layout, B: int, S: int, *, gen: int = 0,
               sessions: int = 1, decode_steps: Optional[int] = None, steps: int = 1,
               device=DEVICE):
    """``(inputs, step)`` of ``run_one``'s ``kind`` (``"train"``,
    ``"prefill"``, ``"decode"`` or ``"serve"``, a session) for this rank of
    ``parallel`` (None: one rank), its params of ``layout``
    (``share_layout``) and its rows of a ``B`` × ``S`` batch, on ``device``:
    ``inputs()`` makes the params, state and batch (``Model.input_specs``,
    zeroed) as ``measure`` takes them, and ``step(inputs())`` runs the
    port's step (a serving session: ``launch.serve.SessionSteps``, as
    ``serve.run`` serves it).  A dry-run calls them on fake tensors; a test
    calls them on a real rank, for the same step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.serve import SessionSteps
    from repro_torch.launch.steps import build_prefill_step, build_serve_step, build_train_step
    from repro_torch.models import encdec
    from repro_torch.models.model import build_model
    from repro_torch.utils.trees import tree_map

    model_ = build_model(cfg)
    shape = ShapeConfig(kind, "prefill" if kind == "serve" else kind, S, B)

    def specs():
        return tree_map(torch.Tensor.zero_, model_.input_specs(shape, parallel, device))

    if kind == "train":
        train = build_train_step(cfg, knobs, parallel)

        def inputs():
            params = fake_share(layout, device)
            return {"Parameter": params, "Optstate": train.opt.init(params), "Other": specs()}

        def step(made):
            # p, o, _ = fn(p, o, b): each step's inputs are freed as it returns
            params, opt, b = made.pop("Parameter"), made.pop("Optstate"), made["Other"]
            for _ in range(steps):
                params, opt, _ = train.fn(params, opt, b)
            return params, opt
        return inputs, step

    def inputs():
        ins = specs()
        ins.pop("labels", None)  # a prefill takes the prompt alone
        ins.pop("pos", None)  # a decode step takes its position as an int
        return {"Parameter": fake_share(layout, device), "Other": ins}

    prefill = build_prefill_step(model_, parallel)
    decode = build_serve_step(model_, parallel)

    def step(made):
        params, ins = made["Parameter"], made["Other"]
        if kind == "decode":
            return decode(params, ins["token"], ins["cache"], S - 1)
        if cfg.is_encoder_decoder:  # the prefill is the encode, as serving's
            return encdec.encode(params, ins["src_embeds"], cfg=cfg, use_kernels=True,
                                 parallel=parallel)
        if kind == "prefill":
            return prefill(params, ins["tokens"])
        session = SessionSteps(model_, parallel, ins["tokens"], B, S + gen)
        for s in range(sessions):  # serve.run's sessions, greedy
            st = session.begin(params, s, None)
            for i in range(gen - 1 if decode_steps is None else decode_steps):
                st = session.step(params, st, i)
            tok = session.tokens(st)
            del st  # the session's cache, freed before the next prefill
        return tok
    return inputs, step


def run_one(arch: str, shape_name: str, data: int = 16, model: int = 16, rank: int = 0, *,
            overrides: Optional[dict] = None, cfg_overrides: Optional[dict] = None,
            batch: Optional[int] = None, seq: Optional[int] = None, gen: int = 0,
            sessions: int = 1, decode_steps: Optional[int] = None, steps: int = 1, cfg=None,
            exec_only: bool = False,
            out: Optional[Path] = OUT_DIR, quiet: bool = False, tag: str = "") -> dict:
    """One rank's dry-run of ``arch`` at ``shape_name`` on a ``data`` ×
    ``model`` grid (see the module docstring); returns the result and, with
    ``out``, writes it there as JSON.

    ``cfg`` (default ``arch``'s published config) runs another config of
    the arch (a reduced one, say); ``cfg_overrides`` cut it (``n_layers``,
    ``vocab_size``, …),
    ``overrides`` the knobs, ``batch`` / ``seq`` the shape's rows and
    length.  ``steps`` train steps run in turn.  ``gen`` > 0 makes a
    prefill shape a serving session as ``launch.serve.run`` serves it:
    prefill ``seq`` tokens, merge the cache into a buffer of ``seq + gen``
    positions, then ``gen − 1`` decode steps (or ``decode_steps`` of them),
    ``sessions`` times."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_stats import blas_workspace_bytes, op_census, parallel_counts
    from repro_torch.launch.mesh import (
        HBM_BW, HBM_BYTES, NVLINK_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32, fake_world,
    )
    from repro_torch.launch.steps import param_mode
    from repro_torch.sharding.rules import check_model_parallel

    base = SHAPES[shape_name]
    shape = dataclasses.replace(base, global_batch=batch or base.global_batch,
                                seq_len=seq or base.seq_len)
    cfg = dataclasses.replace(cfg or get_config(arch), **(cfg_overrides or {}))
    check_model_parallel(cfg, model)
    knobs = knobs_for(arch, shape_name, overrides)
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind if not gen else "serve"
    if kind == "serve" and (shape.kind != "prefill" or cfg.is_encoder_decoder):
        raise ValueError("a serving session (gen > 0) runs a decoder-only arch at a prefill "
                         "shape")
    if kind == "train":
        # every data rank keeps >= 1 row a microbatch (the reference's clamp)
        max_m = max(1, B // data)
        if knobs.microbatches > max_m:
            knobs = dataclasses.replace(knobs, microbatches=max_m)
    mode = "train" if kind == "train" else param_mode(knobs)
    dev = DEVICE
    layout = share_layout(cfg, data, model, mode, knobs.param_dtype)

    with fake_world(data, model, rank) as groups, FakeTensorMode(allow_non_fake_inputs=True):
        parallel = grid_parallel(cfg, data, model, groups,
                                 None if kind == "train" else knobs,
                                 None if kind == "train" else B)
        named = {"model": groups[0], "data": groups[1]}

        inputs, step = build_step(cfg, kind, knobs, parallel, layout, B, S, gen=gen,
                                  sessions=sessions, decode_steps=decode_steps, steps=steps,
                                  device=dev)
        res = measure(named, inputs, step, exec_only, device=dev)
    census = res["census"]
    coll = census.collective_stats()
    flops = res["flops"] or 0
    coll_bytes = coll["total"]["bytes"]
    op_bytes = census.op_bytes
    peak_flops = PEAK_FLOPS_BF16 if cfg.dtype == "bfloat16" else PEAK_FLOPS_F32
    mesh = f"{data}x{model}"
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh, "chips": data * model, "rank": rank,
        "kind": kind, "batch": B, "seq": S, "gen": gen, "sessions": sessions,
        "decode_steps": None if kind != "serve" else (
            gen - 1 if decode_steps is None else decode_steps),
        "steps": steps if kind == "train" else None,
        "cfg_overrides": cfg_overrides or {}, "n_layers": cfg.n_layers,
        "knobs": dict(microbatches=knobs.microbatches, remat=knobs.remat,
                      param_dtype=knobs.param_dtype, moment_dtype=knobs.moment_dtype,
                      seq_shard_acts=knobs.seq_shard_acts,
                      grad_accum_dtype=knobs.grad_accum_dtype,
                      serve_params=knobs.serve_params, layout=mode),
        "exec_only": exec_only,
        "share_shapes": {p: list(shape) for p, shape, _ in layout[1]},
        "share_bytes": sum(math.prod(shape) * dtype.itemsize for _, shape, dtype in layout[1]),
        "flops_per_device": res["flops"],
        "kernel_flops": census.kernel_flops,
        "op_bytes_per_device": op_bytes,
        "kernel_bytes": census.kernel_bytes,
        "collective_bytes_per_device": coll_bytes,
        "collectives": {k: v for k, v in coll.items() if k != "total"},
        "collectives_by_group": {g: census.group_stats(g) for g in sorted(census.by_group)},
        "parallel_counts": parallel_counts(census),
        "launches": dict(sorted(census.launches.items())),
        "host_reads": census.host_reads,
        "op_census": op_census(census.ops),
        "memory": res["memory"],
        "blas_workspace_bytes": blas_workspace_bytes(census),
        "peak_bytes": res["memory"].get("total", 0) + blas_workspace_bytes(census),
        "inputs_bytes": res["inputs_bytes"],
        "seconds": round(res["seconds"], 3),
        "roofline": {
            "compute_s": (flops + census.kernel_flops) / peak_flops,
            "memory_s": (op_bytes + census.kernel_bytes) / HBM_BW,
            "collective_s": coll_bytes / NVLINK_BW,
        },
    }
    result["fits_hbm"] = result["peak_bytes"] <= HBM_BYTES
    terms = result["roofline"]
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"), key=terms.get)
    result["bottleneck"] = terms["bottleneck"]
    if out is not None:
        out = Path(out)
        out.mkdir(parents=True, exist_ok=True)
        name = tag or f"{arch}_{shape_name}_{mesh}_rank{rank}"
        (out / f"{name}.json").write_text(json.dumps(result, indent=1))
    if not quiet:
        print(f"== {arch} × {shape_name} × {mesh} rank {rank} ({kind}, {cfg.n_layers} layers) ==")
        print(f"  {result['seconds']} s   knobs: {result['knobs']}")
        print(f"  share {_fmt(result['share_bytes'])}  peak {_fmt(result['peak_bytes'])}"
              f"{'' if result['fits_hbm'] else ' (over one card)'} "
              f"{ {k: _fmt(v) for k, v in result['memory'].items() if k != 'total'} }")
        print(f"  per-device: FLOPs={flops:.3e} (+ kernels {census.kernel_flops:.3e})  "
              f"op bytes={op_bytes:.3e} (+ kernels {census.kernel_bytes:.3e})  "
              f"collective bytes={coll_bytes:.3e}  launches {result['launches']}")
        print(f"  roofline: compute={terms['compute_s'] * 1e3:.3f}ms  "
              f"memory={terms['memory_s'] * 1e3:.3f}ms  "
              f"collective={terms['collective_s'] * 1e3:.3f}ms  → {terms['bottleneck']}")
    return result


def _fmt(b) -> str:
    if b is None:
        return "n/a"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.2f}TiB"


def parse_mesh(text: str):
    """``"DxM"`` → ``(D, M)``."""
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"--mesh wants DxM (e.g. 16x16), got {text!r}")
    if d < 1 or m < 1:
        raise argparse.ArgumentTypeError(f"--mesh {text}: both sizes must be >= 1")
    return d, m


def _run_job(job, rank: int):
    """``run_one`` of one ``(arch, shape, data, model, kwargs)``; returns
    None, or the failure (printed with its traceback)."""
    arch, shape_name, data, model, kw = job
    try:
        run_one(arch, shape_name, data, model, rank, **kw)
    except Exception as e:  # noqa: BLE001 — report and continue
        print(f"!! FAIL {arch} × {shape_name} × {data}x{model}: {e}")
        traceback.print_exc()
        return arch, shape_name, f"{data}x{model}", repr(e)
    return None


def _run_in_processes(jobs, rank: int, n: int):
    """``jobs`` on ``n`` processes at once, each job in a fresh process
    (its own fake world); the costliest first (training, then prefill), so
    the last to end is a short one.  Each job's lines print when it ends."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor, as_completed

    order = {"train": 0, "prefill": 1, "decode": 2}
    jobs = sorted(jobs, key=lambda j: order[SHAPES[j[1]].kind])
    failures = []
    with ProcessPoolExecutor(max_workers=n, mp_context=mp.get_context("spawn"),
                             max_tasks_per_child=1) as ex:
        running = {ex.submit(_captured, job, rank): job for job in jobs}
        for done in as_completed(running):
            text, failure = done.result()
            print(text, end="", flush=True)
            if failure:
                failures.append(failure)
    return failures


def _captured(job, rank: int):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        failure = _run_job(job, rank)
    return buf.getvalue(), failure


def summary_table(out: Path) -> str:
    """A markdown table of every dry-run JSON under ``out`` (``run_one``'s):
    one row an arch × shape, one cell a grid, each cell ``FLOPs · op bytes ·
    collective bytes · peak · bottleneck`` (FLOPs and op bytes with the hand
    kernels'; bytes in GB)."""
    rows: Dict[tuple, Dict[str, str]] = {}
    meshes = set()
    for f in sorted(Path(out).glob("*.json")):
        r = json.loads(f.read_text())
        if "shape" not in r or r.get("rank"):
            continue
        flops = (r["flops_per_device"] or 0) + r["kernel_flops"]
        cell = (f"{flops:.2e} · {(r['op_bytes_per_device'] + r['kernel_bytes']) / 1e9:.1f} · "
                f"{r['collective_bytes_per_device'] / 1e9:.2f} · {r['peak_bytes'] / 1e9:.2f} · "
                f"{r['bottleneck'].replace('_s', '')}")
        rows.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = cell
        meshes.add(r["mesh"])
    order = sorted(meshes, key=lambda m: tuple(-int(v) for v in m.split("x")))
    lines = ["| arch | shape | " + " | ".join(order) + " |",
             "|---|---|" + "---|" * len(order)]
    for (arch, shape), cells in sorted(rows.items(), key=lambda kv: (ARCH_IDS.index(kv[0][0]),
                                                                    list(SHAPES).index(kv[0][1]))):
        lines.append(f"| {arch} | {shape} | " + " | ".join(cells.get(m, "not run")
                                                          for m in order) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    from repro_torch.launch.mesh import make_production_grid

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true", help="the 32 x 16 grid")
    ap.add_argument("--both-meshes", action="store_true", help="16 x 16 and 32 x 16")
    ap.add_argument("--all", action="store_true", help="all arch × shape pairs")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--exec-only", action="store_true",
                    help="memory and census only, no flop counter")
    ap.add_argument("--mesh", type=parse_mesh, metavar="DxM",
                    help="any grid of D data x M model ranks (in place of the production ones)")
    ap.add_argument("--rank", type=int, default=0, help="the world rank to act as")
    ap.add_argument("--n-layers", type=int, help="cut the depth")
    ap.add_argument("--batch", type=int, help="rows of the shape's batch")
    ap.add_argument("--seq", type=int, help="the shape's sequence length")
    ap.add_argument("--out", type=Path, default=OUT_DIR, help="where the JSON goes")
    ap.add_argument("--table", type=Path, metavar="DIR",
                    help="print a markdown table of the dry-runs' JSON under DIR and exit")
    ap.add_argument("--jobs", type=int, default=1,
                    help="dry-runs at once, each in a process of its own (default 1: in turn, "
                         "in this process)")
    args = ap.parse_args(argv)
    if args.table:
        print(summary_table(args.table))
        return 0

    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]
    if args.mesh:
        grids = [args.mesh]
    else:
        grids = [make_production_grid(mp)
                 for mp in ([False, True] if args.both_meshes else [args.multi_pod])]
    cut = {"n_layers": args.n_layers} if args.n_layers else None

    jobs = []
    for arch, shape_name in pairs:
        reason = skip_reason(arch, shape_name)
        if reason:
            print(f"-- SKIP {arch} × {shape_name}: {reason}")
            continue
        jobs += [(arch, shape_name, data, model, dict(
            cfg_overrides=cut, batch=args.batch, seq=args.seq, exec_only=args.exec_only,
            out=args.out, quiet=args.quiet)) for data, model in grids]
    if args.jobs > 1:
        failures = _run_in_processes(jobs, args.rank, args.jobs)
    else:
        failures = [f for f in (_run_job(job, args.rank) for job in jobs) if f]
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\nALL DRY-RUNS PASSED")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
