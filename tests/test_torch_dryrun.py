"""The dry-run (``repro_torch.launch.dryrun``, ``fed_dryrun``, ``hlo_stats``)
against the reference's layouts and against real ranks.

* Shares: each rank's param share at 16 x 16 and 32 x 16 is the shard that
  the reference's ``param_specs(..., mode="train")`` gives on a shape-only
  mesh of the same axis sizes (each dimension divided by the product of its
  named axes' sizes; no 512 devices), for all ten archs, but for the
  recorded route differences, which are pinned: the packed mamba2 leaves
  split part by part, the shared expert's MLP split over its hidden columns.
* Decode caches: where the port's layout differs from the reference's
  (ROADMAP queue C: the sequence split over data only, the heads over the
  model group; one param layout for prefill and decode) the difference is
  pinned, and the bytes a rank holds are the reference's wherever the model
  group divides the kv heads.
* Inputs: ``input_specs`` are the reference's shapes for every arch x
  shape, int64 where the reference's tokens are int32.
* Fake against real: on a 2 x 2 grid each rank's dry-run (fake tensors, a
  fake world) predicts exactly what four real gloo ranks count running the
  same step (``tests/_torch_dryrun_ranks.py``): the census of the model
  group's and the data group's collectives (``ParallelContext.counts``),
  the flop counter's FLOPs and MemTracker's peak; and the FedCM round's
  kernel launches and census (``federated_llm``'s ``--cohort-shard 2
  --model-parallel 2``).
* The kernels' fake branch: taken for ``FakeTensor`` operands only (it
  allocates what the launch would, records one launch, builds nothing); a
  real tensor on the CPU still raises.
* The CLIs.
"""
import math

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.sharding.rules import _path_str, cache_specs
from repro.sharding.rules import param_specs as ref_param_specs
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.kernels import build
from repro_torch.launch import dryrun, fed_dryrun, federated_llm, hlo_stats
from repro_torch.launch.mesh import (
    CUBLAS_WORKSPACE_BYTES, MULTI_POD_SHAPE, SINGLE_POD_SHAPE, fake_world, make_production_grid,
    make_test_grid, spawn_cohort,
)
from repro_torch.models.model import TOKEN_DTYPE, build_model
from repro_torch.sharding.rules import MAMBA_SPLIT_KEYS, Pieces, _keys, split_dim
from repro_torch.sharding.shard import param_shapes
from repro_torch.utils.trees import tree_flatten_with_path

import _torch_dryrun_ranks as ranks_mod


class FakeMesh:
    """Shape-only stand-in for a production mesh (no devices needed)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


REF_MESHES = {(16, 16): {"data": 16, "model": 16},
              (32, 16): {"pod": 2, "data": 16, "model": 16}}


def _norm(path: str) -> str:
    return "/".join(part.strip("'") for part in path[1:-1].split("]["))


def _shard(shape, spec, sizes):
    """The shard of ``shape`` under the PartitionSpec ``spec``: each
    dimension divided by the product of its named axes' sizes."""
    out = list(shape)
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(sizes[a] for a in names if a is not None)
        assert out[i] % n == 0
        out[i] //= n
    return tuple(out)


# ------------------------------------------------------------------ the grids
def test_production_grids_fold_the_pod_into_data():
    assert make_production_grid() == SINGLE_POD_SHAPE == (16, 16)
    assert make_production_grid(multi_pod=True) == (32, 16)
    assert math.prod(MULTI_POD_SHAPE) == 512
    assert make_test_grid(4, 4, ranks=8) == (4, 2)
    assert make_test_grid(16, 1, ranks=2) == (2, 1)


def test_fake_world_is_one_rank_of_the_grid_and_refuses_a_second():
    import torch.distributed as dist

    with fake_world(32, 16, rank=300) as (model_group, data_group):
        assert (dist.get_rank(model_group), dist.get_world_size(model_group)) == (12, 16)
        assert (dist.get_rank(data_group), dist.get_world_size(data_group)) == (18, 32)
        with pytest.raises(RuntimeError, match="already initialized"):
            with fake_world(2, 2):
                pass
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="rank 4 of a 2 x 2"):
        with fake_world(2, 2, rank=4):
            pass


# ------------------------------------------------------------------ shares
def _ref_shards(arch, grid):
    cfg = ref_get_config(arch)
    sds = jax.eval_shape(lambda: ref_build_model(cfg).init(jax.random.PRNGKey(0)))
    sizes = REF_MESHES[grid]
    specs = ref_param_specs(sds, cfg, FakeMesh(sizes), mode="train")
    shapes = {_path_str(p): tuple(x.shape) for p, x in jax.tree_util.tree_flatten_with_path(sds)[0]}
    return {_path_str(p): _shard(shapes[_path_str(p)], spec, sizes)
            for p, spec in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, P))[0]}


@pytest.mark.parametrize("grid", sorted(REF_MESHES), ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_share_shapes_are_the_references_shards(arch, grid):
    """Every leaf's share is the reference's train-mode shard, but the
    recorded route differences: a packed mamba2 leaf holds its pieces (the
    reference splits plain columns), the shared expert's MLP its hidden
    columns (the reference splits its periods axis)."""
    cfg = get_config(arch)
    ref = _ref_shards(arch, grid)
    port = dryrun.share_shapes(cfg, *grid)
    whole = {p: tuple(t.shape) for p, t in tree_flatten_with_path(param_shapes(cfg))[0]}
    assert set(map(_norm, port)) == set(ref)
    differ = []
    for p, shape in port.items():
        keys = _keys(p)
        if shape == ref[_norm(p)]:
            continue
        differ.append(_norm(p))
        dim = split_dim(keys, whole[p], grid[1], cfg)
        if keys[-1] in MAMBA_SPLIT_KEYS:
            assert isinstance(dim, Pieces) and shape[dim.dim] == dim.width(grid[1])
        else:
            assert "shared" in keys, f"{p}: {shape} against the reference's {ref[_norm(p)]}"
    pinned = {"mamba2-1.3b", "zamba2-7b", "llama4-maverick-400b-a17b"}
    assert bool(differ) == (arch in pinned)


# ------------------------------------------------------------------ inputs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_are_the_references(arch):
    model, ref = build_model(get_config(arch)), ref_build_model(ref_get_config(arch))
    for name, shape in SHAPES.items():
        want = jax.tree_util.tree_flatten_with_path(ref.input_specs(REF_SHAPES[name]))[0]
        got = tree_flatten_with_path(model.input_specs(shape))[0]
        assert [tuple(x.shape) for _, x in got] == [tuple(x.shape) for _, x in want]
        for (_, g), (_, w) in zip(got, want):
            assert g.device.type == "meta"
            assert g.dtype == (TOKEN_DTYPE if w.dtype == np.int32 else getattr(torch, str(w.dtype)))


# ------------------------------------------------------------------ decode caches
def _rank_cache(arch, shape_name, data, model, knobs=None):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    knobs = knobs or dryrun.knobs_for(arch, shape_name)
    with fake_world(data, model) as groups:
        parallel = dryrun.grid_parallel(cfg, data, model, groups, knobs, shape.global_batch)
        cache = build_model(cfg).input_specs(shape, parallel)["cache"]
    return {_norm(p): tuple(t.shape) for p, t in tree_flatten_with_path(cache)[0]}


def _ref_cache(arch, shape_name, data, model):
    cfg = ref_get_config(arch)
    sizes = {"data": data, "model": model}
    shape = REF_SHAPES[shape_name]
    cache = ref_build_model(cfg).input_specs(shape)["cache"]
    specs = cache_specs(cfg, shape, FakeMesh(sizes))
    whole = {_path_str(p): tuple(x.shape)
             for p, x in jax.tree_util.tree_flatten_with_path(cache)[0]}
    return {_path_str(p): _shard(whole[_path_str(p)], s, sizes)
            for p, s in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, P))[0]}


@pytest.mark.parametrize("arch,shape_name,grid", [
    ("llama3.2-1b", "decode_32k", (16, 16)), ("llama3.2-1b", "decode_32k", (4, 4)),
    ("zamba2-7b", "long_500k", (16, 16)), ("zamba2-7b", "long_500k", (2, 4)),
    ("seamless-m4t-large-v2", "decode_32k", (2, 2))])
def test_decode_cache_route_differences(arch, shape_name, grid):
    """An attention cache leaf ``(n, B, S, Hkv, hd)``: the reference splits
    the batch over data and the sequence over model (B > 1), or the
    sequence over data and model together (long_500k's B = 1), and keeps
    the heads whole; the port splits the batch over data or, at B = 1, the
    sequence over data alone, and the kv heads over the model group
    (``layers.kv_heads_of``).  A rank holds the reference's bytes wherever
    the model group divides the kv heads."""
    data, model = grid
    cfg = get_config(arch)
    B, S = SHAPES[shape_name].global_batch, SHAPES[shape_name].seq_len
    port, ref = _rank_cache(arch, shape_name, data, model), _ref_cache(arch, shape_name, *grid)
    assert set(port) == set(ref)
    splits = B % data == 0
    for path, shape in port.items():
        if path.split("/")[-1] not in ("k", "v", "cross_k", "cross_v"):
            continue  # the mamba states: the batch's rows, the rank's SSD heads
        n, rows, positions, heads, hd = shape
        assert (rows, positions) == ((B // data, S) if splits else (B, S // data))
        r = ref[path]
        assert r[3] == cfg.n_kv_heads and r[2] == (S // model if splits else S // (data * model))
        if cfg.n_kv_heads % model == 0:
            assert heads == cfg.n_kv_heads // model and math.prod(shape) == math.prod(r)


def test_prefill_and_decode_share_one_param_layout():
    """The reference prefills in the train layout and decodes in
    ``serve_params``'s; a serving rank of the port holds one layout for
    both: the dry-run's prefill and decode report the same shares, in the
    layout of ``Knobs.serve_params``."""
    cfg = ranks_mod.case_config("dbrx-132b")
    runs = {kind: dryrun.run_one("dbrx-132b", shape, 2, 2, cfg=cfg, batch=4, seq=8,
                                 overrides={"serve_params": "replicated"}, out=None, quiet=True)
            for kind, shape in (("prefill", "prefill_32k"), ("decode", "decode_32k"))}
    assert runs["prefill"]["knobs"]["layout"] == runs["decode"]["knobs"]["layout"] == "serve"
    assert runs["prefill"]["share_shapes"] == runs["decode"]["share_shapes"]
    train = dryrun.share_shapes(cfg, 2, 2, "train")
    assert train != {p: tuple(s) for p, s in runs["decode"]["share_shapes"].items()}


# ------------------------------------------------------------------ fake against real
CASES = (("llama3.2-1b", "train"), ("dbrx-132b", "train"), ("mamba2-1.3b", "train"),
         ("seamless-m4t-large-v2", "train"), ("llama3.2-1b", "decode"),
         ("mamba2-1.3b", "decode"))
RANKS = range(4)


@pytest.fixture(scope="module")
def real_ranks():
    return spawn_cohort(ranks_mod.world, 4, args=(CASES,), device="cpu", timeout_s=120.0,
                        deadline_s=300.0)


def _fake(arch, kind, rank):
    return dryrun.run_one(arch, ranks_mod.SHAPE[kind], *ranks_mod.GRID, rank,
                          cfg=ranks_mod.case_config(arch), overrides=ranks_mod.KNOBS,
                          batch=ranks_mod.B, seq=ranks_mod.S, out=None, quiet=True)


@pytest.mark.parametrize("arch,kind", CASES, ids=lambda v: str(v))
def test_fake_rank_predicts_the_real_ranks(arch, kind, real_ranks, monkeypatch):
    """Each rank's census, FLOPs and MemTracker peak equal the real rank's,
    exactly, on the real ranks' collective route: a fake group takes the
    card's route, whose FSDP gradients take one ``reduce_scatter`` a dtype,
    and gloo's take an ``all_reduce`` of every block
    (``layers._data_reduce_scatter``), so here the fake group reports
    gloo's backend and takes gloo's route.  ``ParallelContext.counts``
    tallies both as ``data_reduce_scatter``."""
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "gloo")
    for rank in RANKS:
        real = real_ranks[rank][(arch, kind)]
        fake = _fake(arch, kind, rank)
        counts = dict(fake["parallel_counts"])
        if kind == "train":  # gloo's reduce-scatters are all-reduces over data
            assert real["counts"]["data_reduce_scatter"] > 0
            counts["data_all_reduce"] -= real["counts"]["data_reduce_scatter"]
            counts["data_reduce_scatter"] += real["counts"]["data_reduce_scatter"]
        assert counts == real["counts"], rank
        assert fake["collectives"] == {k: v for k, v in real["census"].items() if k != "total"}
        assert fake["flops_per_device"] == real["flops"] and real["flops"] > 0, rank
        assert fake["memory"]["total"] == real["peak"], rank
        # on the card the step's GEMMs also take a cuBLAS workspace a thread:
        # the caller's, and autograd's for the train step's backward
        threads = 2 if kind == "train" else 1
        assert fake["blas_workspace_bytes"] == threads * CUBLAS_WORKSPACE_BYTES, rank
        assert fake["peak_bytes"] == real["peak"] + fake["blas_workspace_bytes"], rank
        assert fake["host_reads"] == 0


def test_fake_group_takes_nccls_reduce_scatter(real_ranks):
    """On its own route the fake group reduce-scatters the FSDP gradients
    once a dtype, as many times as the real ranks' ``data_reduce_scatter``,
    each with 1/D of the all-reduce's result bytes."""
    real = real_ranks[0][("llama3.2-1b", "train")]
    fake = _fake("llama3.2-1b", "train", 0)
    d = fake["collectives_by_group"]["data"]
    assert fake["parallel_counts"] == real["counts"]
    assert d["reduce-scatter"]["count"] == real["counts"]["data_reduce_scatter"]
    assert d["reduce-scatter"]["sent"] == ranks_mod.GRID[0] * d["reduce-scatter"]["bytes"]


def test_fed_dryrun_predicts_federated_llms_round(real_ranks):
    """One FedCM round in ``federated_llm``'s 2 x 2 layout: each rank's
    model-group census equals the real rank's ``ParallelContext.counts``;
    the kernels launch K ``fed_direction`` and one ``server_update`` (the
    real ranks, on the CPU, take the plain versions and count none); the
    fold's ``all_to_all`` and ``all_gather`` run over the data group."""
    run = ranks_mod.FED_RUN
    for rank in RANKS:
        res = fed_dryrun.run(cfg=ranks_mod.case_config("llama3.2-1b"), data=2, model=2,
                             rank=rank, rounds=run["rounds"], cohort=run["cohort"],
                             local_steps=run["local_steps"], batch=run["batch"],
                             seq=run["seq"], n_clients=run["n_clients"],
                             n_seqs=federated_llm.N_SEQS, out=None, quiet=True)
        real = real_ranks[rank]["fed"]
        assert res["parallel_counts"] == real["counts"], rank
        assert not any(real["launches"].values())
        assert res["launches"] == {"fed_direction": run["local_steps"], "server_update": 1}
        d = res["collectives_by_group"]["cohort"]
        assert d["all-to-all"]["count"] == 1 and d["all-gather"]["count"] >= 3
        assert res["use_flat_plane"] and res["host_reads"] == 1  # the first draw's check


def test_fed_dryrun_predicts_federated_llms_tree_round(real_ranks):
    """The per-leaf tree path's round on a model group of 2 (``fed_dryrun``
    with ``use_flat_plane=False`` on 1 x 2): each rank's census equals the
    real rank's ``ParallelContext.counts``, and no kernel launches."""
    run = ranks_mod.FED_RUN
    for rank in RANKS:
        res = fed_dryrun.run(cfg=ranks_mod.case_config("llama3.2-1b"), data=1, model=2,
                             rank=rank % 2, rounds=run["rounds"], cohort=run["cohort"],
                             local_steps=run["local_steps"], batch=run["batch"],
                             seq=run["seq"], n_clients=run["n_clients"],
                             n_seqs=federated_llm.N_SEQS, out=None, quiet=True,
                             use_flat_plane=False)
        real = real_ranks[rank]["fed_tree"]
        assert res["parallel_counts"] == real["counts"], rank
        assert res["launches"] == {} and not any(real["launches"].values())
        assert not res["use_flat_plane"]


def test_census_names_the_threads_that_take_a_cublas_workspace():
    """A forward GEMM takes the caller's workspace, a linear with a bias
    cuBLASLt's as well, and the backward's GEMMs autograd's thread's: the
    workspaces the card allocates for the step (``blas_workspace_bytes``)."""
    x = torch.randn(4, 8)
    w = torch.randn(8, 8, requires_grad=True)
    with hlo_stats.CensusMode() as census:
        torch.nn.functional.linear(x, w, torch.zeros(8)).sum()
    assert census.blas == {("forward", "cublaslt")}
    with hlo_stats.CensusMode() as census:
        (x @ w).sum().backward()
    assert census.blas == {("forward", "cublas"), ("backward", "cublas")}
    assert hlo_stats.blas_workspace_bytes(census) == 2 * CUBLAS_WORKSPACE_BYTES
    with hlo_stats.CensusMode() as census:
        torch.nn.functional.linear(x[:1], w.detach(), torch.zeros(8))  # one row: no epilogue
        x + 1
    assert census.blas == {("forward", "cublas")}


# ------------------------------------------------------------------ the fake branch
def _kernel_calls(dev):
    from repro_torch.kernels.fed_direction.kernel import fed_direction_flat
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
    from repro_torch.kernels.server_update.kernel import dequant_update_flat, server_update_flat
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan

    f32 = dict(dtype=torch.float32, device=dev)
    C, P = 3, 40
    return {
        "fed_direction": lambda: fed_direction_flat(torch.zeros(C, P, **f32),
                                                    torch.zeros(C, P, **f32),
                                                    [torch.zeros(P, **f32)],
                                                    torch.zeros(4, **f32)),
        "server_update": lambda: server_update_flat(torch.zeros(C, P, **f32),
                                                    torch.zeros(C, **f32), torch.zeros(P, **f32),
                                                    torch.zeros(P, **f32), torch.zeros(4, **f32)),
        "dequant_update": lambda: dequant_update_flat(
            torch.zeros(C, P, dtype=torch.int8, device=dev), torch.ones(C, **f32),
            torch.zeros(C, **f32), torch.zeros(P, **f32), torch.zeros(P, **f32),
            torch.zeros(4, **f32)),
        "flash_attention": lambda: flash_attention_bshd(torch.zeros(1, 8, 4, 16, **f32),
                                                        torch.zeros(1, 8, 2, 16, **f32),
                                                        torch.zeros(1, 8, 2, 16, **f32)),
        "ssd_scan": lambda: ssd_scan(torch.zeros(1, 8, 2, 4, dtype=torch.bfloat16, device=dev),
                                     torch.zeros(1, 8, 2, **f32), torch.zeros(2, **f32),
                                     torch.zeros(1, 8, 4, dtype=torch.bfloat16, device=dev),
                                     torch.zeros(1, 8, 4, dtype=torch.bfloat16, device=dev),
                                     chunk=4),
    }


def test_fake_branch_only_for_fake_tensors(monkeypatch):
    """``FakeTensor`` operands: each binding returns outputs of the launch's
    shapes, records one launch in the census, leaves ``launches`` alone and
    builds nothing; a real CPU tensor still raises (as on the card, a
    kernel that cannot build or launch raises) and records nothing."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    def no_build(names):
        raise RuntimeError("built")

    monkeypatch.setattr(build, "build_all", no_build)
    from repro_torch.kernels import launch_counts

    before = launch_counts()
    with FakeTensorMode(), hlo_stats.CensusMode() as census:
        for name, call in _kernel_calls("meta").items():
            out = call()
            outs = out if isinstance(out, tuple) else (out,)
            assert all(isinstance(t, FakeTensor) for t in outs if t is not None), name
            assert census.launches[name] == 1, name
    assert census.kernel_bytes > 0 and census.kernel_flops > 0
    # the SSD scan's bf16 route allocates its f32 C·Bᵀ scratch beside the outputs
    assert census.ops["empty"] >= 1
    assert launch_counts() == before
    assert build.FAKE_LAUNCH_HOOKS == []
    with hlo_stats.CensusMode() as census:
        for name, call in _kernel_calls("cpu").items():
            with pytest.raises((RuntimeError, ValueError)):
                call()
    assert not census.launches and launch_counts() == before


# ------------------------------------------------------------------ the CLIs
def test_dryrun_cli_full_width_decode_and_the_long_context_skip(tmp_path, capsys):
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("ALL DRY-RUNS PASSED")
    import json

    res = json.loads((tmp_path / "llama3.2-1b_decode_32k_16x16_rank0.json").read_text())
    for key in ("arch", "shape", "mesh", "chips", "kind", "knobs", "collectives",
                "collective_bytes_per_device", "op_census", "memory", "roofline", "bottleneck",
                "flops_per_device", "op_bytes_per_device", "peak_bytes", "launches"):
        assert key in res
    assert res["chips"] == 256 and res["mesh"] == "16x16" and res["peak_bytes"] > 0
    assert dryrun.main(["--table", str(tmp_path)]) == 0
    table = capsys.readouterr().out.splitlines()
    assert table[0] == "| arch | shape | 16x16 |" and table[2].startswith("| llama3.2-1b | decode_32k |")
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    assert (f"-- SKIP llama3.2-1b × long_500k: {dryrun.skip_reason('llama3.2-1b', 'long_500k')}"
            in capsys.readouterr().out)
