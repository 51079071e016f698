"""The model group's layout rules against the reference's.

``repro_torch.sharding.rules.param_specs`` gives, for each leaf, the
dimension a model group of N ranks splits; the reference's
``param_specs(..., mode="serve")`` gives a PartitionSpec whose ``"model"``
entry is that dimension.  Both run on shapes alone: the port's tree as
``meta`` tensors (``sharding.shard.param_shapes``), the reference's from
``jax.eval_shape`` on a shape-only mesh ``{"data": 1, "model": N}`` (as
tests/test_sharding.py builds its meshes), for all ten archs at their
published widths and N in {2, 4, 16}.  Two kinds of leaf are told apart
(ROADMAP queue C's route differences): the packed mamba2 leaves ``w_in``,
``conv_w`` and ``conv_b``, which the reference splits as plain columns,
are split part by part along the same dimension (``rules.Pieces``: a rank's
z, x and dt columns, B's and C's whole), and the shared expert's MLP under
``moe`` (maverick), which the reference's ``"moe" in path`` rule splits
along the stacked periods axis, is split over its hidden dimension like
every MLP.  ``rules.fsdp_dim`` is held the same way to the data-axis
entry of the reference's ``mode="train"`` specs on a ``("data", "model")``
mesh.
"""
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from repro.configs.base import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.sharding.rules import _path_str
from repro.sharding.rules import param_specs as ref_param_specs
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.sharding.rules import (
    MAMBA_SPLIT_KEYS, Pieces, _keys, check_model_parallel, fsdp_dim, local_shape, param_specs,
    row_block, seq_slab, serve_splits_batch, split_dim,
)
from repro_torch.sharding.shard import param_shapes, share_bytes, take
from repro_torch.utils.trees import tree_flatten_with_path

WORLDS = (2, 4, 16)


class FakeMesh:
    """Shape-only stand-in for a production mesh (no devices needed)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _norm(path: str) -> str:
    """The port's ``['periods']['slot0']['attn']['wq']`` as the reference's
    ``periods/slot0/attn/wq``."""
    return "/".join(part.strip("'") for part in path[1:-1].split("]["))


def _ref_model_dims(arch, world):
    cfg = ref_get_config(arch)
    sds = jax.eval_shape(lambda: ref_build_model(cfg).init(jax.random.PRNGKey(0)))
    specs = ref_param_specs(sds, cfg, FakeMesh({"data": 1, "model": world}), mode="serve")
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    shapes = {_path_str(p): tuple(leaf.shape)
              for p, leaf in jax.tree_util.tree_flatten_with_path(sds)[0]}
    out = {}
    for path, spec in flat:
        dims = [i for i, e in enumerate(spec) if e == "model"]
        assert len(dims) <= 1
        out[_path_str(path)] = (dims[0] if dims else None, shapes[_path_str(path)])
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_agree_with_the_reference_leaf_by_leaf(arch, world):
    cfg = get_config(arch)
    shapes = param_shapes(cfg)
    ours = {_norm(p): (d, tuple(leaf.shape)) for (p, d), (_, leaf) in zip(
        tree_flatten_with_path(param_specs(shapes, cfg, world))[0],
        tree_flatten_with_path(shapes)[0])}
    ref = _ref_model_dims(arch, world)
    assert sorted(ours) == sorted(ref)
    for path, (dim, shape) in ours.items():
        ref_dim, ref_shape = ref[path]
        assert shape == ref_shape, path
        key = path.split("/")[-1]
        if key in ("w_in", "conv_w", "conv_b"):
            # split by parts along the dimension the reference splits by plain columns
            assert isinstance(dim, Pieces) and dim.dim == ref_dim == len(shape) - 1, path
            _check_mamba_pieces(cfg, key, dim, shape, world)
        elif "/moe/shared/" in path:
            # split over F, as the group's MLP; the reference splits the periods axis
            assert dim == len(shape) - (1 if key != "w_down" else 2), path
            assert ref_dim in (0, None), path
        else:
            assert dim == ref_dim, (path, dim, ref_dim)


def _check_mamba_pieces(cfg, key, dim, shape, world):
    """The parts are [z | x | B, C | dt] (``w_in``) or [x | B, C] (the
    conv), back to back over the whole leaf; on every rank they add up to
    its share's width, and ``take`` gives the rank its heads' z, x and dt
    columns with all of B's and C's."""
    d, N, H = cfg.ssm_expand * cfg.d_model, cfg.ssm_state, cfg.ssm_heads
    want = [(d, True), (d, True), (2 * N, False), (H, True)] if key == "w_in" else \
        [(d, True), (2 * N, False)]
    assert [(w, sp) for _, w, sp in dim.parts] == want, key
    assert [off for off, _, _ in dim.parts] == [sum(w for w, _ in want[:i])
                                                for i in range(len(want))], key
    assert sum(w for w, _ in want) == shape[-1], key
    cols = torch.arange(shape[-1])[None]
    dealt = []
    for r in range(world):
        got = take(cols, Pieces(1, dim.parts), r, world)[0].tolist()
        assert len(got) == local_shape(shape, dim, world)[-1] == \
            sum(w // world if sp else w for w, sp in want), key
        mine = []
        for off, w, sp in dim.parts:
            lo, n = (off + r * (w // world), w // world) if sp else (off, w)
            mine += list(range(lo, lo + n))
        assert got == mine, (key, r)
        dealt += [c for c in got if any(sp and off <= c < off + w for off, w, sp in dim.parts)]
    split_cols = [c for off, w, sp in dim.parts if sp for c in range(off, off + w)]
    assert sorted(dealt) == split_cols, key  # each head's column on exactly one rank


def test_the_divisibility_guard_keeps_a_dimension_whole():
    # the reference's ok(dim, size): size divides dim and dim >= size
    assert split_dim(("periods", "slot0", "attn", "wk"), (2, 256, 4, 64), 4) == 2
    assert split_dim(("periods", "slot0", "attn", "wk"), (2, 256, 2, 64), 4) is None
    assert split_dim(("periods", "slot0", "attn", "wq"), (2, 256, 6, 64), 4) is None
    assert split_dim(("periods", "slot0", "mlp", "w_up"), (2, 256, 510), 4) is None
    assert split_dim(("periods", "slot0", "mlp", "w_up"), (2, 256, 510), 2) == 2
    assert split_dim(("periods", "slot0", "moe", "router"), (2, 256, 4), 4) is None
    assert split_dim(("final_norm",), (256,), 2) is None


@pytest.mark.parametrize("dim", ["model", 1.0, True])
def test_take_refuses_a_split_it_has_no_rule_for(dim):
    with pytest.raises(TypeError, match="no split rule"):
        take(torch.zeros(2, 4), dim, 0, 2)


def test_mamba_leaves_stay_whole_when_the_group_does_not_divide_the_heads():
    from dataclasses import replace
    cfg = replace(get_config("mamba2-1.3b"), d_model=96, ssm_head_dim=32)  # 6 SSD heads
    for key in MAMBA_SPLIT_KEYS:
        assert split_dim(("periods", "slot0", "mamba", key), (2, 8, 8), 4, cfg) is None
        assert split_dim(("periods", "slot0", "mamba", key), (2, 8, 8), 2, cfg) is not None
    with pytest.raises(ValueError, match="cfg"):
        split_dim(("periods", "slot0", "mamba", "w_in"), (2, 8, 8), 2)


def test_an_expert_count_the_group_does_not_divide_is_refused():
    from dataclasses import replace
    with pytest.raises(ValueError, match="experts"):
        check_model_parallel(replace(get_config("dbrx-132b"), n_experts=6), 4)


def _share_by_hand(cfg, world):
    """A rank's f32 share counted from the config, layer by layer: the
    vocabulary, the heads, the MLP's hidden layer and the SSD heads split
    over ``world`` ranks; norms, ``A_log`` / ``D_skip`` / ``dt_bias`` and
    B's and C's columns of ``w_in`` and the conv whole on every rank."""
    D, V, hd = cfg.d_model, cfg.padded_vocab, cfg.resolved_head_dim if cfg.n_heads else 0
    H, Hkv, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    n = world
    emb = V * D // n * (1 if cfg.tie_embeddings else 2)
    n_mats = 2 if cfg.mlp_type == "gelu" else 3
    attn = 2 * D + D * H * hd // n + 2 * D * Hkv * hd // n + H * hd * D // n  # norms, wq, wk, wv, wo
    mlp = n_mats * D * Fd // n
    d, N, Hs, k = cfg.ssm_expand * D, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    mamba = (D + D * (2 * d // n + 2 * N + Hs // n) + (k + 1) * (d // n + 2 * N)
             + 3 * Hs + d // n * D + d // n)
    if cfg.is_encoder_decoder:
        total = emb + 2 * D + cfg.n_encoder_layers * (attn + mlp) + \
            cfg.n_layers * (attn + D + attn - 2 * D + mlp)  # self, norm_x, cross (no norms)
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        total = emb + D + (cfg.n_layers - n_attn) * mamba + attn + mlp  # one shared block
    else:
        total = emb + D + cfg.n_layers * mamba
    return 4 * total


@pytest.mark.parametrize("arch, world, gb", [("chameleon-34b", 4, 34.3), ("dbrx-132b", 4, 132.6),
                                             ("zamba2-7b", 4, 5.83),
                                             ("seamless-m4t-large-v2", 4, 1.63)])
def test_share_bytes_of_the_full_width_runs(arch, world, gb):
    """A rank's f32 share: chameleon-34b is split whole over four cards; so
    is every dbrx-132b layer (the four-card run serves 16 of its 40), and
    zamba2-7b's and seamless-m4t's every layer, counted from the config
    with B's and C's columns on every rank."""
    cfg = get_config(arch)
    assert share_bytes(cfg, world) / 1e9 == pytest.approx(gb, rel=0.01)
    if cfg.family in ("hybrid", "ssm", "audio"):
        assert share_bytes(cfg, world) == _share_by_hand(cfg, world)


@pytest.mark.parametrize("world", [1, 2, 4, 16])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b", "seamless-m4t-large-v2"])
def test_share_bytes_count_b_and_c_whole_on_every_rank(arch, world):
    """The share of the new families at every group size, counted by hand."""
    assert share_bytes(get_config(arch), world) == _share_by_hand(get_config(arch), world)


# ------------------------------------------------------------- the data axis
GRIDS = ((2, 2), (16, 4), (8, 1))  # (data, model)


def _ref_fsdp_dims(arch, data, model, mode="train"):
    """The dimension of each leaf that the reference's ``mode`` specs put on
    the data axis, on a shape-only ``("data", "model")`` mesh."""
    cfg = ref_get_config(arch)
    sds = jax.eval_shape(lambda: ref_build_model(cfg).init(jax.random.PRNGKey(0)))
    specs = ref_param_specs(sds, cfg, FakeMesh({"data": data, "model": model}), mode=mode)
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        dims = [i for i, e in enumerate(spec) if e in ("data", ("data",))]
        assert len(dims) <= 1
        out[_path_str(path)] = dims[0] if dims else None
    return out


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_dim_agrees_with_the_references_train_specs(arch, grid):
    """``rules.fsdp_dim`` is the dimension the reference's train specs shard
    over ``"data"``, leaf for leaf, under its divisibility guard; it is
    ``d_model`` wherever it is not None, and never the model group's."""
    data, model = grid
    cfg = get_config(arch)
    ref = _ref_fsdp_dims(arch, data, model)
    shapes = param_shapes(cfg)
    seen = 0
    for p, leaf in tree_flatten_with_path(shapes)[0]:
        keys, shape = _keys(p), tuple(leaf.shape)
        dim = fsdp_dim(keys, shape, data, model, cfg)
        assert dim == ref[_norm(p)], (p, dim, ref[_norm(p)])
        if dim is not None:
            seen += 1
            assert shape[dim] == cfg.d_model, p
            assert dim != split_dim(keys, shape, model, cfg), p
    assert seen > 0
    assert all(d is None for d in (fsdp_dim(_keys(p), tuple(leaf.shape), 1, model, cfg)
                                   for p, leaf in tree_flatten_with_path(shapes)[0]))


# ---------------------------------------------------------- serving on a grid
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_dim_in_serve_mode_agrees_with_the_references_serve_specs(arch, grid):
    """``fsdp_dim(..., mode="serve")`` is the dimension the reference's
    ``mode="serve"`` specs shard over ``"data"``, leaf for leaf: only
    leaves under ``moe`` keep a data slice; ``mode="train"`` is the
    default, leaf for leaf."""
    data, model = grid
    cfg = get_config(arch)
    ref = _ref_fsdp_dims(arch, data, model, mode="serve")
    sliced = 0
    for p, leaf in tree_flatten_with_path(param_shapes(cfg))[0]:
        keys, shape = _keys(p), tuple(leaf.shape)
        dim = fsdp_dim(keys, shape, data, model, cfg, mode="serve")
        assert dim == ref[_norm(p)], (p, dim, ref[_norm(p)])
        assert fsdp_dim(keys, shape, data, model, cfg, mode="train") == \
            fsdp_dim(keys, shape, data, model, cfg)
        if dim is not None:
            sliced += 1
            assert "moe" in keys, p
    assert (sliced > 0) == bool(cfg.n_experts)
    with pytest.raises(ValueError, match="mode"):
        fsdp_dim(("embed",), (8, 4), 2, 1, cfg, mode="eval")


def _ref_serve_split(arch, batch, length, data, model):
    """The reference's decode layout on a shape-only ``("data", "model")``
    mesh: whether ``batch_specs`` puts the batch on the data axis, and the
    spec of an attention cache's ``k`` leaf (``cache_specs``)."""
    from repro.configs.base import ShapeConfig
    from repro.sharding.rules import batch_specs, cache_specs

    cfg = ref_get_config(arch)
    mesh = FakeMesh({"data": data, "model": model})
    shape = ShapeConfig("s", "decode", length, batch)
    splits = batch_specs(cfg, shape, mesh)["token"][0] is not None
    specs = cache_specs(cfg, shape, mesh)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    kv = next(spec for path, spec in flat if _path_str(path).split("/")[-1] == "k")
    return splits, kv


def _ref_slab(kv, length, data, model, d, m):
    """``[start, end)`` of the sequence that device (data ``d``, model
    ``m``) holds under the cache spec ``kv`` (the reference's
    ``_cache_write_shardmap`` index over the sequence's axes in order)."""
    axes = kv[2] if isinstance(kv[2], tuple) else (kv[2],)
    sizes, coords = {"data": data, "model": model}, {"data": d, "model": m}
    idx, n = 0, 1
    for a in axes:
        if a is None:
            continue
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    return idx * length // n, (idx + 1) * length // n


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-7b", "starcoder2-7b"])
@pytest.mark.parametrize("batch,length", [(1, 524288), (3, 48), (4, 32), (128, 32768)])
@pytest.mark.parametrize("grid", [(2, 1), (4, 1), (2, 2), (4, 4)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_the_batch_or_sequence_split_agrees_with_the_references_specs(arch, batch, length, grid):
    """``serve_splits_batch`` is the reference's choice between the batch
    and the caches' sequence on its data axes; a split batch's row blocks
    are the reference's, and a split sequence's slabs too at M = 1.  At M >
    1 the reference splits the sequence over data and ``"model"`` together
    while the port keeps the heads over ``"model"``: the port's slab of
    data rank d is the reference's slabs of (d, 0) … (d, M − 1) joined (a
    route difference)."""
    data, model = grid
    ref_splits, kv = _ref_serve_split(arch, batch, length, data, model)
    assert serve_splits_batch(batch, data) == ref_splits
    for d in range(data):
        if ref_splits:
            assert kv[1] in ("data", ("data",))
            lo, n = row_block(batch, data, d)
            assert (lo, lo + n) == (d * batch // data, (d + 1) * batch // data)
            continue
        assert kv[1] is None and kv[2] == ("data", "model")
        lo, n = seq_slab(length, data, d)
        ref = [_ref_slab(kv, length, data, model, d, m) for m in range(model)]
        assert ref[0][0] == lo and ref[-1][1] == lo + n
        assert all(a[1] == b[0] for a, b in zip(ref, ref[1:]))
        if model == 1:
            assert ref == [(lo, lo + n)]
