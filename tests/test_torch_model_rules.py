"""The model group's layout rules against the reference's.

``repro_torch.sharding.rules.param_specs`` gives, for each leaf, the
dimension a model group of N ranks splits; the reference's
``param_specs(..., mode="serve")`` gives a PartitionSpec whose ``"model"``
entry is that dimension.  Both run on shapes alone: the port's tree as
``meta`` tensors (``sharding.shard.param_shapes``), the reference's from
``jax.eval_shape`` on a shape-only mesh ``{"data": 1, "model": N}`` (as
tests/test_sharding.py builds its meshes), for all ten archs at their
published widths and N in {2, 4, 16}.  Two kinds of leaf are told apart:
the mamba2 leaves the reference splits are refused here (ROADMAP A.16),
and the shared expert's MLP under ``moe`` (maverick), which the reference's
``"moe" in path`` rule splits along the stacked periods axis, is split over
its hidden dimension like every MLP (ROADMAP queue C).
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
    MAMBA_SPLIT_KEYS, REFUSED, check_model_parallel, param_specs, split_dim,
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
        if key in MAMBA_SPLIT_KEYS:
            assert dim == REFUSED, path
        elif "/moe/shared/" in path:
            # split over F, as the group's MLP; the reference splits the periods axis
            assert dim == len(shape) - (1 if key != "w_down" else 2), path
            assert ref_dim in (0, None), path
        else:
            assert dim == ref_dim, (path, dim, ref_dim)


def test_the_divisibility_guard_keeps_a_dimension_whole():
    # the reference's ok(dim, size): size divides dim and dim >= size
    assert split_dim(("periods", "slot0", "attn", "wk"), (2, 256, 4, 64), 4) == 2
    assert split_dim(("periods", "slot0", "attn", "wk"), (2, 256, 2, 64), 4) is None
    assert split_dim(("periods", "slot0", "attn", "wq"), (2, 256, 6, 64), 4) is None
    assert split_dim(("periods", "slot0", "mlp", "w_up"), (2, 256, 510), 4) is None
    assert split_dim(("periods", "slot0", "mlp", "w_up"), (2, 256, 510), 2) == 2
    assert split_dim(("periods", "slot0", "moe", "router"), (2, 256, 4), 4) is None
    assert split_dim(("final_norm",), (256,), 2) is None


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b", "seamless-m4t-large-v2"])
def test_refused_families_name_their_roadmap_item(arch):
    cfg = get_config(arch)
    with pytest.raises(NotImplementedError, match="A.16"):
        check_model_parallel(cfg, 2)
    check_model_parallel(cfg, 1)  # one rank is the unsharded model
    if cfg.family in ("ssm", "hybrid"):
        leaf = torch.zeros(2, 3)
        with pytest.raises(NotImplementedError, match="A.16"):
            take(leaf, REFUSED, 0, 2)


def test_an_expert_count_the_group_does_not_divide_is_refused():
    from dataclasses import replace
    with pytest.raises(ValueError, match="experts"):
        check_model_parallel(replace(get_config("dbrx-132b"), n_experts=6), 4)


@pytest.mark.parametrize("arch, world, gb", [("chameleon-34b", 4, 34.3), ("dbrx-132b", 4, 132.6)])
def test_share_bytes_of_the_full_width_runs(arch, world, gb):
    """A rank's f32 share: chameleon-34b is split whole over four cards; so
    is every dbrx-132b layer (the four-card run serves 16 of its 40)."""
    assert share_bytes(get_config(arch), world) / 1e9 == pytest.approx(gb, rel=0.01)
