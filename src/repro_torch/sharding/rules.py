"""Layout rules over a ``torch.distributed`` group: the cohort's and the model's.

Counterpart of ``repro.sharding.rules``.  The cohort part
(``padded_cohort``, ``cohort_axis_size``): where the reference shards the
cohort over a ``("clients",)`` mesh axis, the port shards it over the ranks
of a process group, one process a shard; rank r owns rows ``[r·C_loc,
(r+1)·C_loc)`` of the padded cohort.

The model part (``param_specs``, ``split_dim``): the ``"model"``-axis half
of the reference's ``param_specs(..., mode="serve")``.  Each leaf is split
along at most one dimension over the ranks of a model group, rank r holding
the r-th of N equal slices, under the reference's divisibility guard (a
dimension that N does not divide stays whole).  A model group replicates
the batch: there is no data axis, so the serve mode's replication outside
the expert banks is all there is of it.  The reference's training specs
(FSDP), its data axes and its cache specs are ROADMAP A.16.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch.distributed as dist

from repro_torch.utils.trees import tree_flatten_with_path, tree_unflatten


def cohort_axis_size(group) -> int:
    """Validate a cohort process group and return its size (the number of
    shards).  ``group`` is a ``torch.distributed`` process group of this
    process (``dist.group.WORLD`` for the default one)."""
    if not dist.is_initialized():
        raise ValueError("the cohort-parallel engine needs an initialized process group; "
                         "start the ranks with repro_torch.launch.mesh.spawn_cohort "
                         "(CLI: --cohort-shard N)")
    if group is None or dist.get_rank(group) < 0:
        raise ValueError(f"this process is not a member of the cohort group {group!r}")
    return dist.get_world_size(group)


def padded_cohort(capacity: int, n_shards: int) -> int:
    """The padded cohort length: ``capacity`` rounded up to a multiple of
    ``n_shards`` so every rank owns the same number of rows.  Pad rows carry
    zero fold weight (``repro_torch.core.flat.pad_cohort``)."""
    return -(-capacity // n_shards) * n_shards


# ------------------------------------------------------------- the model group
# The mamba2 leaves the reference splits over "model" (its heads): w_in's
# output concatenates z, x, B, C and dt, so a plain column split does not
# give a rank whole heads; they are refused here (ROADMAP A.16).
MAMBA_SPLIT_KEYS = ("w_in", "w_out", "conv_w", "conv_b", "norm_z")
REFUSED = "refused: mamba2 heads over the model group (ROADMAP A.16)"
Split = Union[int, None, str]


def _ok(dim: int, size: int) -> bool:
    """The reference's divisibility guard."""
    return dim % size == 0 and dim >= size


def split_dim(path: Sequence[str], shape: Sequence[int], world: int) -> Split:
    """The dimension of the leaf at ``path`` (its dict keys) and of
    ``shape`` that a model group of ``world`` ranks splits, None when the
    leaf stays whole, or ``REFUSED`` for a mamba2 leaf the reference splits.
    The rule is the reference's, key by key: ``embed`` (V, D) and
    ``unembed`` (D, V) over V; ``wq`` / ``wk`` / ``wv`` (…, D, H, hd) and
    ``wo`` (…, H, hd, D) over their heads; a dense MLP's ``w_gate`` /
    ``w_up`` (…, D, F) and ``w_down`` (…, F, D) over F; an expert bank's
    ``w_*`` (…, E, ·, ·) over E; the router and everything else whole.

    One leaf differs from the reference on purpose: the shared expert's MLP
    under ``moe`` (maverick).  The reference's rule catches it with the
    expert banks (``"moe" in path``), and for its 3-d stacked leaves that
    splits the periods axis, a storage layout GSPMD gathers back a layer at
    a time; here it is split over F like every MLP, since it runs as the
    group's MLP (ROADMAP queue C)."""
    key = path[-1] if path else ""
    nd = len(shape)

    def m(i: int) -> Optional[int]:
        return i if _ok(shape[i], world) else None

    if key in MAMBA_SPLIT_KEYS:
        return REFUSED
    if key == "embed":
        return m(0)
    if key == "unembed":
        return m(1)
    if key in ("wq", "wk", "wv"):
        return m(nd - 2)
    if key == "wo":
        return m(nd - 3)
    bank = "moe" in path and "shared" not in path
    if key in ("w_gate", "w_up"):
        return m(nd - 3) if bank else m(nd - 1)
    if key == "w_down":
        return m(nd - 3) if bank else m(nd - 2)
    return None


def _keys(path: str) -> Tuple[str, ...]:
    """``['periods']['slot0']['attn']['wq']`` → ``("periods", "slot0", "attn", "wq")``."""
    return tuple(part.strip("'\"") for part in path[1:-1].split("][")) if path else ()


def param_specs(params: Any, cfg, world: int) -> Any:
    """The tree of ``split_dim`` for every leaf of ``params`` (tensors, or
    ``meta`` tensors of the shapes alone), for a model group of ``world``
    ranks.  ``cfg`` is the config the tree was built from (kept for the
    reference's signature: the rule reads the keys and shapes alone)."""
    leaves, treedef = tree_flatten_with_path(params)
    return tree_unflatten(treedef, [split_dim(_keys(p), tuple(leaf.shape), world)
                                    for p, leaf in leaves])


def check_model_parallel(cfg, world: int) -> None:
    """Refuse what a model group of ``world`` > 1 ranks does not run: the
    ssm and hybrid families (mamba2 heads over the group) and the
    encoder-decoder (its cross-attention under a group), both ROADMAP
    A.16; and an expert count the group does not divide (the reference's
    expert-parallel MoE asserts the same)."""
    if world <= 1:
        return
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder under a model group is not ported "
            f"(ROADMAP A.16); serve it with --model-parallel 1")
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: mamba2 heads over the model group are not ported (ROADMAP A.16; "
            f"the {cfg.family} family serves with --model-parallel 1)")
    if cfg.n_experts and cfg.n_experts % world:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not split over a model "
                         f"group of {world}")
