"""``Knobs.param_dtype`` and ``seq_shard_acts`` against the reference's
(``repro.launch.steps.Knobs``), and the dry-run's share of the weights in
``param_dtype`` against the reference's ``_params_sds``: every floating
leaf cast (maverick's f32 MoE router too), the shapes and the integer
leaves as the init gives them.  The step that the dry-run runs on such a
share is held to the real ranks' in tests/test_torch_dryrun.py."""
import dataclasses

import pytest
import torch

import jax

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.launch.steps import Knobs as RefKnobs
from repro.launch.steps import _params_sds
from repro.models import build_model as ref_build_model
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.steps import Knobs, build_train_step

FIELDS = ("param_dtype", "seq_shard_acts")


def test_knobs_fields_and_defaults_are_the_references():
    ref = {f.name: f.default for f in dataclasses.fields(RefKnobs)}
    port = {f.name: f.default for f in dataclasses.fields(Knobs)}
    for name in FIELDS:
        assert port[name] == ref[name], name
    assert Knobs().param_dtype == "bfloat16" and Knobs().seq_shard_acts is False


def test_a_param_dtype_outside_f32_and_bf16_is_refused():
    with pytest.raises(ValueError, match="param_dtype"):
        build_train_step(reduced(get_config("llama3.2-1b")), Knobs(param_dtype="float16"))


CASES = {"llama3.2-1b-reduced": ("llama3.2-1b", True),
         "maverick": ("llama4-maverick-400b-a17b", False)}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_share_dtypes_are_the_references_params_sds(case, param_dtype):
    """One rank's layout (1 × 1: the whole tree) in ``param_dtype``: every
    leaf's shape and dtype equal ``_params_sds``' (maverick as published:
    its router, f32 at init, takes ``param_dtype`` like every float leaf)."""
    arch, small = CASES[case]
    rcfg = ref_reduced(ref_get_config(arch)) if small else ref_get_config(arch)
    cfg = reduced(get_config(arch)) if small else get_config(arch)
    want = jax.tree_util.tree_leaves(_params_sds(ref_build_model(rcfg), rcfg, param_dtype))
    _, got = dryrun.share_layout(cfg, 1, 1, "train", param_dtype)
    assert [tuple(s) for _, s, _ in got] == [tuple(w.shape) for w in want]
    assert [str(d).removeprefix("torch.") for _, _, d in got] == [str(w.dtype) for w in want]
    init = {str(d) for _, _, d in dryrun.share_layout(cfg, 1, 1, "train")[1]}
    if not small:
        assert "torch.float32" in init  # the router, before the cast


def test_the_dry_run_reports_its_weight_dtype_and_seq_shard_acts():
    cfg = dataclasses.replace(reduced(get_config("llama3.2-1b")), n_layers=1)
    res = dryrun.run_one("llama3.2-1b", "decode_32k", 1, 2, cfg=cfg, batch=2, seq=8,
                         exec_only=True, out=None, quiet=True)
    assert res["knobs"]["param_dtype"] == "bfloat16" and res["knobs"]["seq_shard_acts"] is False
    bf16 = dryrun.share_layout(cfg, 1, 2, "train", "bfloat16")[1]
    assert res["share_bytes"] == sum(torch.Size(s).numel() * 2 for _, s, _ in bf16)
    f32 = dryrun.run_one("llama3.2-1b", "decode_32k", 1, 2, cfg=cfg, batch=2, seq=8,
                         exec_only=True, out=None, quiet=True,
                         overrides={"param_dtype": "float32"})
    assert f32["share_bytes"] == 2 * res["share_bytes"]


@pytest.mark.parametrize("arch,shape,launches", [
    ("mamba2-1.3b", "prefill_32k", {"ssd_scan": 2}),
    ("zamba2-7b", "prefill_32k", {"flash_attention": 1, "ssd_scan": 1}),
    ("dbrx-132b", "train_4k", {}),
    ("llama4-maverick-400b-a17b", "train_4k", {})])
def test_bf16_weights_run_through_every_route(arch, shape, launches):
    """A reduced arch's step in the dry-run's default bf16 weights: the SSD
    scan takes its decay rates in f32 (``A = −exp(A_log)`` promoted), the
    MoE router promotes a bf16 router to f32, as the reference's products
    promote them."""
    cfg = reduced(get_config(arch))
    res = dryrun.run_one(arch, shape, 1, 2, cfg=cfg, batch=2, seq=64, exec_only=True,
                         out=None, quiet=True, overrides={"microbatches": 1})
    assert res["knobs"]["param_dtype"] == "bfloat16" and res["launches"] == launches
