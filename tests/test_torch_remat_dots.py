"""``remat="dots"``: the reference's ``checkpoint_dots_with_no_batch_dims``
policy as the port's selective checkpoint (``models.transformer.dots_policy``).

On the reduced configs of all ten archs, with the reference's
``model.init(PRNGKey(0))`` weights converted leaf for leaf (the set-up of
tests/test_torch_train.py): the loss and every gradient under ``"dots"``
against ``"none"`` in the port (the loss ``torch.equal``: the recomputed
forward is the same operations on the same inputs; each gradient at
``LM_RTOL`` / ``LM_ATOL``), and against the reference's
``jax.value_and_grad`` of ``loss_fn(..., remat="dots")`` (the loss at
``LM_RTOL`` / ``LM_ATOL``, each gradient leaf within ``GRAD_REL_L2``
relative L2, tests/_torch_parity.py).  The policy is seen at work: in a
period's forward it keeps the outputs of ``mm`` (the weight products, which
``torch.matmul`` folds to 2-d) and of no ``bmm`` (attention's scores and
values, the experts' banks), whose outputs it recomputes.  The
encoder-decoder takes ``"dots"`` as ``"full"``, as the reference does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import GRAD_REL_L2, LM_ATOL, LM_RTOL, assert_close
from test_torch_train import SHAPE, _batch, _np, _setup, rel_l2
from repro_torch.configs.base import ARCH_IDS
from repro_torch.core.convert import params_from_numpy
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import transformer
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

MM = {"aten.mm.default", "aten.addmm.default"}
BMM = {"aten.bmm.default", "aten.baddbmm.default"}


def _port(arch, remat):
    _, rmodel, model, rparams = _setup(arch)
    params, batch = params_from_numpy(_np(rparams)), _batch(rmodel.dummy_batch(SHAPE))
    return value_and_grad(lambda p, b: model.loss_fn(p, b, remat=remat), params, batch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dots_gives_the_loss_and_gradients_of_none(arch):
    (l0, _), g0 = _port(arch, "none")
    (l1, _), g1 = _port(arch, "dots")
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert_close(a, b, rtol=LM_RTOL, atol=LM_ATOL, what=arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dots_matches_the_references_value_and_grad(arch):
    _, rmodel, _, rparams = _setup(arch)
    rbatch = rmodel.dummy_batch(SHAPE)
    (rloss, _), rgrads = jax.value_and_grad(
        lambda p: rmodel.loss_fn(p, rbatch, remat="dots"), has_aux=True)(rparams)
    (loss, _), grads = _port(arch, "dots")
    assert_close(loss, np.asarray(rloss), rtol=LM_RTOL, atol=LM_ATOL, what=arch)
    for (a, b) in zip(tree_leaves(grads), jax.tree_util.tree_leaves(rgrads)):
        assert rel_l2(a.numpy(), np.asarray(b, jnp.float32)) <= GRAD_REL_L2, arch


DECODER_ONLY = [a for a in ARCH_IDS if a != "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_the_policy_keeps_mm_outputs_and_recomputes_bmm(arch, monkeypatch):
    """What ``dots_policy`` decided for each operation of the forward (not
    of the recomputation): at least one ``mm`` kept, no ``bmm`` kept; and
    where attention or the experts run, ``bmm`` was there to recompute."""
    decided = []
    policy = transformer.dots_policy

    def recording(ctx, op, *args, **kwargs):
        got = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decided.append((str(op), got))
        return got

    monkeypatch.setattr(transformer, "dots_policy", recording)
    _port(arch, "dots")
    saved = {op for op, got in decided if got == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE}
    seen = {op for op, _ in decided}
    assert saved & MM, f"{arch}: no mm output kept ({sorted(saved)})"
    assert not saved & BMM, f"{arch}: a bmm output kept"
    assert saved <= MM, f"{arch}: kept {sorted(saved - MM)}"
    cfg = _setup(arch)[2].cfg
    if cfg.family != "ssm":
        assert seen & BMM, f"{arch}: no bmm in the period"


def test_the_encoder_decoder_takes_dots_as_full():
    arch = "seamless-m4t-large-v2"
    (lf, _), gf = _port(arch, "full")
    (ld, _), gd = _port(arch, "dots")
    assert torch.equal(lf, ld)
    for a, b in zip(tree_leaves(gd), tree_leaves(gf)):
        assert torch.equal(a, b)
