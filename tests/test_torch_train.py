"""Port vs reference: the LM training half — ``loss_fn`` and its gradients,
``cross_entropy``, the plain blocked attention, the train step, the batch
iterator — on the reduced configs of all ten archs, with the reference's
``model.init(PRNGKey(0))`` weights converted leaf for leaf
(``repro_torch.core.convert.params_from_numpy``).

The oracle for the train step is the reference's own recipe composed by
hand — ``jax.value_and_grad(model.loss_fn)``, the microbatch accumulation
of ``launch/steps.py``, ``clip_by_global_norm``, ``adamw`` and the f32
cast of the update — not ``build_train_step``, whose sharding constraints
fail on a CPU without a mesh (ROADMAP queue C).  Each step starts both
packages from the reference's params and AdamW state (carried into the
port by ``params_from_numpy``), so a step's difference cannot compound.

Tolerances (tests/_torch_parity.py): the loss and the grad norm at
``LM_RTOL`` / ``LM_ATOL``; each gradient leaf and each AdamW moment leaf
after a step within ``GRAD_REL_L2`` relative L2, each leaf's update (new −
old params) within ``UPDATE_REL_L2``; ``attend_blocked`` against the
reference's at ``LM_RTOL`` / ``LM_ATOL`` and against ``attend_direct`` at
the reference's own 3e-5.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import GRAD_REL_L2, LM_ATOL, LM_RTOL, UPDATE_REL_L2, assert_close
from repro.configs.base import ShapeConfig
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.data.pipeline import lm_batch_iterator as ref_lm_batch_iterator
from repro.models import build_model as ref_build_model
from repro.models import layers as ref_layers
from repro.models.model import cross_entropy as ref_cross_entropy
from repro.optim import optimizers as ref_opt
from repro_torch.configs.base import ARCH_IDS, ModelConfig
from repro_torch.core.convert import params_from_numpy, params_to_numpy, to_numpy
from repro_torch.data.pipeline import lm_batch_iterator
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.launch.steps import Knobs, build_train_step, value_and_grad
from repro_torch.models import layers
from repro_torch.models.model import build_model, cross_entropy
from repro_torch.optim.optimizers import adamw
from repro_torch.utils.trees import tree_leaves, tree_map

torch.set_num_threads(1)

SHAPE = ShapeConfig("smoke", "train", seq_len=16, global_batch=2)


def port_model_cfg(ref_cfg) -> ModelConfig:
    names = {f.name for f in fields(ModelConfig)}
    return ModelConfig(**{f.name: getattr(ref_cfg, f.name) for f in fields(ref_cfg)
                          if f.name in names})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(arch, seed=0):
    rcfg = ref_reduced(ref_get_config(arch))
    rmodel, model = ref_build_model(rcfg), build_model(port_model_cfg(rcfg))
    return rcfg, rmodel, model, rmodel.init(jax.random.PRNGKey(seed))


def _batch(rbatch):
    return params_from_numpy(_np(rbatch))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close_rel(port_tree, ref_tree, what, bound=GRAD_REL_L2):
    p, r = tree_leaves(params_to_numpy(port_tree)), jax.tree_util.tree_leaves(_np(ref_tree))
    assert len(p) == len(r)
    for i, (a, b) in enumerate(zip(p, r)):
        assert a.shape == b.shape, (what, i)
        assert np.isfinite(a).all(), (what, i)
        assert rel_l2(a, b) <= bound, (what, i, rel_l2(a, b))


# ------------------------------------------------------------- loss and grads
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    """``value_and_grad(loss_fn)``: loss, its xent / aux metrics and every
    gradient leaf, on the plain route the training path takes."""
    _, rmodel, model, rparams = _setup(arch)
    rbatch = rmodel.dummy_batch(SHAPE)
    (rl, rmet), rgrads = jax.value_and_grad(rmodel.loss_fn, has_aux=True)(rparams, rbatch)
    (loss, met), grads = value_and_grad(model.loss_fn, params_from_numpy(_np(rparams)),
                                        _batch(rbatch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert_close(loss, rl, rtol=LM_RTOL, atol=LM_ATOL)
    for k in ("xent", "aux"):
        assert_close(met[k], rmet[k], rtol=LM_RTOL, atol=LM_ATOL, what=k)
    _close_rel(grads, rgrads, f"{arch} grads")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dummy_batch_matches_reference(arch):
    _, rmodel, model, _ = _setup(arch)
    rbatch = _np(rmodel.dummy_batch(SHAPE))
    batch = model.dummy_batch(SHAPE.global_batch, SHAPE.seq_len)
    assert sorted(batch) == sorted(rbatch)
    for k, v in batch.items():
        np.testing.assert_allclose(to_numpy(v), np.asarray(rbatch[k], np.float32), rtol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("z_reg", [0.0, 1e-4])
def test_cross_entropy_matches_reference(z_reg):
    """Over a padded vocab (the pad columns enter logsumexp, as in the
    reference), value and gradient."""
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(2, 7, 512))).astype(np.float32)
    labels = rng.integers(0, 500, size=(2, 7)).astype(np.int32)
    rv, rg = jax.value_and_grad(lambda lg: ref_cross_entropy(lg, jnp.asarray(labels), z_reg))(
        jnp.asarray(logits))
    lt = torch.tensor(logits, requires_grad=True)
    v = cross_entropy(lt, torch.as_tensor(labels), z_reg)
    v.backward()
    assert_close(v.detach(), rv, rtol=LM_RTOL, atol=LM_ATOL)
    assert rel_l2(lt.grad.numpy(), rg) <= GRAD_REL_L2


# ----------------------------------------------------------- attend_blocked
@pytest.mark.parametrize("case", [
    dict(causal=True, window=None, q_block=16, kv_block=16),
    dict(causal=True, window=None, q_block=32, kv_block=16),
    dict(causal=True, window=None, q_block=16, kv_block=32),
    dict(causal=True, window=13, q_block=16, kv_block=16),
    dict(causal=True, window=13, q_block=16, kv_block=32),
    dict(causal=True, window=None, q_block=16, kv_block=16, causal_skip=True),
    dict(causal=True, window=None, q_block=16, kv_block=32, causal_skip=True),
    dict(causal=False, window=None, q_block=16, kv_block=32),
])
def test_attend_blocked_matches_reference_and_direct(case):
    """The port always skips the kv blocks past a causal q block's diagonal;
    the reference does with ``causal_skip``, and is held here both ways."""
    B, S, H, Hkv, hd = 2, 50, 4, 2, 16
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32) for h in (H, Hkv, Hkv))
    pos = np.arange(S)
    ref = ref_layers.attend_blocked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    scale=hd ** -0.5, q_positions=jnp.asarray(pos),
                                    kv_positions=jnp.asarray(pos), **case)
    tq, tk, tv, tpos = (torch.as_tensor(a) for a in (q, k, v, pos))
    out = layers.attend_blocked(tq, tk, tv, scale=hd ** -0.5, q_positions=tpos,
                                kv_positions=tpos,
                                **{key: a for key, a in case.items() if key != "causal_skip"})
    assert_close(out, ref, rtol=LM_RTOL, atol=LM_ATOL)
    msk = torch.ones((S, S), dtype=torch.bool)
    if case["causal"]:
        msk &= tpos[:, None] >= tpos[None, :]
    if case["window"] is not None:
        msk &= tpos[:, None] - tpos[None, :] < case["window"]
    direct = layers.attend_direct(tq, tk, tv, msk[None, None], hd ** -0.5)
    assert_close(out, direct, rtol=3e-5, atol=3e-5)


def test_plain_route_switches_to_attend_blocked_at_the_threshold(monkeypatch):
    """Self- and cross-attention take ``attend_blocked`` from
    ``BLOCKED_ATTENTION_THRESHOLD`` tokens, as the reference does; with the
    threshold lowered, the decoder-only and encoder-decoder losses still
    match the direct route's."""
    for arch in ("llama3.2-1b", "seamless-m4t-large-v2"):
        _, rmodel, model, rparams = _setup(arch)
        params, batch = params_from_numpy(_np(rparams)), _batch(rmodel.dummy_batch(SHAPE))
        direct = model.loss_fn(params, batch)[0]
        calls = []
        blocked = layers.attend_blocked

        def counting(*a, **kw):
            calls.append(1)
            return blocked(*a, **kw)

        monkeypatch.setattr(layers, "BLOCKED_ATTENTION_THRESHOLD", 8)
        monkeypatch.setattr(layers, "attend_blocked", counting)
        from repro_torch.models import encdec
        monkeypatch.setattr(encdec, "BLOCKED_ATTENTION_THRESHOLD", 8)
        monkeypatch.setattr(encdec, "attend_blocked", counting)
        assert_close(model.loss_fn(params, batch)[0], direct, rtol=LM_RTOL, atol=LM_ATOL)
        assert calls, arch
        monkeypatch.undo()


# ---------------------------------------------------------------- train step
def _ref_train_step(rmodel, M, lr, clip):
    """The reference's train step composed by hand from ``launch/steps.py``."""
    opt = ref_opt.adamw(lr)

    def vg(params, mb):
        return jax.value_and_grad(rmodel.loss_fn, has_aux=True)(params, mb)

    @jax.jit
    def step(params, opt_state, batch):
        if M == 1:
            (loss, _), grads = vg(params, batch)
        else:
            micro = jax.tree_util.tree_map(lambda x: x.reshape(M, x.shape[0] // M,
                                                               *x.shape[1:]), batch)
            grads = jax.tree_util.tree_map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
            loss = jnp.float32(0.0)
            for i in range(M):
                (l, _), g = vg(params, jax.tree_util.tree_map(lambda x: x[i], micro))
                grads = jax.tree_util.tree_map(lambda a, gi: a + gi.astype(a.dtype), grads, g)
                loss = loss + l
            grads = jax.tree_util.tree_map(lambda g: g / M, grads)
            loss = loss / M
        grads, gnorm = ref_opt.clip_by_global_norm(grads, clip)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(
            lambda p, u: (p.astype(jnp.float32) + u.astype(jnp.float32)).astype(p.dtype),
            params, updates)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return opt, step


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "dbrx-132b", "mamba2-1.3b",
                                  "seamless-m4t-large-v2"])
def test_train_step_matches_hand_composed_reference(arch, M):
    _, rmodel, model, rparams = _setup(arch)
    lr, clip = 1e-3, 1.0
    ropt, rstep = _ref_train_step(rmodel, M, lr, clip)
    step = build_train_step(model.cfg, Knobs(microbatches=M, remat="none", learning_rate=lr,
                                             grad_clip=clip))
    rstate = ropt.init(rparams)
    batch = _np(rmodel.dummy_batch(ShapeConfig("t", "train", seq_len=16, global_batch=4)))
    for t in range(3):
        params, state = params_from_numpy(_np(rparams)), params_from_numpy(_np(rstate))
        assert state[0].dtype == torch.int32 and int(state[0]) == t
        new, new_state, met = step.fn(params, state, params_from_numpy(batch))
        rnew, rstate, rmet = rstep(rparams, rstate, batch)
        assert_close(met["loss"], rmet["loss"], rtol=LM_RTOL, atol=LM_ATOL, what=f"step {t}")
        assert_close(met["grad_norm"], rmet["grad_norm"], rtol=LM_RTOL, atol=LM_ATOL)
        upd = tree_map(lambda a, b: a - b, new, params)
        rupd = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), rnew, rparams)
        _close_rel(upd, rupd, f"{arch} M={M} step {t} updates", UPDATE_REL_L2)
        _close_rel(new_state[1:], rstate[1:], f"{arch} M={M} step {t} moments")
        assert int(new_state[0]) == int(rstate[0]) == t + 1
        rparams = rnew


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_decreases_over_a_few_steps(arch):
    """The reference's ``test_arch_smoke`` recipe on the port: AdamW(3e-3)
    on one dummy batch, 8 steps, the last loss below the first."""
    _, _, model, _ = _setup(arch)
    params = model.init(torch.Generator().manual_seed(0))
    opt = adamw(3e-3)
    state = opt.init(params)
    batch = model.dummy_batch(SHAPE.global_batch, SHAPE.seq_len)
    losses = []
    for _ in range(8):
        (loss, _), grads = value_and_grad(model.loss_fn, params, batch)
        upd, state = opt.update(grads, state, params)
        params = tree_map(torch.add, params, upd)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_remat_full_gives_the_same_gradients_and_dots_refuses():
    """``"full"`` and ``"dots"`` (ported: tests/test_torch_remat_dots.py) give
    ``"none"``'s loss and gradients; a policy that is none of the three
    refuses."""
    for arch in ("zamba2-7b", "seamless-m4t-large-v2"):
        _, rmodel, model, rparams = _setup(arch)
        params, batch = params_from_numpy(_np(rparams)), _batch(rmodel.dummy_batch(SHAPE))
        (l0, _), g0 = value_and_grad(model.loss_fn, params, batch)
        for remat in ("full", "dots"):
            (l1, _), g1 = value_and_grad(lambda p, b: model.loss_fn(p, b, remat=remat), params,
                                         batch)
            assert torch.equal(l0, l1), (arch, remat)
            for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
                assert_close(a, b, rtol=LM_RTOL, atol=LM_ATOL, what=f"{arch} {remat}")
        with pytest.raises(ValueError, match="remat must be one of"):
            model.loss_fn(params, batch, remat="dotz")
    with pytest.raises(ValueError, match="remat must be one of"):
        build_train_step(model.cfg, Knobs(remat="dotz"))


def test_use_kernels_knob_raises():
    _, _, model, _ = _setup("llama3.2-1b")
    with pytest.raises(NotImplementedError, match="no backward"):
        build_train_step(model.cfg, Knobs(use_kernels=True))


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """Before any build or launch: a kernel's output would carry no
    gradient, so a loss through it would silently stop there."""
    q = torch.zeros((1, 4, 2, 8), requires_grad=True)
    k = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="use_kernels=False"):
        fa_kernel.flash_attention_bshd(q, k, k)
    x = torch.zeros((1, 4, 2, 8))
    dt = torch.zeros((1, 4, 2), requires_grad=True)
    A = torch.zeros(2)
    Bm = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="use_kernels=False"):
        ssd_kernel.ssd_scan(x, dt, A, Bm, Bm, chunk=4)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed", [0, 3])
def test_lm_batch_iterator_matches_reference(seed):
    toks = np.random.default_rng(9).integers(0, 512, size=(40, 17)).astype(np.int32)
    ref, port = ref_lm_batch_iterator(toks, 5, seed=seed), lm_batch_iterator(toks, 5, seed=seed)
    for _ in range(4):
        r, p = next(ref), next(port)
        for k in ("tokens", "labels"):
            assert p[k].dtype == torch.int64 and tuple(p[k].shape) == (5, 16)
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(r[k]))
    p32 = next(lm_batch_iterator(toks, 5, seed=seed, dtype=torch.int32))
    assert p32["tokens"].dtype == torch.int32


def test_adamw_state_carries_both_ways():
    """``params_from_numpy`` / ``params_to_numpy`` carry the reference's
    ``(step, m, v)`` AdamW state, the int32 step included."""
    _, rmodel, _, rparams = _setup("seamless-m4t-large-v2")
    rstate = ref_opt.adamw(1e-3).init(rparams)
    rstate = (rstate[0] + 3, *(jax.tree_util.tree_map(lambda a: a + 0.5, t) for t in rstate[1:]))
    state = params_from_numpy(_np(rstate))
    assert isinstance(state, tuple) and state[0].dtype == torch.int32 and int(state[0]) == 3
    back = params_to_numpy(state)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(_np(rstate))):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for key in ("enc", "dec", "embed", "unembed", "enc_norm", "dec_norm"):
        assert key in state[1]


def test_encdec_loss_is_the_cross_entropy_and_aux_is_zero():
    _, rmodel, model, rparams = _setup("seamless-m4t-large-v2")
    params = params_from_numpy(_np(rparams))
    batch = _batch(rmodel.dummy_batch(SHAPE))
    loss, met = model.loss_fn(params, batch)
    logits, cache, aux = model.apply(params, batch)
    assert cache is None and float(aux) == 0.0 and float(met["aux"]) == 0.0
    assert torch.equal(loss, met["xent"])
    assert_close(loss, cross_entropy(logits, batch["labels"]), rtol=0, atol=0)


def test_moe_gradients_reach_experts_and_router():
    """The capacity MoE under autograd: nonzero gradients into every expert
    GEMM weight and the router (gates and the aux loss), matching the
    reference's (test_loss_and_grads_match_reference holds the values)."""
    _, rmodel, model, rparams = _setup("dbrx-132b")
    (_, _), grads = value_and_grad(model.loss_fn, params_from_numpy(_np(rparams)),
                                   _batch(rmodel.dummy_batch(SHAPE)))
    moe = grads["periods"]["slot0"]["moe"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert float(moe[name].abs().sum()) > 0, name
