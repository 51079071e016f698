"""Port vs reference: the functional optimizers and schedules
(``repro_torch.optim`` against ``repro.optim.optimizers``).

Each optimizer runs ``STEPS`` steps in both packages on the same numpy
trees (params, and a fresh gradient tree a step, made from a seed), each
package chaining its own state; every step's updates and state are held to
the reference's.  Tolerance: ``RTOL`` / ``ATOL`` (tests/_torch_parity.py) —
the arithmetic is elementwise f32 in both, and the bias corrections' f32
``pow`` may round a last digit apart; bf16 moments within one bf16 ulp
(``BF16_RTOL``), the updates computed from them likewise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import ATOL, BF16_RTOL, RTOL, assert_close
from repro.optim import optimizers as ref_opt
from repro_torch.core.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import optimizers as opt

STEPS = 6


def _tree(rng, scale=1.0):
    return {"w": (scale * rng.normal(size=(4, 3))).astype(np.float32),
            "b": (scale * rng.normal(size=(3,))).astype(np.float32),
            "stack": [{"k": (scale * rng.normal(size=(2, 2, 5))).astype(np.float32)}]}


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _close_trees(port, ref, rtol, atol, what):
    p, r = _leaves(params_to_numpy(port)), _leaves(jax.tree_util.tree_map(np.asarray, ref))
    assert len(p) == len(r)
    for i, (a, b) in enumerate(zip(p, r)):
        assert a.shape == b.shape, (what, i)
        assert_close(a, b, rtol=rtol, atol=atol, what=f"{what} leaf {i}")


CASES = {
    "sgd": (lambda m: m.sgd(0.1), False),
    "sgd-warmup-cosine": (lambda m: m.sgd(m.warmup_cosine(0.1, 2, STEPS)), False),
    "momentum": (lambda m: m.momentum(0.1, beta=0.9), False),
    "momentum-nesterov": (lambda m: m.momentum(0.05, beta=0.8, nesterov=True), False),
    "adam": (lambda m: m.adam(1e-2), False),
    "adam-eps-root-no-bias-correction": (
        lambda m: m.adam(1e-2, eps_root=1e-6, bias_correction=False), False),
    "adam-bf16-moments": (lambda m: m.adam(1e-2, moment_dtype=_bf16(m)), True),
    "adamw": (lambda m: m.adamw(1e-2), False),
    "adamw-warmup-cosine": (lambda m: m.adamw(m.warmup_cosine(1e-2, 2, STEPS)), False),
    "adamw-mask": (lambda m: m.adamw(1e-2, weight_decay=0.3, mask=_mask(m)), False),
    "adamw-bf16-moments": (lambda m: m.adamw(1e-2, moment_dtype=_bf16(m)), True),
    "adamw-exponential-decay": (lambda m: m.adamw(m.exponential_decay(1e-2, 0.7)), False),
}


def _bf16(module):
    return torch.bfloat16 if module is opt else jnp.bfloat16


def _mask(module):
    """Decay only the ``b`` leaf and the stack (the default mask would skip ``b``)."""
    def mask(params):
        return {"w": False, "b": True, "stack": [{"k": True}]}
    return mask


@pytest.mark.parametrize("case", CASES)
def test_optimizer_matches_reference_step_for_step(case):
    make, bf16 = CASES[case]
    ref, port = make(ref_opt), make(opt)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    r_state = ref.init(jax.tree_util.tree_map(jnp.asarray, params))
    p_state = port.init(params_from_numpy(params))
    rtol = BF16_RTOL if bf16 else RTOL
    for step in range(STEPS):
        grads = _tree(rng, scale=0.1 * (step + 1))
        r_upd, r_state = ref.update(jax.tree_util.tree_map(jnp.asarray, grads), r_state,
                                    jax.tree_util.tree_map(jnp.asarray, params))
        p_upd, p_state = port.update(params_from_numpy(grads), p_state, params_from_numpy(params))
        _close_trees(p_upd, r_upd, rtol, ATOL, f"{case} step {step} updates")
        _close_trees(p_state, r_state, rtol, ATOL, f"{case} step {step} state")
        for p, r in zip(_leaves(p_state), _leaves(r_state)):
            assert str(p.dtype).split(".")[-1] == str(r.dtype), case
        params = jax.tree_util.tree_map(lambda a, u: (a + np.asarray(u, np.float32)), params,
                                        jax.tree_util.tree_map(np.asarray, r_upd))


def test_step_is_a_0d_int32_tensor_and_inputs_stay_untouched():
    rng = np.random.default_rng(1)
    params, grads = params_from_numpy(_tree(rng)), params_from_numpy(_tree(rng))
    before = [t.clone() for t in _leaves(params) + _leaves(grads)]
    adamw = opt.adamw(1e-2)
    state = adamw.init(params)
    assert state[0].dtype == torch.int32 and state[0].shape == ()
    _, state2 = adamw.update(grads, state, params)
    assert int(state2[0]) == 1 and int(state[0]) == 0
    moments = [t.clone() for t in _leaves(state2)]
    upd, _ = adamw.update(grads, state2, params)  # from nonzero moments
    for a, b in zip(before + moments, _leaves(params) + _leaves(grads) + _leaves(state2)):
        assert torch.equal(a, b)
    assert not any(u.data_ptr() == t.data_ptr() for u in _leaves(upd)
                   for t in _leaves(params) + _leaves(grads) + _leaves(state2))


def test_adamw_default_mask_decays_matrices_only():
    """With zero gradients AdamW's update is the decay alone: −lr·wd·p on
    leaves with ndim ≥ 2 and exactly 0 on the vector leaf."""
    params = params_from_numpy(_tree(np.random.default_rng(2)))
    grads = {"w": torch.zeros(4, 3), "b": torch.zeros(3), "stack": [{"k": torch.zeros(2, 2, 5)}]}
    adamw = opt.adamw(0.5, weight_decay=0.1)
    upd, _ = adamw.update(grads, adamw.init(params), params)
    assert torch.equal(upd["b"], torch.zeros(3))
    assert_close(upd["w"], -0.05 * params["w"], rtol=RTOL, atol=ATOL)
    assert_close(upd["stack"][0]["k"], -0.05 * params["stack"][0]["k"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _tree(np.random.default_rng(3))
    r_g, r_n = ref_opt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
    p_g, p_n = opt.clip_by_global_norm(params_from_numpy(grads), max_norm)
    assert p_n.dtype == torch.float32 and p_n.shape == ()
    assert_close(p_n, r_n, rtol=RTOL, atol=ATOL)
    _close_trees(p_g, r_g, RTOL, ATOL, f"clip {max_norm}")
    if max_norm > float(r_n):
        for a, b in zip(_leaves(p_g), _leaves(params_from_numpy(grads))):
            assert torch.equal(a, b)  # below the norm the scale is exactly 1


@pytest.mark.parametrize("sched", ["warmup_cosine", "warmup_cosine_floor", "exponential_decay"])
def test_schedules_match_reference(sched):
    make = {"warmup_cosine": lambda m: m.warmup_cosine(3e-4, 20, 100),
            "warmup_cosine_floor": lambda m: m.warmup_cosine(1.0, 0, 7, floor=0.0),
            "exponential_decay": lambda m: m.exponential_decay(0.1, 0.998)}[sched]
    ref, port = make(ref_opt), make(opt)
    for step in range(0, 130, 3):
        r = ref(jnp.int32(step))
        p = port(torch.tensor(step, dtype=torch.int32))
        assert p.dtype == torch.float32
        assert_close(p, r, rtol=RTOL, atol=0.0, what=f"{sched} step {step}")
        assert_close(port(step), r, rtol=RTOL, atol=0.0, what=f"{sched} int step {step}")
