"""Port vs reference: the capacity-based mixture of experts and the GELU MLP
(``repro_torch.models.layers``).

Inputs and weights are made with numpy from a seed and handed to both
packages.  ``moe_dropping`` is held to the reference's unsharded
``moe_dropping(parallel=None)`` over E ∈ {4, 16}, top-k ∈ {1, 2, 4}, with
and without the shared expert, at the default capacity factor and at one
that drops choices; where the capacity cannot drop, both are held to the
reference's dense ``moe_ref`` too, and the port's own ``moe_ref`` to the
reference's.  ``mlp_type="gelu"`` is ``jax.nn.gelu``'s default, the tanh
approximation: the tolerance here is one that exact-erf GELU fails.

Tolerance: ``LM_RTOL`` / ``LM_ATOL`` (tests/_torch_parity.py): the expert
and router products sum in another order in PyTorch's CPU GEMM than in
XLA's.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import LM_ATOL, LM_RTOL, assert_close
from repro.configs.base import ModelConfig as RefModelConfig
from repro.models import layers as ref_layers
from repro_torch.configs.base import ModelConfig
from repro_torch.core.convert import params_from_numpy, to_numpy
from repro_torch.models import layers

torch.set_num_threads(1)

B, S, D, FF = 2, 96, 32, 48


def _cfgs(E, k, shared, cf=1.25, mlp_type="gated_silu"):
    ref = RefModelConfig(name="moe-test", family="moe", n_layers=1, d_model=D, n_heads=2,
                         n_kv_heads=2, d_ff=FF, vocab_size=64, n_experts=E, top_k=k,
                         capacity_factor=cf, shared_expert=shared, mlp_type=mlp_type)
    port = ModelConfig(**{f.name: getattr(ref, f.name) for f in fields(ModelConfig)})
    return ref, port


def _inputs(seed, E, shared):
    rng = np.random.default_rng(seed)

    def w(*shape, fan_in):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    p = {"router": w(D, E, fan_in=D), "w_gate": w(E, D, FF, fan_in=D),
         "w_up": w(E, D, FF, fan_in=D), "w_down": w(E, FF, D, fan_in=FF)}
    if shared:
        p["shared"] = {"w_gate": w(D, FF, fan_in=D), "w_up": w(D, FF, fan_in=D),
                       "w_down": w(FF, D, fan_in=FF)}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    return p, x


def _ref(fn, p, x, cfg):
    out, aux = fn(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), cfg=cfg)
    return np.asarray(out), np.asarray(aux)


def _port(fn, p, x, cfg):
    out, aux = fn(params_from_numpy(p), torch.as_tensor(x), cfg=cfg)
    return to_numpy(out), to_numpy(aux)


def _dropped(p, x, cfg) -> int:
    """(token, choice) pairs past their expert's capacity, counted in numpy
    from the router's choices (the reference's own ``_router``)."""
    xt = jnp.asarray(x.reshape(-1, D))
    _, experts, _, _ = ref_layers._router({"router": jnp.asarray(p["router"])}, xt, cfg)
    counts = np.bincount(np.asarray(experts).reshape(-1), minlength=cfg.n_experts)
    return int(np.maximum(counts - ref_layers.moe_capacity(cfg, xt.shape[0]), 0).sum())


CASES = [(E, k, shared, cf) for E in (4, 16) for k in (1, 2, 4) for shared in (False, True)
         for cf in (1.25, 0.25)]


@pytest.mark.parametrize("E,k,shared,cf", CASES,
                         ids=lambda v: str(v).replace("True", "shared").replace("False", "-"))
def test_moe_dropping_matches_reference(E, k, shared, cf):
    rcfg, cfg = _cfgs(E, k, shared, cf)
    p, x = _inputs(E * 10 + k, E, shared)
    r_out, r_aux = _ref(ref_layers.moe_dropping, p, x, rcfg)
    out, aux = _port(layers.moe_dropping, p, x, cfg)
    assert out.shape == r_out.shape == (B, S, D) and aux.shape == r_aux.shape == ()
    assert_close(out, r_out, rtol=LM_RTOL, atol=LM_ATOL, what="out")
    assert_close(aux, r_aux, rtol=LM_RTOL, atol=LM_ATOL, what="aux")
    if cf == 0.25:  # 192 tokens: a quarter of the even share drops choices at every E, k
        assert _dropped(p, x, rcfg) > 0


@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (16, 4)])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_without_drops_matches_the_dense_oracle(E, k, shared):
    """At capacity factor E / k every expert has a slot for every token, so
    the capacity MoE is the dense every-expert one."""
    rcfg, cfg = _cfgs(E, k, shared, cf=E / k)
    p, x = _inputs(E + k + 7, E, shared)
    assert _dropped(p, x, rcfg) == 0
    r_dense, r_aux = _ref(ref_layers.moe_ref, p, x, rcfg)
    dense, aux = _port(layers.moe_ref, p, x, cfg)
    dropping, aux_d = _port(layers.moe_dropping, p, x, cfg)
    assert_close(dense, r_dense, rtol=LM_RTOL, atol=LM_ATOL, what="moe_ref")
    assert_close(dropping, r_dense, rtol=LM_RTOL, atol=LM_ATOL, what="moe_dropping")
    assert aux == aux_d
    assert_close(aux, r_aux, rtol=LM_RTOL, atol=LM_ATOL, what="aux")


def test_moe_capacity_matches_reference():
    for E, k in ((4, 1), (4, 2), (16, 4), (128, 1)):
        for cf in (0.25, 1.0, 1.25, 2.0):
            rcfg, cfg = _cfgs(E, k, False, cf)
            for T in (*range(1, 70), 1000, 4096, 4097, 16384):
                c = layers.moe_capacity(cfg, T)
                assert c == ref_layers.moe_capacity(rcfg, T), (E, k, cf, T)
                assert c >= 8 and c % 8 == 0


@pytest.mark.parametrize("k", [1, 4])
def test_moe_dropping_is_bitwise_deterministic(k):
    _, cfg = _cfgs(16, k, True, 0.25)
    p, x = _inputs(99, 16, True)
    a, b = _port(layers.moe_dropping, p, x, cfg), _port(layers.moe_dropping, p, x, cfg)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_moe_router_is_f32_beside_bf16_experts():
    _, cfg = _cfgs(4, 2, True)
    p = layers.init_moe(torch.Generator().manual_seed(0), cfg, dtype=torch.bfloat16, lead=(3,))
    assert p["router"].dtype == torch.float32 and tuple(p["router"].shape) == (3, D, 4)
    assert {t.dtype for n, t in p.items() if n != "router" and n != "shared"} == {torch.bfloat16}
    assert tuple(p["w_down"].shape) == (3, 4, FF, D)
    assert {t.dtype for t in p["shared"].values()} == {torch.bfloat16}


# ---------------------------------------------------------------- GELU MLP
GELU_ATOL = 1e-6  # tanh vs exact-erf GELU differ by up to ~5e-4 (at |x| ≈ 2)


def test_gelu_activation_is_jax_default_tanh():
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = to_numpy(torch.nn.functional.gelu(torch.as_tensor(x), approximate="tanh"))
    assert_close(got, ref, rtol=1e-6, atol=GELU_ATOL)
    erf = to_numpy(torch.nn.functional.gelu(torch.as_tensor(x)))
    assert np.abs(erf - ref).max() > 100 * GELU_ATOL  # the tolerance tells the two apart


def test_gelu_mlp_matches_reference():
    rcfg, cfg = _cfgs(4, 1, False, mlp_type="gelu")
    rng = np.random.default_rng(5)
    p = {"w_up": (rng.normal(size=(D, FF)) / np.sqrt(D)).astype(np.float32),
         "w_down": (rng.normal(size=(FF, D)) / np.sqrt(FF)).astype(np.float32)}
    x = (2 * rng.normal(size=(B, S, D))).astype(np.float32)
    ref = np.asarray(ref_layers.mlp(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                                    cfg=rcfg))
    got = to_numpy(layers.mlp(params_from_numpy(p), torch.as_tensor(x), cfg=cfg))
    assert_close(got, ref, rtol=LM_RTOL, atol=GELU_ATOL)
    init = layers.init_mlp(torch.Generator().manual_seed(0), cfg, lead=(2,))
    assert sorted(init) == ["w_down", "w_up"] and tuple(init["w_up"].shape) == (2, D, FF)
