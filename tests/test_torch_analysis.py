"""Tests for repro_torch.analysis — the lint's rule fixtures and the contracts.

Mirrors tests/test_analysis.py.  Each REP rule gets a failing, a passing
and a suppressed fixture, run through ``lint_sources`` with virtual paths
so the scope rules (REP001's core/kernels/sharding gate, REP002's reach
into the examples and the smoke script, REP003's round roots) are
exercised too.  The contract tests show each checker *detects* its
planted break (a reallocating fold, a host read in a round, a bf16 plane,
a ``reduce_scatter`` fold), and that the shipped engine passes.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.lint import (
    REP001,
    REP002,
    REP003,
    REP004,
    REP005,
    lint_repo,
    lint_sources,
    load_baseline,
    sync_readme,
)
from repro_torch.analysis.trace import (
    MATRIX,
    QUICK,
    check_entry,
    f32_plane_violations,
    reduce_scatter_fold,
    tiny_problem,
)

ROOT = Path(__file__).resolve().parents[1]
CORE = "src/repro_torch/core/fixture.py"
ENGINE = "src/repro_torch/core/engine.py"
LAUNCH = "src/repro_torch/launch/fixture.py"
ENTRIES = {e.name: e for e in MATRIX}


def rules_of(findings):
    return sorted({f.rule for f in findings})


def run_rule(rule_cls, src, path=CORE):
    return lint_sources({path: src}, rules=[rule_cls()])


# --------------------------------------------------------------- REP001
REP001_BAD = """
def pick(cfg):
    if cfg.algo == "fedcm":
        return 1
    return 0
"""

REP001_OK = """
def pick(cfg, registry):
    spec = registry.get(cfg.algo)
    return spec.fold
"""


def test_rep001_flags_name_keyed_branch():
    assert rules_of(run_rule(REP001, REP001_BAD)) == ["REP001"]


def test_rep001_passes_registry_dispatch():
    assert run_rule(REP001, REP001_OK) == []


def test_rep001_scope_is_core_kernels_sharding_only():
    assert run_rule(REP001, REP001_BAD, path=LAUNCH) == []


def test_rep001_suppressed_with_reason():
    src = REP001_BAD.replace('== "fedcm":', '== "fedcm":  # repro: noqa REP001 -- legacy shim')
    assert run_rule(REP001, src) == []


def test_reasonless_noqa_is_ignored():
    src = REP001_BAD.replace('== "fedcm":', '== "fedcm":  # repro: noqa REP001')
    assert rules_of(run_rule(REP001, src)) == ["REP001"]


# --------------------------------------------------------------- REP002
REP002_BAD = """
import importlib
import jax.numpy as jnp
from repro.core import FederatedEngine

def load():
    return importlib.import_module("jaxlib")
"""

REP002_OK = """
import torch
from repro_torch.core import FederatedEngine
import reprolib

def load():
    return torch.zeros(3)
"""


@pytest.mark.parametrize("path", [LAUNCH, "examples/torch/fixture.py", "chip_smoke.py"])
def test_rep002_flags_jax_and_reference_imports(path):
    found = run_rule(REP002, REP002_BAD, path=path)
    assert len(found) == 3 and rules_of(found) == ["REP002"]
    assert {"`jax.numpy`", "`repro.core`", "`jaxlib`"} == {
        f.message.split()[1] for f in found}


def test_rep002_passes_torch_and_port_imports():
    assert run_rule(REP002, REP002_OK, path=LAUNCH) == []


def test_rep002_suppressed_with_reason():
    src = REP002_BAD.replace("import jax.numpy as jnp",
                             "import jax.numpy as jnp  # repro: noqa REP002 -- fixture")
    assert len(run_rule(REP002, src, path=LAUNCH)) == 2


def test_no_module_of_the_port_imports_jax_or_the_reference():
    assert lint_repo(rules=[REP002()]) == []


# --------------------------------------------------------------- REP003
REP003_BAD = """
class FederatedEngine:
    def round_step(self, state):
        return float(state.sum())
"""

# reachability: the read sits in a helper of another module that a root calls
REP003_HELPER = """
def helper(x):
    return x.item()

def host_side(x):
    return x.cpu().numpy()
"""

REP003_BAD_INDIRECT = """
from repro_torch.core.fixture import helper

class FederatedEngine:
    def _fold(self, state):
        return self._close(state)

    def _close(self, state):
        return helper(state)
"""

REP003_OK = """
import torch

class FederatedEngine:
    def round_step(self, state, cfg):
        return state * float(cfg.lr) + int(state.shape[0]) + float(len(cfg.rows))

    def report(self, state):
        print(float(state.loss))
        torch.cuda.synchronize()
"""


def test_rep003_flags_host_read_in_a_round():
    assert rules_of(run_rule(REP003, REP003_BAD, path=ENGINE)) == ["REP003"]


def test_rep003_resolves_the_call_graph_across_modules():
    found = lint_sources({ENGINE: REP003_BAD_INDIRECT, CORE: REP003_HELPER},
                         rules=[REP003()])
    assert [(f.path, f.rule) for f in found] == [(CORE, "REP003")]
    assert ".item()" in found[0].message  # host_side is not reachable


def test_rep003_static_values_and_host_code_pass():
    assert run_rule(REP003, REP003_OK, path=ENGINE) == []


def test_rep003_suppressed_with_reason():
    src = REP003_BAD.replace("float(state.sum())",
                             "float(state.sum())  # repro: noqa REP003 -- fixture")
    assert run_rule(REP003, src, path=ENGINE) == []


# --------------------------------------------------------------- REP004
REP004_BAD = """
import torch

def draw(n):
    a = torch.randn(n)
    return a.uniform_(0, 1)
"""

REP004_BAD_RESEED = """
import torch

class FederatedEngine:
    def _launch(self, state):
        state.rng.manual_seed(0)
        return torch.rand(3, generator=state.rng)
"""

REP004_OK = """
import torch

def draw(n, gen):
    gen.manual_seed(0)  # before the rounds
    a = torch.randn(n, generator=gen)
    return a.uniform_(0, 1, generator=gen) + torch.randperm(n, generator=gen)
"""


def test_rep004_flags_draws_without_a_generator():
    found = run_rule(REP004, REP004_BAD)
    assert len(found) == 2 and rules_of(found) == ["REP004"]
    assert "generator=" in found[0].message


def test_rep004_flags_a_reseed_inside_a_round():
    found = run_rule(REP004, REP004_BAD_RESEED, path=ENGINE)
    assert rules_of(found) == ["REP004"] and "re-seeds" in found[0].message


def test_rep004_passes_seeded_draws():
    assert run_rule(REP004, REP004_OK) == []


def test_rep004_suppressed_with_reason():
    src = REP004_BAD.replace("a = torch.randn(n)",
                             "a = torch.randn(n)  # repro: noqa REP004 -- fixture")
    assert len(run_rule(REP004, src)) == 1


# --------------------------------------------------------------- REP005
REP005_BAD = """
import torch

def fold(x, dt):
    a = torch.sum(x.to(torch.bfloat16))
    return a + x.to(dt).sum()
"""

REP005_OK = """
import torch

def fold(x, w, dt):
    a = torch.sum(x.to(torch.bfloat16), dtype=torch.float32)
    b = x.to(dt).mean().float()
    c = torch.tensordot(w.to(dt), x.to(dt), dims=1).to(torch.float32)
    d = torch.sum(x) + torch.einsum("i,i->", x, w.to(x.dtype)) + x.to(x.device).sum()
    return a + b + c + d
"""


def test_rep005_flags_subf32_reductions():
    found = run_rule(REP005, REP005_BAD)
    assert len(found) == 2 and rules_of(found) == ["REP005"]


def test_rep005_passes_mitigated_and_aligned():
    assert run_rule(REP005, REP005_OK) == []


def test_rep005_suppressed_with_reason():
    src = REP005_BAD.replace("x.to(dt).sum()",
                             "x.to(dt).sum()  # repro: noqa REP005 -- fixture")
    assert len(run_rule(REP005, src)) == 1


# ----------------------------------------------------- repo + README gates
def test_repo_is_lint_clean_modulo_baseline():
    base = load_baseline()
    assert base == set()  # it ships empty: every exception is an inline reason
    fresh = [f for f in lint_repo() if f.baseline_key not in base]
    assert fresh == [], "\n".join(str(f) for f in fresh)


def test_readme_rule_table_in_sync():
    assert sync_readme(write=False), (
        "src/repro_torch/analysis/README.md rule table is stale — regenerate with "
        "`python -m repro_torch.analysis.lint --write`")


def test_both_clis_exit_zero_on_the_shipped_tree():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    for args in (["repro_torch.analysis.lint"],
                 ["repro_torch.analysis.trace", "--quick", "--device", "cpu"]):
        out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stdout + out.stderr
        assert " 0 new finding(s)" in out.stdout or "2/2 contract entries clean" in out.stdout


# ------------------------------------------------------- Layer-2 contracts
def _reallocating(eng):
    """A planted break for (a): every fold writes new planes."""
    fold = eng._fold
    eng._fold = lambda *a, **k: fold(*a, **{**k, "in_place": False})


def _reads_back(eng):
    """A planted break for (b): the fold reads the cohort size back."""
    fold = eng._fold

    def broken(state, entry, *a, **k):
        entry.w.sum().item()
        return fold(state, entry, *a, **k)

    eng._fold = broken


@pytest.mark.parametrize("name", QUICK)
def test_in_place_break_is_detected(name):
    assert check_entry(ENTRIES[name]).in_place_ok
    rep = check_entry(ENTRIES[name], fold_hook=_reallocating)
    assert rep.in_place_ok is False and any("reallocated" in n for n in rep.notes)


def test_host_read_in_a_round_is_detected():
    rep = check_entry(ENTRIES["sync/resident"], fold_hook=_reads_back)
    assert rep.host_ok is False and any("_local_scalar_dense" in n for n in rep.notes)


def test_bf16_plane_is_detected_and_the_bf16_entry_passes():
    rep = check_entry(ENTRIES["sync/bf16"])
    assert rep.ok and rep.f32_planes_ok and rep.in_place_ok and rep.host_ok
    eng, data, fresh = tiny_problem(bf16=True)
    st = fresh()
    assert f32_plane_violations(st) == []
    bad = f32_plane_violations(st._replace(params=st.params.to(torch.bfloat16)))
    assert bad == ["params is torch.bfloat16"]


def test_reduce_scatter_fold_is_detected_and_the_sharded_fold_passes():
    assert check_entry(ENTRIES["sync/sharded"], n_rounds=2).collectives_ok
    rep = check_entry(ENTRIES["sync/sharded"], fold_hook=reduce_scatter_fold, n_rounds=2)
    assert rep.collectives_ok is False
    assert any("reduce_scatter_tensor" in n for n in rep.notes)


def test_store_entries_report_the_host_contracts_not_applicable():
    rep = check_entry(ENTRIES["sync/store"], n_rounds=2)
    assert rep.ok and rep.in_place_ok is None and rep.host_ok is None and rep.f32_planes_ok
