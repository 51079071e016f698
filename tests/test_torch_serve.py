"""The port's serving CLI, ``python -m repro_torch.launch.serve``, against the
reference's ``repro.launch.serve``.

Both CLIs draw random weights from ``--seed``, JAX with threefry and the
port with a ``torch.Generator``, so the greedy-token comparison hands the
port the reference's ``model.init(PRNGKey(seed))`` weights (wrapping the
port's ``build_model``); the prompts are each package's own
``make_synthetic_lm`` draw over the same 512-token vocabulary, the same
draw.  Everything else — prefill, the cache merge, greedy decode — is each
CLI's own.  ``serve_loop`` is held to the reference's hot-swap contract.
The CLI runs on ``cuda`` unless ``--device cpu`` asks for the CPU, and
raises on a machine with no GPU.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro_torch.core.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.serve import serve_loop

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--batch", "2", "--prompt-len", "12", "--gen", "8", "--seed", "3"]


def _samples(text):
    lines = text.splitlines()
    i = lines.index("sample generations (first 16 tokens):")
    return [line.strip() for line in lines[i + 1:] if line.strip().startswith("[")]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_greedy_tokens_match_reference_cli(arch, monkeypatch, capsys):
    assert ref_serve.main(["--arch", arch, *SMALL]) == 0
    expected = _samples(capsys.readouterr().out)

    rparams = ref_build_model(ref_reduced(ref_get_config(arch))).init(jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    build = serve.build_model

    def with_reference_weights(cfg):
        return build(cfg)._replace(init=lambda generator: params_from_numpy(tree))

    monkeypatch.setattr(serve, "build_model", with_reference_weights)
    assert serve.main(["--arch", arch, *SMALL, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced batch=2 prompt=12 gen=8 sessions=1" in out
    assert "prefill:" in out and "decode:" in out
    assert _samples(out) == expected and len(expected) == 2


def test_run_serves_every_session_and_is_deterministic():
    args = serve.build_parser().parse_args(["--arch", "mamba2-1.3b", *SMALL, "--sessions", "2",
                                            "--temperature", "0.7", "--device", "cpu"])
    a, b = serve.run(args), serve.run(args)
    assert a.tokens.shape == (2, 8) and a.tokens.min() >= 0 and a.tokens.max() < 50280
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.stats.sessions == 2 and a.stats.steps == 2 * 7
    assert len(a.prefill_s) == len(a.decode_s) == 2


def test_cli_without_device_raises_when_there_is_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(SMALL)


@pytest.mark.parametrize("flags,item", [(["--ckpt", "runs/pub"], "A.12"),
                                        (["--follow"], "A.13"),
                                        (["--arch", "zamba2-7b"], "A.15")])
def test_unported_options_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        serve.main([*SMALL, *flags, "--device", "cpu"])


def test_cli_module_entry_point_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "llama3.2-1b", *SMALL,
         "--device", "cpu"], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "arch=llama3.2-1b-reduced" in out.stdout and len(_samples(out.stdout)) == 2


# -------------------------------------------------------------- serve_loop
class _ScriptedProvider:
    """Publishes version v at the provider-call count scripted for it."""

    def __init__(self, schedule):  # {call_index: version}
        self.schedule = dict(schedule)
        self.calls = 0

    def poll(self):
        self.calls += 1
        v = self.schedule.get(self.calls)
        if v is None:
            return None
        return v, {"version_tag": v}, {}


def test_serve_loop_every_step_sees_one_complete_version():
    provider = _ScriptedProvider({5: 2, 6: 3, 17: 4})
    seen = []

    def step(params, st, i):
        seen.append(params["version_tag"])
        return st

    params, stats = serve_loop({"version_tag": 1}, step, params_provider=provider,
                               steps_per_session=10, max_sessions=3, version=1)
    assert stats.steps == 30 and stats.sessions == 3
    assert stats.swaps == 3 and stats.versions == [2, 3, 4]
    assert seen == sorted(seen) and set(seen) == {1, 2, 3, 4}
    assert params["version_tag"] == stats.served_version == 4


def test_serve_loop_counts_mid_session_swaps_apart():
    provider = _ScriptedProvider({1: 2, 7: 3})
    _, stats = serve_loop({"v": 1}, lambda p, st, i: st, params_provider=provider,
                          steps_per_session=10, max_sessions=1, version=1)
    assert stats.swaps == 2 and stats.swaps_mid_session == 1
    assert stats.swap_steps == [0, 6]


def test_serve_loop_stop_event_breaks_between_steps():
    stop = threading.Event()
    count = {"steps": 0}

    def step(p, st, i):
        count["steps"] += 1
        if count["steps"] >= 7:
            stop.set()
        return st

    _, stats = serve_loop({"v": 1}, step, steps_per_session=5, max_sessions=None,
                          stop_event=stop)
    assert count["steps"] == 7 and stats.sessions == 1


def test_serve_loop_static_serving_without_provider():
    _, stats = serve_loop({"v": 1}, lambda p, st, i: st, steps_per_session=4, max_sessions=2)
    assert stats.steps == 8 and stats.swaps == 0
