"""The port's LM training CLI, ``python -m repro_torch.launch.train``, on the
CPU: it trains (the loss falls) for a decoder-only and the encoder-decoder
arch, logs the reference's columns, resumes from ``--ckpt-dir`` at the
saved step with params and AdamW state byte-equal to the snapshot (a
resumed run's later snapshots equal a straight run's byte for byte), and
raises on a machine with no GPU unless ``--device cpu`` asks for the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint.ckpt import load_checkpoint
from repro_torch.launch import train
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--batch", "4", "--seq", "16", "--warmup", "2", "--lr", "3e-3", "--device", "cpu"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "seamless-m4t-large-v2"])
def test_cli_trains_on_cpu_and_the_loss_falls(arch, capsys):
    args = train.build_parser().parse_args(["--arch", arch, "--steps", "12", "--log-every", "4",
                                            *SMALL])
    res = train.run(args)
    assert res.start_step == 0 and len(res.losses) == len(res.step_s) == 12
    assert res.losses[-1] < res.losses[0], res.losses
    assert [r["step"] for r in res.rows] == [4, 8, 12]
    assert all(r["tok_per_s"] > 0 and r["grad_norm"] > 0 for r in res.rows)
    assert res.peak_bytes is None
    out = capsys.readouterr()
    assert f"final loss: {res.losses[-1]:.4f}" in out.out
    assert ("enc-dec arch" in out.out) == (arch == "seamless-m4t-large-v2")
    assert "loss=" in out.err and "grad_norm=" in out.err and "tok_per_s=" in out.err


def test_cli_without_device_raises_when_there_is_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--steps", "1"])


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-large-v2"])
def test_ckpt_resume_restarts_at_the_saved_step_byte_for_byte(arch, tmp_path, capsys,
                                                             monkeypatch):
    """A straight 9-step run snapshots steps 3, 6 and 9; a run resumed from
    its step-6 snapshot alone (as if killed after step 6) restarts there,
    with params and AdamW state equal to the snapshot, and writes a step-9
    snapshot byte-equal to the straight run's."""
    common = ["--arch", arch, "--steps", "9", "--ckpt-every", "3", "--log-every", "3", *SMALL]
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    assert train.main([*common, "--ckpt-dir", str(straight)]) == 0
    resumed.mkdir()
    (resumed / "step_6.msgpack").write_bytes((straight / "step_6.msgpack").read_bytes())
    tree, meta = load_checkpoint(str(resumed), 6, _template(arch))
    assert meta["step"] == 6 and tree["opt"][0].dtype == torch.int32 and int(tree["opt"][0]) == 6

    seen = {}
    build = train.build_train_step

    def recording(cfg, knobs):  # the state the resumed run's first step starts from
        step = build(cfg, knobs)

        def fn(params, opt_state, batch):
            seen.setdefault("state", (params, opt_state))
            return step.fn(params, opt_state, batch)

        return step._replace(fn=fn)

    monkeypatch.setattr(train, "build_train_step", recording)
    res = train.run(train.build_parser().parse_args([*common, "--ckpt-dir", str(resumed)]))
    assert res.start_step == 6 and len(res.losses) == 3
    assert "resumed from step 6" in capsys.readouterr().out
    params, opt_state = seen["state"]
    for a, b in zip(tree_leaves({"params": params, "opt": opt_state}), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (resumed / "step_9.msgpack").read_bytes() == (straight / "step_9.msgpack").read_bytes()


def _template(arch):
    """The training CLI's ``{"params", "opt"}`` tree for the reduced ``arch``."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.steps import Knobs, build_train_step

    step = build_train_step(reduced(get_config(arch)), Knobs(remat="none"))
    params = step.model.init(torch.Generator().manual_seed(0))
    return {"params": params, "opt": step.opt.init(params)}


def test_cli_module_entry_point_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-1.3b",
         "--steps", "4", "--log-every", "2", *SMALL], capture_output=True, text=True,
        env=env, timeout=180)
    assert out.returncode == 0, out.stderr
    assert "final loss:" in out.stdout and "step=4" in out.stderr
