"""``repro_torch.launch.federated_llm``: the port's counterpart of the
reference's ``examples/federated_llm.py``, run on the CPU (the kernels'
plain versions).  Its rounds are held to the reference's engine in
tests/test_torch_fed_lm.py; here the module itself: the loss falls, the
result's fields, the CLI, and the refusal without a GPU."""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import federated_llm

torch.set_num_threads(1)


def test_run_on_cpu_the_loss_falls():
    """At the reduced width the random model starts at the uniform loss
    (ln 512) and the example's η_l = 0.05 moves it by less than the noise
    of six rounds, so this run takes η_l = 1 and K = 4."""
    cfg = reduced(get_config("llama3.2-1b"))
    res = federated_llm.run(cfg, n_clients=4, cohort=2, local_steps=4, batch=2, seq=32,
                            rounds=6, eta_l=1.0, device="cpu")
    assert res.arch == "llama3.2-1b-reduced" and res.peak_bytes is None
    assert len(res.rounds) == len(res.round_ms) == 6
    losses = [r["loss"] for r in res.rounds]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert np.mean(losses[-2:]) < np.mean(losses[:2]) - 0.1
    assert all(r["n_active"] == 2 for r in res.rounds)
    assert res.rounds[-1]["momentum_norm"] > 0.0


def test_run_is_deterministic_for_a_seed():
    cfg = reduced(get_config("mamba2-1.3b"))
    kw = dict(n_clients=3, cohort=2, local_steps=1, batch=2, seq=16, rounds=2, device="cpu")
    a = federated_llm.run(cfg, seed=3, **kw)
    b = federated_llm.run(cfg, seed=3, **kw)
    c = federated_llm.run(cfg, seed=4, **kw)
    assert a.rounds == b.rounds and a.rounds != c.rounds


def test_main_runs_the_example_on_cpu(capsys):
    assert federated_llm.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "federated llama3.2-1b-reduced" in out
    assert [line.split()[1] for line in out.splitlines()
            if line.startswith("round")] == ["5", "10", "15", "20"]
    assert "loss " in out.splitlines()[-1]


def test_main_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        federated_llm.main([])


def test_run_refuses_the_encoder_decoder():
    with pytest.raises(ValueError, match="decoder-only"):
        federated_llm.run(reduced(get_config("seamless-m4t-large-v2")), rounds=1, device="cpu")
