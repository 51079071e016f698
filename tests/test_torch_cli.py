"""The port's CLI: ``python -m repro_torch.launch.fed_train``.

It runs on ``cuda`` unless ``--device cpu`` asks for the CPU, and raises on
a machine with no GPU instead of carrying on on the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import load_flat
from repro_torch.configs.base import CompressionConfig, FaultConfig, FedConfig
from repro_torch.core.registry import list_algorithms
from repro_torch.fleet.telemetry import events, replay
from repro_torch.launch import fed_train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--clients", "8", "--cohort", "3", "--rounds", "4", "--eval-every", "2",
         "--local-steps", "2", "--seed", "1"]


def test_cli_on_cpu_prints_round_log_lines(capsys):
    assert fed_train.main(SMALL + ["--device", "cpu"]) == 0
    err = capsys.readouterr()
    lines = [l for l in err.err.splitlines() if "round=" in l]
    assert len(lines) == 2
    for key in ("round=", "algo=fedcm", "loss=", "test_acc=", "n_active=", "mb_down=", "mb_up="):
        assert all(key in l for l in lines), key
    assert "final test accuracy" in err.out


def test_cli_without_device_raises_when_there_is_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fed_train.main(SMALL)


def test_cli_module_entry_point_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fed_train", *SMALL,
         "--algo", "fedavg", "--participation", "fixed", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "algo=fedavg" in out.stderr and "round=4" in out.stderr


def test_resolve_config_wires_every_flag():
    args = fed_train.build_parser().parse_args(
        ["--algo", "fedavg", "--clients", "50", "--cohort", "5", "--rounds", "7",
         "--local-steps", "3", "--alpha", "0.2", "--eta-l", "0.05", "--eta-g", "0.9",
         "--participation", "fixed", "--seed", "4"])
    assert fed_train.resolve_config(args) == FedConfig(
        algo="fedavg", num_clients=50, cohort_size=5, rounds=7, local_steps=3,
        alpha=0.2, eta_l=0.05, eta_g=0.9, participation="fixed", seed=4)


def test_cli_defaults_are_the_scaled_paper_setting():
    args = fed_train.build_parser().parse_args([])
    cfg = fed_train.resolve_config(args)
    assert (cfg.num_clients, cfg.cohort_size, cfg.local_steps, cfg.alpha, cfg.eta_l,
            cfg.participation) == (100, 10, 10, 0.1, 0.1, "bernoulli")
    assert args.device == "cuda" and args.dirichlet == 0.6


def test_cli_refuses_unported_algorithm():
    """Every registered algorithm is a choice; a name outside the registry
    is refused."""
    with pytest.raises(SystemExit):
        fed_train.build_parser().parse_args(["--algo", "fednova"])
    for algo in list_algorithms():
        assert fed_train.build_parser().parse_args(["--algo", algo]).algo == algo


def test_cli_scaffold_on_cpu_charges_two_wire_planes(capsys):
    """``--algo scaffold``: the client-state plane rides the round, Δc_i goes
    up beside Δ_i (2 × 4P bytes per active client) and c comes down beside
    x_t (2 × 4P)."""
    assert fed_train.main(SMALL + ["--algo", "scaffold", "--device", "cpu"]) == 0
    err = capsys.readouterr()
    lines = [l for l in err.err.splitlines() if "round=" in l]
    assert len(lines) == 2
    for line in lines:
        kv = dict(tok.split("=") for tok in line.split() if "=" in tok)
        assert kv["algo"] == "scaffold"
        n_active = int(kv["n_active"])
        assert float(kv["mb_up"]) == round(n_active * 2 * 4 * 22026 / 2 ** 20, 2)
        assert float(kv["mb_down"]) == round(n_active * 2 * 4 * 22026 / 2 ** 20, 2)
        assert float(kv["loss"]) == float(kv["loss"])  # finite, not NaN
    assert "scaffold: final test accuracy" in err.out


@pytest.mark.parametrize("compress", [None, "int8"])
def test_cli_list_algos_prints_the_reference_table(capsys, compress):
    """``--list-algos`` prints one routing row per registered algorithm and
    exits without running a round; the table is the reference CLI's, row
    for row, under the same ``--uplink-compress``."""
    from repro.configs.base import CompressionConfig as RefCompressionConfig
    from repro.launch.fed_train import list_algos_text as ref_list_algos_text

    argv = ["--list-algos"] + ([] if compress is None else ["--uplink-compress", compress])
    assert fed_train.main(argv) == 0
    out = capsys.readouterr()
    assert "round=" not in out.err
    comp = None if compress is None else RefCompressionConfig(kind=compress, seed=0)
    assert out.out.rstrip("\n") == ref_list_algos_text(compression=comp)
    assert len(out.out.splitlines()) == 1 + len(list_algorithms()) + 1


def test_cli_int8_uplink_on_cpu_logs_int8_wire_bytes(capsys):
    """``--uplink-compress int8`` runs and charges P + 4 bytes per active
    client (the MLP 32-128-128-10 plane has P = 22,026)."""
    assert fed_train.main(SMALL + ["--uplink-compress", "int8", "--fault-drop-rate", "0.2",
                                   "--fault-corrupt-rate", "0.2", "--device", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().err.splitlines() if "round=" in l]
    assert len(lines) == 2
    for line in lines:
        kv = dict(tok.split("=") for tok in line.split() if "=" in tok)
        n_active = int(kv["n_active"])
        assert float(kv["mb_up"]) == round(n_active * (22026 + 4) / 2 ** 20, 2)
        assert float(kv["loss"]) == float(kv["loss"])  # finite, not NaN


@pytest.mark.parametrize("frac", ["0", "1.5"])
def test_cli_refuses_a_bad_topk_frac(frac):
    args = fed_train.build_parser().parse_args(["--uplink-compress", "topk", "--topk-frac", frac])
    with pytest.raises(ValueError, match="topk_frac"):
        fed_train.resolve_config(args)


def test_resolve_config_wires_fault_and_compression_flags():
    args = fed_train.build_parser().parse_args(
        ["--uplink-compress", "topk", "--topk-frac", "0.05", "--seed", "3",
         "--fault-drop-rate", "0.1", "--fault-corrupt-rate", "0.2",
         "--fault-corrupt-mode", "noise", "--fault-noise-scale", "4", "--fault-deadline", "2",
         "--fault-seed", "7", "--quarantine-norm-mult", "3", "--min-quorum", "2"])
    cfg = fed_train.resolve_config(args)
    assert cfg.compression == CompressionConfig(kind="topk", topk_frac=0.05, seed=3)
    assert cfg.fault == FaultConfig(drop_rate=0.1, corrupt_rate=0.2, corrupt_mode="noise",
                                    noise_scale=4.0, deadline=2.0, seed=7,
                                    quarantine_norm_mult=3.0)
    assert cfg.min_quorum == 2
    plain = fed_train.resolve_config(fed_train.build_parser().parse_args([]))
    assert plain.fault is None and plain.compression is None
    # the host store's failure model is a flag too (ported with the store)
    store = fed_train.resolve_config(fed_train.build_parser().parse_args(
        ["--fault-store-failure-rate", "0.1"]))
    assert store.fault == FaultConfig(store_failure_rate=0.1)


def test_quorum_and_empty_cohort_flags_wire_through():
    """As the reference CLI's ``tests/test_fed_train_cli.py`` case."""
    def resolved(argv):
        return fed_train.resolve_config(fed_train.build_parser().parse_args(argv))

    assert resolved([]).min_quorum == 0
    assert resolved([]).allow_empty_cohort is False
    cfg = resolved(["--min-quorum", "3", "--allow-empty-cohort"])
    assert cfg.min_quorum == 3 and cfg.allow_empty_cohort is True


def test_resolve_config_wires_async_and_store_flags():
    args = fed_train.build_parser().parse_args(
        ["--pipeline-depth", "3", "--staleness", "2", "--staleness-discount", "0.9",
         "--population-store", "host", "--availability", "zipf", "--zipf-exponent", "1.5",
         "--dropout-rate", "0.1", "--async"])
    cfg = fed_train.resolve_config(args)
    assert (cfg.pipeline_depth, cfg.staleness, cfg.staleness_discount) == (3, 2, 0.9)
    assert (cfg.population_store, cfg.availability, cfg.zipf_exponent,
            cfg.dropout_rate) == ("host", "zipf", 1.5, 0.1)
    assert args.async_pipeline
    for bad in (["--population-store", "disk"], ["--availability", "lunar"]):
        with pytest.raises(SystemExit):
            fed_train.build_parser().parse_args(bad)


def _round_lines(err):
    lines = [l for l in err.splitlines() if "round=" in l]
    rows = [dict(tok.split("=") for tok in l.split() if "=" in tok) for l in lines]
    for kv in rows:
        assert float(kv["loss"]) == float(kv["loss"]) and abs(float(kv["loss"])) < 1e6
        assert "retries" in kv  # the host store's retries column
    return rows


@pytest.mark.parametrize("argv, n_lines", [
    (["--pipeline-depth", "2", "--staleness", "1", "--staleness-discount", "0.9"], 2),
    (["--population-store", "host", "--clients", "100000", "--algo", "scaffold"], 2),
    (["--availability", "zipf", "--dropout-rate", "0.1"], 2),
    (["--population-store", "host", "--clients", "100000", "--algo", "scaffold",
      "--pipeline-depth", "2", "--staleness", "1", "--uplink-compress", "topk"], 1),
], ids=["async", "host-store", "zipf-dropout", "host-store-async"])
def test_cli_async_and_store_on_cpu(capsys, argv, n_lines):
    assert fed_train.main(SMALL + argv + ["--device", "cpu"]) == 0
    err = capsys.readouterr()
    rows = _round_lines(err.err)
    assert len(rows) == n_lines  # the host-store ring evaluates once, at the end
    assert rows[-1]["round"] == "4"
    assert "final test accuracy" in err.out


# ----------------------------------------------------- snapshots and fleet
@pytest.mark.parametrize("argv", [
    ["--ckpt-every", "5"],  # no --ckpt-dir
    ["--ckpt-every", "5", "--ckpt-dir", "/tmp/x", "--async"],
    ["--ckpt-every", "5", "--ckpt-dir", "/tmp/x", "--pipeline-depth", "2"],
    ["--ckpt-every", "5", "--ckpt-dir", "/tmp/x", "--staleness", "1"],
    ["--die-after", "5", "--ckpt-dir", "/tmp/x"],  # no --ckpt-every
    ["--resume", "--ckpt-dir", "/tmp/x"],  # no --ckpt-every
    ["--resume", "--ckpt-every", "5"],  # no --ckpt-dir
], ids=["no-dir", "async", "depth", "staleness", "die-no-every", "resume-no-every",
        "resume-no-dir"])
def test_cli_refuses_bad_snapshot_flags(argv):
    """The reference CLI's refusals, before anything runs (exit code 2)."""
    with pytest.raises(SystemExit) as e:
        fed_train.main(argv + ["--device", "cpu"])
    assert e.value.code == 2


@pytest.mark.parametrize("argv", [
    ["--serve"],  # no snapshot cadence to publish on
    ["--serve", "--ckpt-every", "2"],  # no dir
    ["--serve", "--ckpt-every", "2", "--ckpt-dir", "/tmp/x", "--publish-retain", "1"],
], ids=["no-every", "no-dir", "retain"])
def test_cli_refuses_bad_serve_flags(argv):
    with pytest.raises(SystemExit) as e:
        fed_train.main(argv + ["--device", "cpu"])
    assert e.value.code == 2


def test_cli_kill_and_resume_matches_the_straight_run_byte_for_byte(tmp_path):
    """``--die-after`` ends the process with exit code 75 right after its
    snapshot; ``--resume`` continues it; the resumed run's final snapshot
    is the straight run's, byte for byte (state, generator, store rows)."""
    argv = SMALL + ["--rounds", "4", "--ckpt-every", "2", "--algo", "scaffold",
                    "--population-store", "host", "--fault-drop-rate", "0.1",
                    "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.fed_train", *argv,
           "--ckpt-dir", str(tmp_path / "a")]
    died = subprocess.run(cmd + ["--die-after", "2"], capture_output=True, text=True, env=env,
                          timeout=120)
    assert died.returncode == 75, died.stderr
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["step_2.msgpack"]
    resumed = subprocess.run(cmd + ["--resume"], capture_output=True, text=True, env=env,
                             timeout=120)
    assert resumed.returncode == 0, resumed.stderr
    assert "round=4" in resumed.stderr and "round=2" not in resumed.stderr
    assert fed_train.main(argv + ["--ckpt-dir", str(tmp_path / "b")]) == 0
    for step in (2, 4):
        assert ((tmp_path / "a" / f"step_{step}.msgpack").read_bytes()
                == (tmp_path / "b" / f"step_{step}.msgpack").read_bytes())


def _log_lines(stderr: str):
    """The per-round log lines without their elapsed-time prefix."""
    return [l.split("] ", 1)[1] for l in stderr.splitlines() if "round=" in l]


def test_cli_cohort_shard_prints_the_unsharded_runs_lines():
    """``--cohort-shard 4 --device cpu`` spawns four gloo ranks; rank 0's
    log is the unsharded run's, line for line (sharded ≡ unsharded)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.fed_train", "--rounds", "6",
           "--eval-every", "3", "--device", "cpu"]
    plain = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=120)
    sharded = subprocess.run(cmd + ["--cohort-shard", "4"], capture_output=True, text=True,
                             env=env, timeout=120)
    assert plain.returncode == 0, plain.stderr
    assert sharded.returncode == 0, sharded.stderr
    assert len(_log_lines(plain.stderr)) == 2
    assert _log_lines(sharded.stderr) == _log_lines(plain.stderr)
    assert sharded.stdout.splitlines()[-1] == plain.stdout.splitlines()[-1]


def test_cli_sharded_kill_and_resume_matches_the_straight_run_byte_for_byte(tmp_path):
    """Under ``--cohort-shard 2`` rank 0 writes each snapshot and every rank
    passes a barrier; ``--die-after`` makes the launcher exit with 75, and
    ``--resume`` (the same file on every rank) ends on the straight
    unsharded run's round-6 snapshot, byte for byte."""
    argv = SMALL + ["--rounds", "6", "--eval-every", "3", "--ckpt-every", "3", "--algo",
                    "scaffold", "--fault-drop-rate", "0.1", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.fed_train", *argv, "--cohort-shard", "2",
           "--ckpt-dir", str(tmp_path / "a")]
    died = subprocess.run(cmd + ["--die-after", "3"], capture_output=True, text=True, env=env,
                          timeout=120)
    assert died.returncode == 75, died.stderr
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["step_3.msgpack"]
    resumed = subprocess.run(cmd + ["--resume"], capture_output=True, text=True, env=env,
                             timeout=120)
    assert resumed.returncode == 0, resumed.stderr
    assert _log_lines(resumed.stderr)[0].startswith("round=6")
    assert fed_train.main(argv + ["--ckpt-dir", str(tmp_path / "b")]) == 0
    for step in (3, 6):
        assert ((tmp_path / "a" / f"step_{step}.msgpack").read_bytes()
                == (tmp_path / "b" / f"step_{step}.msgpack").read_bytes())


@pytest.mark.parametrize("argv", [
    ["--cohort-shard", "-1"],
    ["--cohort-shard", "2", "--population-store", "host"],
], ids=["negative", "host-store"])
def test_cli_refuses_bad_cohort_shard_flags(argv):
    with pytest.raises(SystemExit) as e:
        fed_train.main(argv + ["--device", "cpu"])
    assert e.value.code == 2


def test_cli_cohort_shard_wires_the_config_and_defers_serve(tmp_path):
    """``--cohort-shard`` sets the config, and ``--serve`` under
    ``--cohort-shard 2`` (two gloo ranks) runs the fleet loop on rank 0:
    its snapshots are bitwise those of the same sharded run without
    ``--serve``, v1 (the params entering the run) and one version a snapshot
    are published, and the serving thread ends on the last one."""
    args = fed_train.build_parser().parse_args(["--cohort-shard", "4"])
    assert fed_train.resolve_config(args).cohort_shard == 4
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.fed_train", *SMALL, "--ckpt-every", "2",
           "--cohort-shard", "2", "--device", "cpu"]
    runs = {name: subprocess.Popen(cmd + ["--ckpt-dir", str(tmp_path / name)] + extra,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                   env=env)
            for name, extra in (("plain", []), ("serve", ["--serve"]))}
    out = {name: p.communicate(timeout=120) for name, p in runs.items()}
    for name, p in runs.items():
        assert p.returncode == 0, out[name][1]
    assert "fleet: serving + health at" in out["serve"][0]
    assert _log_lines(out["serve"][1]) == _log_lines(out["plain"][1])
    for step in (2, 4):
        plain, _ = load_flat(str(tmp_path / "plain"), step)
        served, _ = load_flat(str(tmp_path / "serve"), step)
        assert plain.keys() == served.keys()
        for k in plain:
            assert torch.equal(plain[k], served[k]), (step, k)
    _, rows, _ = replay(str(tmp_path / "serve" / "telemetry.jsonl"))
    assert [e["version"] for e in events(rows, "publish")] == [1, 2, 3]
    assert events(rows, "serve_summary")[-1]["served_version"] == 3
    assert not (tmp_path / "plain" / "telemetry.jsonl").exists()
