"""The port's fleet subsystem (``repro_torch.fleet``) and serving from
published params, against the reference's ``repro.fleet``.

* Telemetry: the port's rows carry exactly the reference's schema, and each
  package replays the other's stream; the reference's ``check`` passes on
  the telemetry of the port's ``fed_train --serve``.
* Publication: monotone versions, the retention ring, a reopened directory
  and a lagging reader; a directory either package publishes is read by the
  other.
* The fleet loop is observation-only: a ``--serve`` run's params are bitwise
  those of the same run without it.
* ``serve --ckpt`` serves what the reference publishes with the reference
  CLI's greedy tokens; ``--follow`` swaps a version published mid-session
  at a step boundary.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

from _torch_parity import np_params
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.core.engine import RoundMetrics as RefRoundMetrics
from repro.fleet import check as ref_check
from repro.fleet import telemetry as ref_telemetry
from repro.fleet.publisher import ModelPublisher as RefModelPublisher
from repro.fleet.publisher import load_published as ref_load_published
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro_torch.checkpoint import load_flat
from repro_torch.core.convert import params_from_numpy
from repro_torch.core.engine import RoundMetrics
from repro_torch.fleet import check as port_check
from repro_torch.fleet.driver import FleetDriver
from repro_torch.fleet.health import FleetStatus, HealthServer, probe
from repro_torch.fleet.publisher import ModelPublisher, ParamsWatch, load_published, read_pointer
from repro_torch.fleet.telemetry import (
    FAULT_COUNTERS,
    ROUND_FIELDS,
    TELEMETRY_SCHEMA,
    TelemetryStore,
    events,
    replay,
    round_rows,
)
from repro_torch.launch import fed_train, serve
from repro_torch.models.small import mlp_classifier

torch.set_num_threads(1)


def _mlp_params(seed=0):
    return params_from_numpy(np_params(seed))


# --------------------------------------------------------------- telemetry
def test_telemetry_schema_is_the_references():
    assert TELEMETRY_SCHEMA == ref_telemetry.TELEMETRY_SCHEMA
    assert ROUND_FIELDS == ref_telemetry.ROUND_FIELDS
    assert FAULT_COUNTERS == ref_telemetry.FAULT_COUNTERS
    # every counter a row carries is a RoundMetrics field, in both packages
    assert set(FAULT_COUNTERS) <= set(RoundMetrics._fields)
    assert set(FAULT_COUNTERS) <= set(RefRoundMetrics._fields)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_telemetry_round_trip_across_packages(writer, tmp_path):
    path = tmp_path / "t.jsonl"
    store_cls = TelemetryStore if writer == "port" else ref_telemetry.TelemetryStore
    with store_cls(path, meta={"algo": "fedcm"}) as ts:
        for i in range(4):
            ts.round_row(round=i + 1, rounds_per_s=2.5, cohort=8, loss=0.5 - 0.1 * i,
                         n_dropped=i)
        ts.event("publish", version=1, step=2)
    for read in (replay, ref_telemetry.replay):
        header, rows, truncated = read(path)
        assert header["schema"] == TELEMETRY_SCHEMA and header["meta"]["algo"] == "fedcm"
        assert not truncated
        rnds = round_rows(rows)
        assert [r["round"] for r in rnds] == [1, 2, 3, 4]
        assert all(list(r) == list(ROUND_FIELDS) for r in rnds)
        assert rnds[2]["n_dropped"] == 2 and events(rows, "publish")[0]["version"] == 1


def test_telemetry_refuses_unknown_fields_and_bad_streams(tmp_path):
    with TelemetryStore(tmp_path / "t.jsonl") as ts:
        with pytest.raises(ValueError, match="unknown round-row"):
            ts.round_row(round=1, not_a_field=3)
    p = tmp_path / "torn.jsonl"
    with TelemetryStore(p) as ts:
        ts.round_row(round=1, rounds_per_s=1.0)
    with open(p, "ab") as f:  # a kill mid-append
        f.write(b'{"event": "round", "rou')
    _, rows, truncated = replay(p)
    assert truncated and len(round_rows(rows)) == 1
    with open(p, "ab") as f:  # a torn line that is no longer the last
        f.write(b'\n{"event": "publish"}\n')
    with pytest.raises(ValueError, match="corrupt"):
        replay(p)
    q = tmp_path / "schema.jsonl"
    q.write_text(json.dumps({"schema": 99, "kind": "fleet-telemetry"}) + "\n")
    with pytest.raises(ValueError, match="schema"):
        replay(q)


def test_telemetry_resume_appends_after_existing_rows(tmp_path):
    p = tmp_path / "t.jsonl"
    with TelemetryStore(p, meta={"run": 1}) as ts:
        ts.round_row(round=1, rounds_per_s=1.0)
    with TelemetryStore(p, resume=True) as ts:
        ts.round_row(round=2, rounds_per_s=1.0)
        assert [r["round"] for r in ts.tail(5)] == [2]
    header, rows, _ = replay(p)
    assert header["meta"] == {"run": 1}
    assert [r["round"] for r in round_rows(rows)] == [1, 2]


# --------------------------------------------------------------- publisher
def test_publisher_versions_retention_and_reopen(tmp_path):
    d = str(tmp_path)
    with pytest.raises(ValueError, match="retain"):
        ModelPublisher(d, retain=1)
    pub = ModelPublisher(d, retain=2)
    params = _mlp_params()
    assert [pub.publish(params, step=s) for s in (0, 5, 10)] == [1, 2, 3]
    ptr = read_pointer(d)
    assert ptr["version"] == 3 and ptr["file"] == "step_3.msgpack" and ptr["step"] == 10
    assert sorted(p.name for p in tmp_path.glob("step_*.msgpack")) == [
        "step_2.msgpack", "step_3.msgpack"]
    assert ModelPublisher(d, retain=2).publish(params, step=15) == 4  # continues
    version, got, meta = load_published(d, template=params)
    assert version == 4 and meta["step"] == 15 and meta["version"] == 4
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(got, params))


def test_watch_polls_none_until_a_publish_and_outlives_retention(tmp_path):
    d = str(tmp_path)
    pub = ModelPublisher(d, retain=2)
    params = _mlp_params()
    watch = ParamsWatch(d, template=params)
    assert watch.poll() is None
    pub.publish(params, step=0)
    assert watch.poll()[0] == 1 and watch.poll() is None
    # a reader lagging by more than ``retain`` versions reads the newest
    for s in range(1, 5):
        pub.publish([{k: v + s for k, v in layer.items()} for layer in params], step=s)
    version, got, meta = watch.poll()
    assert version == 5 and meta["step"] == 4
    assert torch.equal(got[0]["b"], params[0]["b"] + 4)


def test_publisher_directories_are_read_across_packages(tmp_path):
    tree = np_params(2)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    RefModelPublisher(ref_dir).publish(jax.tree_util.tree_map(jax.numpy.asarray, tree), step=7)
    template = _mlp_params()
    version, got, meta = load_published(ref_dir, template)
    assert version == 1 and meta["step"] == 7
    for a, b in zip(got, tree):
        np.testing.assert_array_equal(a["w"].numpy(), b["w"])
    raw = load_published(ref_dir)[1]
    assert sorted(raw) == ["0/b", "0/w", "1/b", "1/w", "2/b", "2/w"]
    assert ParamsWatch(ref_dir, template).poll()[0] == 1

    ModelPublisher(port_dir).publish(params_from_numpy(tree), step=9)
    ModelPublisher(port_dir).publish(params_from_numpy(np_params(3)), step=11)
    rversion, rgot, rmeta = ref_load_published(
        port_dir, jax.tree_util.tree_map(jax.numpy.asarray, tree))
    assert rversion == 2 and rmeta["step"] == 11
    for a, b in zip(rgot, np_params(3)):
        np.testing.assert_array_equal(np.asarray(a["w"]), b["w"])


# ------------------------------------------------------------------ health
def test_healthz_fresh_stale_metrics_tail_and_404(tmp_path):
    status = FleetStatus(deadline_s=30.0)
    with TelemetryStore(tmp_path / "t.jsonl") as ts:
        for i in range(5):
            ts.round_row(round=i + 1, rounds_per_s=4.0)
        server = HealthServer(status, ts.tail)
        try:
            code, body = probe(server.url)
            assert code == 503 and body["status"] == "stale"  # no round yet
            status.round_done(5, rounds_per_s=4.0, cohort=6)
            status.bump_counters({"n_dropped": 3, "quorum_skipped": 1})
            code, body = probe(server.url)
            assert code == 200 and body["last_round"] == 5 and body["last_round_age_s"] < 30
            with urllib.request.urlopen(server.url + "/metrics") as r:
                text = r.read().decode()
            assert "fleet_n_dropped_total 3.0" in text
            assert "fleet_rounds_per_second 4.0" in text
            with urllib.request.urlopen(server.url + "/telemetry/tail?n=2") as r:
                assert [t["round"] for t in json.loads(r.read())] == [4, 5]
            assert probe(server.url, "/nope")[0] == 404
            status.update(last_round_unix=time.time() - 31.0)  # past the deadline
            assert probe(server.url)[0] == 503
        finally:
            server.stop()


# ------------------------------------------------------------------ driver
def test_driver_serves_publishes_and_records(tmp_path):
    model = mlp_classifier((8, 16, 16, 4))
    params = _mlp_params()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32))
    fleet = FleetDriver(ckpt_dir=str(tmp_path), deadline_s=60.0, meta={"algo": "test"})
    assert fleet.publish(0, params) == 1
    fleet.start_serving(model.apply, template=params, batch_x=x, steps_per_session=64)
    for step in (2, 4):  # two versions while the serving thread runs
        time.sleep(0.15)
        fleet.publish(step, [{k: v + 0.1 for k, v in layer.items()} for layer in params])
    host = {"loss": np.asarray([0.5, 0.4]), "n_active": np.asarray([4, 5]),
            "n_dropped": np.asarray([1.0, 0.0]), "bytes_up": np.asarray([848.0, 848.0])}
    fleet.record_chunk(start_round=0, host=host, seconds=0.5, eval_acc=0.75,
                       published_version=3)
    assert fleet.drain_swaps(timeout_s=20.0)
    summary = fleet.stop()
    assert summary["swaps"] >= 2 and summary["served_version"] == 3
    assert summary["health_status"] == 200
    _, rows, truncated = replay(fleet.telemetry.path)
    assert not truncated
    rnds = round_rows(rows)
    assert [r["round"] for r in rnds] == [1, 2] and rnds[1]["published_version"] == 3
    assert rnds[1]["eval_acc"] == 0.75 and rnds[0]["n_dropped"] == 1.0
    assert [e["version"] for e in events(rows, "publish")] == [1, 2, 3]
    for chk in (port_check.check, ref_check.check):
        assert chk(fleet.telemetry.path, min_rounds=2, min_swaps=1, require_health=True) == []


def test_check_fails_loudly(tmp_path):
    with TelemetryStore(tmp_path / "t.jsonl") as ts:
        ts.round_row(round=1, rounds_per_s=1.0)
    fails = port_check.check(str(tmp_path / "t.jsonl"), min_rounds=3, min_swaps=2,
                             require_health=True)
    assert len(fails) == 4
    assert port_check.main([str(tmp_path / "t.jsonl"), "--min-rounds", "3"]) == 1


# -------------------------------------------------------------- fleet loop
FLEET_ARGV = ["--clients", "12", "--cohort", "4", "--rounds", "4", "--eval-every", "2",
              "--local-steps", "2", "--seed", "3", "--participation", "fixed",
              "--ckpt-every", "2", "--device", "cpu"]


def test_serve_run_is_bitwise_the_plain_run(tmp_path, capsys):
    """``fed_train --serve`` against the same run without it: the final
    snapshots equal plane for plane, the generator included; publications
    v1 (the params entering the run) + one a snapshot; the in-run health
    probe 200; both packages' checkers pass on the port's telemetry."""
    assert fed_train.main(FLEET_ARGV + ["--ckpt-dir", str(tmp_path / "plain")]) == 0
    assert fed_train.main(FLEET_ARGV + ["--ckpt-dir", str(tmp_path / "fleet"), "--serve",
                                        "--round-deadline", "60"]) == 0
    out = capsys.readouterr().out
    assert "fleet: serving + health at http://127.0.0.1:" in out and "health=200" in out
    plain, _ = load_flat(str(tmp_path / "plain"), 4)
    fleet, _ = load_flat(str(tmp_path / "fleet"), 4)
    assert plain.keys() == fleet.keys()
    for k in plain:
        assert torch.equal(plain[k], fleet[k]), k
    path = str(tmp_path / "fleet" / "telemetry.jsonl")
    header, rows, truncated = replay(path)
    assert not truncated and header["meta"]["algo"] == "fedcm"
    rnds = round_rows(rows)
    assert [r["round"] for r in rnds] == [1, 2, 3, 4]
    assert rnds[1]["published_version"] == 2 and rnds[3]["eval_acc"] is not None
    assert [e["version"] for e in events(rows, "publish")] == [1, 2, 3]
    assert events(rows, "serve_summary")[-1]["served_version"] == 3
    assert events(rows, "health_probe")[-1]["status"] == 200
    assert ref_check.check(path, min_rounds=4, require_health=True) == []
    assert port_check.check(path, min_rounds=4, require_health=True) == []


# ------------------------------------------------- serving published params
SMALL = ["--batch", "2", "--prompt-len", "12", "--gen", "8", "--seed", "3"]


def _samples(text):
    lines = text.splitlines()
    i = lines.index("sample generations (first 16 tokens):")
    return [line.strip() for line in lines[i + 1:] if line.strip().startswith("[")]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_serve_ckpt_serves_what_the_reference_publishes(arch, tmp_path, capsys):
    d = str(tmp_path)
    rparams = ref_build_model(ref_reduced(ref_get_config(arch))).init(jax.random.PRNGKey(7))
    RefModelPublisher(d).publish(rparams, step=12)
    assert ref_serve.main(["--arch", arch, *SMALL, "--ckpt", d]) == 0
    expected = _samples(capsys.readouterr().out)
    assert serve.main(["--arch", arch, *SMALL, "--ckpt", d, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"serving published params: version 1 from {d}" in out
    assert _samples(out) == expected and len(expected) == 2
    # the payload file itself
    assert serve.main(["--arch", arch, *SMALL, "--ckpt", f"{d}/step_1.msgpack",
                       "--device", "cpu"]) == 0
    assert _samples(capsys.readouterr().out) == expected


def test_serve_follow_swaps_a_version_published_mid_session(tmp_path):
    d = str(tmp_path)
    args = serve.build_parser().parse_args(["--arch", "llama3.2-1b", *SMALL, "--ckpt", d,
                                            "--follow", "--sessions", "3", "--device", "cpu"])
    model = serve.build_model(serve.reduced(serve.get_config(args.arch)))
    params = model.init(torch.Generator().manual_seed(5))
    pub = ModelPublisher(d)
    pub.publish(params, step=0)
    published = threading.Event()

    def publish_v2():
        pub.publish(serve.tree_map(lambda a: 0.5 * a, params), step=1)
        published.set()

    def on_step(stats):  # mid-session 0, from another thread
        if stats.steps == 2:
            t = threading.Thread(target=publish_v2)
            t.start()
            t.join(timeout=60)
            assert published.is_set()

    res = serve.run(args, on_step=on_step)
    assert res.stats.swaps == 1 and res.stats.swaps_mid_session == 1
    assert res.stats.versions == [2] and res.stats.served_version == 2
    assert res.stats.swap_steps == [2]  # the step boundary after the publish
    fresh = serve.run(serve.build_parser().parse_args(
        ["--arch", "llama3.2-1b", *SMALL, "--ckpt", f"{d}/step_2.msgpack", "--device", "cpu"]))
    np.testing.assert_array_equal(res.tokens, fresh.tokens)


def test_serve_refuses_a_federated_mlp_directory_and_follow_without_ckpt(tmp_path):
    ModelPublisher(str(tmp_path)).publish(_mlp_params(), step=4)
    with pytest.raises(SystemExit, match="do not match this serving model's template"):
        serve.main(["--arch", "llama3.2-1b", *SMALL, "--ckpt", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        serve.main([*SMALL, "--follow", "--device", "cpu"])
    assert e.value.code == 2
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="nothing published"):
        serve.main([*SMALL, "--ckpt", str(tmp_path / "empty"), "--device", "cpu"])
