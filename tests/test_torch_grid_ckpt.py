"""Snapshots and published params under a model group or a grid.

``train --ckpt-dir`` on a group writes the file an unsharded run writes
(``checkpoint.ckpt.save_checkpoint_shares``: rank 0 joins each leaf's
shares), so (a) a 2 × 2 grid's step-2 snapshot resumes unsharded, on 1 × 2
and on 4 × 1, and each resumed run's last losses and step-4 snapshot are
within tolerance of the straight 2 × 2 run's (``LM_RTOL`` / ``LM_ATOL``
for the losses, ``GROUP_REL_L2`` relative L2 for each leaf: another grid
sums the gradients in another order); (b) a 2 × 2 run stopped after its
step-2 snapshot and resumed on 2 × 2 writes a step-4 snapshot byte for
byte the straight run's; (c) the reference's ``load_checkpoint`` reads the
grid's file, and its values are the shares joined.

``serve --ckpt`` on a model group of 2 gloo ranks: each rank keeps its
share of the published version, and the greedy tokens are the unsharded
server's; with ``--follow`` rank 0 reads the pointer and every rank loads
the version it broadcasts (``fleet.publisher.GroupParamsWatch``): a
version published after decode step 3 is swapped in at the same step on
both ranks, with the unsharded server's tokens; and when retention unlinks
the version rank 0 read before the ranks open it, both retry together on
the newer version (the ranks' bodies in tests/_torch_grid_ranks.py).
"""
import numpy as np
import pytest
import torch

import jax

import _torch_grid_ranks as ranks_mod
from _torch_parity import LM_ATOL, LM_RTOL, assert_close
from test_torch_train_group import GROUP_REL_L2, rel_l2
from repro.checkpoint import load_checkpoint as ref_load_checkpoint
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import reduced as ref_reduced
from repro.models import build_model as ref_build_model
from repro.optim.optimizers import adamw as ref_adamw
from repro_torch.checkpoint.ckpt import load_checkpoint, load_flat, save_checkpoint
from repro_torch.configs.base import get_config, reduced
from repro_torch.core.convert import to_numpy
from repro_torch.fleet.publisher import ModelPublisher
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import spawn_cohort
from repro_torch.models.model import build_model
from repro_torch.sharding.shard import grid_take, snapshot_take
from repro_torch.utils.trees import tree_map

torch.set_num_threads(1)

COMMON = ["--arch", "llama3.2-1b", "--device", "cpu", "--batch", "4", "--seq", "16",
          "--log-every", "1", "--warmup", "2", "--seed", "3", "--ckpt-every", "2"]
SHAPES = {"1x1": [], "1x2": ["--model-parallel", "2"], "4x1": ["--data-parallel", "4"]}
GRID = ["--data-parallel", "2", "--model-parallel", "2"]


def _train(ckpt_dir, steps, shape):
    args = train.build_parser().parse_args([*COMMON, "--steps", str(steps), "--ckpt-dir",
                                            str(ckpt_dir), *shape])
    return train.run(args, echo=False)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """A straight 4-step 2 × 2 run, snapshotting steps 2 and 4."""
    d = tmp_path_factory.mktemp("straight")
    return d, _train(d, 4, GRID)


def _resumed_from_step_2(straight_dir, tmp_path, shape):
    d = tmp_path / "resumed"
    d.mkdir()
    (d / "step_2.msgpack").write_bytes((straight_dir / "step_2.msgpack").read_bytes())
    return d, _train(d, 4, shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_a_grids_snapshot_resumes_on_another_shape(shape, straight, tmp_path):
    sdir, sres = straight
    d, res = _resumed_from_step_2(sdir, tmp_path, SHAPES[shape])
    assert res.start_step == 2
    for a, b in zip(res.losses + res.grad_norms, sres.losses[2:] + sres.grad_norms[2:]):
        assert_close(a, b, rtol=LM_RTOL, atol=LM_ATOL)
    got, _ = load_flat(str(d), 4)
    want, _ = load_flat(str(sdir), 4)
    assert sorted(got) == sorted(want)
    for path in want:
        if want[path].dtype.is_floating_point:
            assert rel_l2(got[path].numpy(), want[path].numpy()) <= GROUP_REL_L2, path
        else:
            assert torch.equal(got[path], want[path]), path


def test_a_stopped_grid_run_resumes_bitwise_on_its_shape(straight, tmp_path):
    sdir, _ = straight
    stopped = tmp_path / "stopped"
    res = _train(stopped, 2, GRID)
    assert res.start_step == 0
    assert (stopped / "step_2.msgpack").read_bytes() == (sdir / "step_2.msgpack").read_bytes()
    res = _train(stopped, 4, GRID)
    assert res.start_step == 2
    assert (stopped / "step_4.msgpack").read_bytes() == (sdir / "step_4.msgpack").read_bytes()


def test_the_references_load_checkpoint_reads_the_grids_file(straight):
    """The reference restores ``{"params", "opt"}`` (its model's tree and its
    AdamW's state) from the grid's file; each of its leaves equals the
    port's: the leaf the grid's ranks joined."""
    sdir, _ = straight
    rcfg = ref_reduced(ref_get_config("llama3.2-1b"))
    params = jax.eval_shape(lambda: ref_build_model(rcfg).init(jax.random.PRNGKey(0)))
    like = {"params": params, "opt": jax.eval_shape(ref_adamw(1e-3).init, params)}
    tree, meta = ref_load_checkpoint(str(sdir), 4, like)
    assert meta["step"] == 4
    flat, _ = load_flat(str(sdir), 4)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in path)
        np.testing.assert_array_equal(np.asarray(leaf), flat[key].numpy(), err_msg=key)
    # and a rank's share of it is that rank's slice of the joined leaf
    cfg = reduced(get_config("llama3.2-1b"))
    take = snapshot_take(cfg, 1, 2, 1, 2)
    w = flat["params/periods/slot0/attn/wq"]
    assert torch.equal(take("params/periods/slot0/attn/wq", w),
                       grid_take(w, ("periods", "slot0", "attn", "wq"), cfg, 1, 2, 1, 2))


def test_a_snapshot_gathered_in_blocks_is_the_unsharded_file(tmp_path):
    """Rank 0 gathers each leaf's shares in blocks of ``SHARE_CHUNK``
    elements; with blocks smaller than a share (and a share that is no
    multiple of one, a bf16 leaf, an integer scalar) the file is byte for
    byte the whole tree's."""
    gen = torch.Generator().manual_seed(5)
    whole = {"w": torch.randn(9, 5, generator=gen),
             "h": torch.randn(6, 7, generator=gen).to(torch.bfloat16),
             "step": torch.tensor(4, dtype=torch.int64)}
    shares = [{"w": whole["w"][3 * r:3 * r + 3], "h": whole["h"][2 * r:2 * r + 2],
               "step": whole["step"]} for r in range(3)]
    names = spawn_cohort(ranks_mod.snapshot_world, 3, args=(4, str(tmp_path / "g"), shares),
                         device="cpu", timeout_s=60.0, deadline_s=120.0)
    assert names[1:] == [None, None]
    want = save_checkpoint(str(tmp_path / "w"), 1, whole)
    assert (tmp_path / "g" / "step_1.msgpack").read_bytes() == open(want, "rb").read()


# ------------------------------------------------------------ serving a group
SERVE = ["--device", "cpu", "--batch", "2", "--prompt-len", "12", "--gen", "8", "--seed", "3"]


def _weights(cfg, seed):
    return tree_map(to_numpy, build_model(cfg).init(torch.Generator().manual_seed(seed)))


def _jobs(root):
    """Three cases, each with its own directory holding version 1: serve
    the file ``step_1.msgpack``; follow the directory while version 2 is
    published after decode step 3; the same with versions 2-4, rank 0
    reading the pointer at 2 before 3 and 4 unlink it."""
    cfg = reduced(get_config("llama3.2-1b"))
    v = [_weights(cfg, s) for s in (11, 12, 13, 14)]
    jobs = []
    for name, extra in (("file", {}), ("follow", {"later": v[1:2], "publish_after": 3}),
                        ("race", {"later": v[1:], "publish_after": 3, "race": True})):
        d = root / name
        ModelPublisher(str(d), retain=2).publish(ranks_mod.grid_share(cfg, v[0], None), step=1)
        ckpt = str(d / "step_1.msgpack") if name == "file" else str(d)
        argv = [*SERVE, "--ckpt", ckpt, *([] if name == "file" else ["--follow"])]
        jobs.append({"argv": argv, "dir": str(d), **extra})
    return jobs


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each case on a model group of 2 gloo ranks, and unsharded."""
    group = spawn_cohort(ranks_mod.serve_world, 2, args=(_jobs(tmp_path_factory.mktemp("g")),),
                         device="cpu", timeout_s=120.0, deadline_s=600.0)
    plain = [ranks_mod.serve_case(job) for job in _jobs(tmp_path_factory.mktemp("p"))]
    return group, plain


@pytest.mark.parametrize("case,swaps,versions", [(0, [], []), (1, [3], [2]), (2, [3], [4])],
                         ids=["file", "follow", "retention-race"])
def test_serving_published_params_on_a_group_gives_the_unsharded_tokens(case, swaps, versions,
                                                                        served):
    """Both ranks' tokens are the unsharded server's, and both swap the
    params at the step the unsharded server does (after decode step 3),
    to the same version: in the race the one rank 0 read was unlinked, and
    both took the newer one together."""
    group, plain = served
    want = plain[case]
    assert (want["swap_steps"], want["versions"]) == (swaps, versions)
    for r, got in enumerate(r[case] for r in group):
        np.testing.assert_array_equal(got["tokens"], want["tokens"], err_msg=f"rank {r}")
        assert (got["swap_steps"], got["versions"]) == (swaps, versions), r


def test_published_params_of_a_snapshot_serve_from_the_trained_grid(straight, tmp_path):
    """A grid's train snapshot's params, published, are served by a model
    group of 2 as by one rank (the CLI's route: each rank parses the
    command line)."""
    sdir, _ = straight
    cfg = reduced(get_config("llama3.2-1b"))
    tree, _ = load_checkpoint(str(sdir), 4, {"params": build_model(cfg).init(torch.Generator())})
    pub = tmp_path / "pub"
    ModelPublisher(str(pub), retain=2).publish(tree["params"], step=4)
    argv = [*SERVE, "--ckpt", str(pub)]
    one = serve.run(serve.build_parser().parse_args(argv))
    argv += ["--model-parallel", "2"]
    for res in serve.run_model_parallel(serve.build_parser().parse_args(argv), argv):
        np.testing.assert_array_equal(res.tokens, one.tokens)
