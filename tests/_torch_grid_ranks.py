"""Rank bodies of the grid tests (tests/test_torch_grid_train.py,
test_torch_grid_ckpt.py and test_torch_fed_lm_grid.py).

Spawned ranks import this module by name, so it imports torch and the port
only: no JAX.  A grid is ``data`` × ``model`` gloo ranks
(``launch.mesh.make_grid``: world rank ``d·model + m``).  Each body runs the
same in a rank of a grid (its share of the weights taken from the whole
tree it is handed, its data row's block of the batch) and, unsharded, in
the test process, so one body gives both sides of the comparison.
"""
from __future__ import annotations

import hashlib

import torch

import _torch_train_ranks as train_ranks
from repro_torch.checkpoint import ckpt
from repro_torch.core.convert import params_from_numpy, to_numpy
from repro_torch.fleet import publisher
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_grid, make_model_group
from repro_torch.launch.steps import Knobs, build_train_step, make_parallel
from repro_torch.sharding.rules import _keys
from repro_torch.sharding.shard import grid_take, share_fsdp, share_parts
from repro_torch.utils.trees import tree_flatten_with_path, tree_leaves, tree_unflatten


def grid_share(cfg, whole, parallel):
    """This rank's FSDP share of the whole tree ``whole`` (numpy or
    tensors; the whole tree unsharded)."""
    torch.set_num_threads(1)
    params = params_from_numpy(whole) if not isinstance(
        tree_leaves(whole)[0], torch.Tensor) else whole
    if parallel is None:
        return params
    leaves, treedef = tree_flatten_with_path(params)
    return tree_unflatten(treedef, [
        grid_take(t, _keys(p), cfg, parallel.rank, parallel.size, parallel.data_rank,
                  parallel.data_size) for p, t in leaves])


def data_rows(batch, parallel):
    """This rank's data row's block of the batch's rows (all of them
    unsharded or off a grid)."""
    if parallel is None or parallel.data_size == 1:
        return batch
    n = next(iter(batch.values())).shape[0] // parallel.data_size
    return {k: v[parallel.data_rank * n:(parallel.data_rank + 1) * n] for k, v in batch.items()}


def _digest(segs) -> str:
    h = hashlib.sha256()
    for seg in segs:
        h.update(seg.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def replicated_digests(cfg, leaves, parallel):
    """Two hashes of this rank's tree: of every part the model group
    replicates (whole and partial parts; equal along a model row iff they
    are bitwise equal), and of every leaf the data group replicates (equal
    down a data column)."""
    parts = share_parts(cfg, parallel.size)
    fsdp = share_fsdp(cfg, parallel.size, parallel.data_size)
    row = [t if dim is None else t.narrow(dim, off, width)
           for t, (dim, pieces) in zip(leaves, parts)
           for off, width, use in pieces if use != "split"]
    return _digest(row), _digest([t for t, f in zip(leaves, fsdp) if f is None])


def train_case(job, parallel=None):
    """``job["steps"]`` train steps of ``job["cfg"]`` from ``job["params"]``
    (a numpy tree of the whole model) on ``job["batch"]`` (the whole batch:
    each rank takes its data row's block) under each ``Knobs(**kw)`` of
    ``job["knobs"]``: per knobs, this rank's params and AdamW moments after
    the steps (numpy leaves), each step's loss and grad norm, and (on a
    grid) the digests of its replicated parts."""
    cfg = job["cfg"]
    params = grid_share(cfg, job["params"], parallel)
    batch = data_rows({k: torch.as_tensor(v) for k, v in job["batch"].items()}, parallel)
    out = []
    for kw in job["knobs"]:
        step = build_train_step(cfg, Knobs(**kw), parallel)
        p, o, metrics = params, step.opt.init(params), []
        if parallel is not None:
            for k in parallel.counts:
                parallel.counts[k] = 0
        for _ in range(job["steps"]):
            p, o, m = step.fn(p, o, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        res = {"params": [to_numpy(x) for x in tree_leaves(p)],
               "m": [to_numpy(x) for x in tree_leaves(o[1])],
               "v": [to_numpy(x) for x in tree_leaves(o[2])], "metrics": metrics}
        if parallel is not None:
            res["digests"] = [replicated_digests(cfg, tree_leaves(t), parallel)
                              for t in (p, o[1], o[2])]
            res["counts"] = dict(parallel.counts)
        out.append(res)
    return out


def fed_case(job, parallel=None, cohort_group=None):
    """Rounds of ``job["fed"]`` over the LM ``job["cfg"]`` from
    ``job["params"]`` through ``round_step`` on the injected draws of
    ``job["rounds"]``, the cohort split over ``cohort_group`` (the grid's
    data group) and each client over ``parallel``'s model group
    (``_torch_train_ranks.fed_case``, the model group's body): this rank's
    params, momentum and second-moment planes after the rounds and each
    round's metrics."""
    return train_ranks.fed_case(job, parallel, cohort_group)


def serve_case(job, parallel=None):
    """``serve.run`` of ``job["argv"]`` (its ``--ckpt`` a publisher
    directory or file) on the model group ``parallel``.  After decode step
    ``job["publish_after"]`` rank 0 publishes ``job["later"]`` (numpy
    trees, one version each) into ``job["dir"]``.  With ``job["race"]``
    rank 0, right after it reads the pointer naming the first of them,
    publishes the rest at once: at ``retain=2`` the version it read is
    unlinked before any rank opens it.  Returns the tokens, the decode
    steps at which the params were swapped and the versions swapped in."""
    torch.set_num_threads(1)
    args = serve.build_parser().parse_args(job["argv"])
    pub = publisher.ModelPublisher(job["dir"], retain=2)
    later = [params_from_numpy(t) for t in job.get("later", ())]
    lead = parallel is None or parallel.rank == 0
    race = bool(job.get("race")) and parallel is not None
    rest = later[1:] if race else []
    if race and lead:
        read = publisher.GroupParamsWatch._pointer

        def racing(self):
            version = read(self)
            if version == 2:  # the first later version, read: the rest unlink it
                while rest:
                    pub.publish(rest.pop(0), step=pub.version + 1)
            return version

        publisher.GroupParamsWatch._pointer = racing

    def on_step(stats):
        if lead and stats.steps == job.get("publish_after"):
            for t in (later[:1] if race else later):
                pub.publish(t, step=pub.version + 1)

    res = serve.run(args, on_step=on_step, parallel=parallel)
    return {"tokens": res.tokens, "swap_steps": list(res.stats.swap_steps),
            "versions": list(res.stats.versions)}


def _join_rows(path, shares):
    """A leaf joined along its first dimension; a scalar is rank 0's."""
    return shares[0] if shares[0].dim() == 0 else torch.cat(shares)


def snapshot_world(rank, device, chunk, directory, shares):
    """A rank's body: ``save_checkpoint_shares`` of its tree of
    ``shares`` (one tree a rank, joined along the first dimension) in
    gathers of ``chunk`` elements; the file's name (rank 0) or None."""
    ckpt.SHARE_CHUNK = chunk
    return ckpt.save_checkpoint_shares(directory, 1, shares[rank], _join_rows)


def serve_world(rank, device, jobs):
    """A rank's body on a model group of the world: every ``serve_case``."""
    parallel = make_model_group()
    return [serve_case(job, parallel) for job in jobs]


def world(rank, device, data, model, jobs):
    """A rank's body on a ``data`` × ``model`` grid: every job of ``jobs``
    in order (``job["kind"]``: ``"train"`` on the grid's context, or
    ``"fed"``: the cohort over the data group, each client over the model
    group, no FSDP storage)."""
    torch.set_num_threads(1)
    model_group, data_group = make_grid(data, model)
    out = []
    for job in jobs:
        if job["kind"] == "train":
            out.append(train_case(job, make_parallel(model_group, data_group, job["cfg"])))
        else:
            out.append(fed_case(job, make_parallel(model_group), data_group))
    return out
