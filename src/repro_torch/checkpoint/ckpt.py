"""msgpack snapshots of the port's runs, key for key in the reference's layout.

Counterpart of ``repro.checkpoint.ckpt``.  A snapshot is
``<dir>/step_<N>.msgpack`` holding a flat map ``{path: {dtype, shape,
data}}`` plus a ``__meta__`` entry.  Paths are the reference's ``_path_str``
spelling: dict keys and sequence indices joined by ``/``, a NamedTuple field
as ``.name`` (``state/.server/.round``).  bf16 round-trips through a uint16
view.  A write is atomic: tmp file, fsync, rename, then fsync of the
directory, so a reader (or a resumed run) sees the previous complete
snapshot or this one, never a torn file.

``save_fed_run`` writes the port's flat ``FedState`` as the reference's
trees: each ``(P,)`` plane through ``FlatSpec.unravel`` (``state/.params/0/w``,
``state/.server/.momentum/…``), the ``(N, P)`` client-state plane as stacked
``(N, …)`` leaves, the ``(N, P)`` top-k residual rows as they are, and the
host stores as ``population/{ids,rows}`` / ``residuals/{ids,rows}``.  The one
key of its own is the generator: ``state/.rng_torch`` holds
``torch.Generator.get_state()`` (uint8: 16 bytes of seed and offset for a
CUDA generator, the 5,056-byte mt19937 state for a CPU one) and
``__meta__["rng_device"]`` its device type.  The reference's
``load_checkpoint`` therefore refuses a port snapshot with its own
``KeyError`` for ``state/.rng``, and its ``load_flat`` reads every plane.

``save_checkpoint_shares`` writes, from the ranks of a model group or a
grid, the file an unsharded run writes (rank 0 gathers and joins each
leaf's shares);
``load_checkpoint(..., take=)`` restores a rank's shares from such a file.

``load_fed_run`` restores through the port's ``FlatSpec`` (leaf paths and
shapes), with a ``like_state`` that fixes which planes the run carries, their
dtypes and the device.  It reads the reference's snapshots too: every plane
loads, and where the reference kept f32 master planes for sub-f32 params
(``state/.master/…``) the params, second moment and client states load from
them, since they are what the reference itself resumes from; sub-f32 params
without them are refused (the port's params plane is f32), and other bf16
leaves widen to an f32 plane exactly, as the reference's ravel does.  A reference
snapshot's ``state/.rng`` is a threefry key that torch cannot continue: the
restored state's ``rng`` is then None and the caller supplies a generator.

What a snapshot does not carry: the failure stream of a ``FaultyStore``
(``np.random.default_rng((seed, 0xFA17))``), as in the reference — a run
resumed under ``--fault-store-failure-rate > 0`` repeats that stream from
its seed, so its retry counts (never its math) differ from a straight run's.
"""
from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import msgpack
import numpy as np
import torch
import torch.distributed as dist

_BF16 = "bfloat16"
RNG_KEY = "state/.rng_torch"


def _join(prefix: str, part: str) -> str:
    return f"{prefix}/{part}" if prefix else part


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in the reference's leaf order: dict keys
    sorted, sequences in order, NamedTuple fields in declaration order and
    spelled ``.name``; None is an empty subtree; anything else is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten_with_paths(tree[k], _join(prefix, str(k)))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in flatten_with_paths(getattr(tree, f), _join(prefix, "." + f))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, c in enumerate(tree) for kv in flatten_with_paths(c, _join(prefix, str(i)))]
    return [(prefix, tree)]


def _map_with_paths(fn, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_paths(fn, v, _join(prefix, str(k))) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_with_paths(fn, getattr(tree, f), _join(prefix, "." + f))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(fn, c, _join(prefix, str(i))) for i, c in enumerate(tree))
    return fn(prefix, tree)


def _entry(leaf) -> Dict[str, Any]:
    """One ``{dtype, shape, data}`` record of a tensor or array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr, dtype = t.view(torch.int16).numpy().view(np.uint16), _BF16
        else:
            arr = t.numpy()
            dtype = str(arr.dtype)
    else:
        arr = np.ascontiguousarray(leaf)
        dtype = str(arr.dtype)
    return {"dtype": dtype, "shape": list(arr.shape), "data": arr.tobytes()}


def _tensor(entry: Dict[str, Any]) -> torch.Tensor:
    """A CPU tensor of one record (bf16 from its uint16 view)."""
    if entry["dtype"] == _BF16:
        arr = np.frombuffer(entry["data"], dtype=np.uint16).reshape(entry["shape"])
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    arr = np.frombuffer(entry["data"], dtype=np.dtype(entry["dtype"]))
    return torch.from_numpy(arr.reshape(entry["shape"]).copy())


def fsync_dir(directory: str) -> None:
    try:
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # platforms that refuse a directory fsync
        pass


def save_checkpoint(directory: str, step: int, tree: Any, meta: Optional[Dict] = None) -> str:
    """Write ``tree`` (nested dicts / lists / NamedTuples of tensors or
    numpy arrays) as ``<directory>/step_<step>.msgpack``, atomically."""
    return _write(directory, step,
                  {path: _entry(leaf) for path, leaf in flatten_with_paths(tree)}, meta)


def _write(directory: str, step: int, payload: Dict[str, Any], meta: Optional[Dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    payload["__meta__"] = dict(meta or {}, step=step)
    fname = os.path.join(directory, f"step_{step}.msgpack")
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fname)
    fsync_dir(directory)
    return fname


def _read(directory: str, step: Optional[int]) -> Tuple[Dict[str, Any], Dict]:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    with open(os.path.join(directory, f"step_{step}.msgpack"), "rb") as f:
        payload = msgpack.unpackb(f.read(), raw=False)
    return payload, payload.pop("__meta__", {})


SHARE_CHUNK = 1 << 24  # elements of a share that one gather to rank 0 carries


def save_checkpoint_shares(directory: str, step: int, tree: Any,
                           join: Callable[[str, List[torch.Tensor]], torch.Tensor]
                           ) -> Optional[str]:
    """``save_checkpoint`` of the whole tree whose shares the ranks of the
    world hold: every rank calls it with its own ``tree`` (the same
    structure on every rank, each leaf the same shape on every rank).  Leaf
    by leaf, ``gather`` brings every rank's share to rank 0 in blocks of at
    most ``SHARE_CHUNK`` elements (from the host on gloo, which gathers
    only CPU tensors), which copies them to the host and joins them there
    (``join(path, shares)``, rank order); rank 0 then writes the file
    atomically, and a barrier releases the others once it is there.  Rank 0
    receives into one set of ``world`` blocks a dtype, kept for the call;
    the other ranks add no device memory.  The file is the one an
    unsharded run of the whole tree writes.  Rank 0 holds the whole tree on
    the host, so host memory bounds the model that can be snapshotted so.
    Returns the file's name on rank 0, None on the others."""
    rank, world = dist.get_rank(), dist.get_world_size()
    on_host = dist.get_backend() != "nccl"
    leaves = flatten_with_paths(tree)
    room: Dict[torch.dtype, int] = {}
    for _, leaf in leaves:
        room[leaf.dtype] = max(room.get(leaf.dtype, 0), min(leaf.numel(), SHARE_CHUNK))
    recv: Dict[torch.dtype, List[torch.Tensor]] = {}
    whole = []
    for path, leaf in leaves:
        flat = leaf.detach().reshape(-1)
        hosts = [torch.empty(flat.numel(), dtype=flat.dtype) for _ in range(world)] \
            if rank == 0 else None
        for at in range(0, flat.numel(), SHARE_CHUNK):
            block = flat[at:at + SHARE_CHUNK].contiguous()
            if on_host:
                block = block.cpu()
            parts = None
            if rank == 0:
                if flat.dtype not in recv:
                    recv[flat.dtype] = [torch.empty(room[flat.dtype], dtype=flat.dtype,
                                                    device=block.device) for _ in range(world)]
                parts = [r[:block.numel()] for r in recv[flat.dtype]]
            dist.gather(block, parts, dst=0)
            if rank == 0:
                for h, p in zip(hosts, parts):
                    h[at:at + block.numel()].copy_(p)
        if rank == 0:
            whole.append((path, join(path, [h.view(leaf.shape) for h in hosts])))
        del hosts
    del recv
    fname = None
    if rank == 0:
        fname = _write(directory, step, {path: _entry(t) for path, t in whole}, None)
    dist.barrier()
    return fname


def load_checkpoint(directory: str, step: Optional[int], like: Any,
                    take: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None
                    ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (a template tree): each leaf
    comes back in its stored dtype, on the template leaf's device.  A path
    the snapshot lacks raises ``KeyError``, a leaf of another shape than
    the template's ``ValueError``.  ``take(path, whole)`` restores a share
    of each whole leaf (a rank's, of a snapshot written by
    ``save_checkpoint_shares`` or an unsharded run): the template then
    holds the shares, whose shapes are checked."""
    payload, meta = _read(directory, step)

    def restore(path, leaf):
        if path not in payload:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        t = _tensor(payload[path])
        if take is not None:
            t = take(path, t)
        if not isinstance(leaf, torch.Tensor):
            return t
        if t.shape != leaf.shape:
            raise ValueError(f"checkpoint leaf {path!r} has shape {tuple(t.shape)}, the "
                             f"template's {tuple(leaf.shape)}")
        return t.to(leaf.device)

    return _map_with_paths(restore, like), meta


def load_flat(directory: str, step: Optional[int] = None) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Template-free restore: the raw ``{path: CPU tensor}`` map plus meta,
    each leaf in its stored dtype and shape (a store's ``(M, P)`` rows, whose
    M no template can predict, come back this way)."""
    payload, meta = _read(directory, step)
    return {k: _tensor(v) for k, v in payload.items()}, meta


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)\.msgpack", name))]
    return max(steps) if steps else None


# ---------------------------------------------------------------- whole runs
class _Server(NamedTuple):
    """The reference's ``ServerState`` field order (the port's is
    ``(momentum, round, second_moment)``)."""

    momentum: Any
    second_moment: Any
    round: Any


class _State(NamedTuple):
    """The reference's ``FedState`` field order, the generator under the
    port's own key; no ``master`` (the port's params plane is f32)."""

    params: Any
    server: _Server
    client_states: Any
    rng_torch: Any
    residuals: Any


def save_fed_run(directory: str, step: int, state, spec, population: Any = None,
                 residuals: Any = None, meta: Optional[Dict] = None) -> str:
    """One atomic snapshot of a whole federated run: the flat ``FedState``
    (``spec`` is the params' ``FlatSpec``) written as the reference's trees,
    plus the host stores (a store, or its packed ``{"ids", "rows"}``) — the
    halves publish together or not at all."""
    def tree(plane):  # leaves in the plane's dtype (a bf16 momentum stays bf16)
        return None if plane is None else spec.unravel(plane.detach().cpu(), dtype=plane.dtype)

    srv = state.server
    snap = _State(
        params=tree(state.params),
        server=_Server(tree(srv.momentum), tree(srv.second_moment), srv.round),
        client_states=tree(state.client_states),
        rng_torch=None if state.rng is None else state.rng.get_state(),
        residuals=state.residuals,
    )
    out: Dict[str, Any] = {"state": snap}
    for name, store in (("population", population), ("residuals", residuals)):
        if store is not None:
            out[name] = store.to_pytree() if hasattr(store, "to_pytree") else store
    meta = dict(meta or {})
    if state.rng is not None:
        meta["rng_device"] = state.rng.device.type
    return save_checkpoint(directory, step, out, meta=meta)


def _store(flat: Dict[str, torch.Tensor], prefix: str, num_clients: Optional[int]):
    """Rebuild one packed store half (``population/…`` or ``residuals/…``)."""
    packed = {k.split("/", 1)[1]: v.numpy() for k, v in flat.items()
              if k.startswith(prefix + "/")}
    if not packed:
        return None
    if num_clients is not None:
        from repro_torch.data.population import HostPopulationStore

        return HostPopulationStore.from_pytree(packed, num_clients)
    return packed


def _leaf_paths(spec) -> List[str]:
    return [p for p, _ in flatten_with_paths(spec.unravel(torch.zeros(spec.size)))]


def _plane(flat, prefix: str, spec, stacked: bool) -> torch.Tensor:
    """The ``(P,)`` (or, stacked, ``(N, P)``) plane of the leaves under
    ``prefix``, in their stored dtype."""
    segs = []
    for path, leaf in zip(_leaf_paths(spec), spec.leaves):
        key = f"{prefix}/{path}"
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = flat[key]
        lead = t.shape[:1] if stacked else ()
        if tuple(t.shape) != (*lead, *leaf.shape):
            raise ValueError(f"{key}: stored shape {tuple(t.shape)}, this model's leaf "
                             f"{leaf.shape}{' stacked' if stacked else ''}")
        segs.append(t.reshape(*lead, -1))
    return torch.cat(segs, dim=-1)


def _restore_plane(flat, name: str, spec, like, stacked: bool = False):
    """Plane ``name`` of the snapshot in ``like``'s dtype and device, from
    the reference's f32 master plane where it kept one."""
    if like is None:
        return None
    master = f"state/.master/.{name.rsplit('.', 1)[-1]}"
    if master in flat:
        t = flat[master]
    else:
        t = _plane(flat, f"state/.{name}", spec, stacked)
    if t.dtype != like.dtype:
        if name == "params":
            raise ValueError("snapshot plane params: sub-f32 params without the reference's "
                             "f32 master planes (state/.master/…); the port's params plane "
                             "is f32")
        if (t.dtype, like.dtype) != (torch.bfloat16, torch.float32):
            raise ValueError(f"snapshot plane {name}: stored dtype {t.dtype}, this run's "
                             f"{like.dtype}")
        t = t.to(like.dtype)  # exact, as the reference's ravel of bf16 leaves
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"snapshot plane {name}: shape {tuple(t.shape)}, this run's "
                         f"{tuple(like.shape)}")
    return t.to(like.device)


def load_fed_run(directory: str, step: Optional[int], like_state, spec,
                 num_clients: Optional[int] = None) -> Tuple[Any, Any, Any, Dict]:
    """Restore a snapshot → ``(state, population, residuals, meta)``.

    ``like_state`` (a port ``FedState``, e.g. a fresh ``engine.init``) fixes
    which planes the run carries, their dtypes and the device; ``spec`` the
    leaf layout.  Extra planes in the snapshot are ignored, a missing one
    raises ``KeyError``.  The generator comes back on ``like_state.rng``'s
    device (a snapshot of a CUDA generator cannot resume on the CPU, nor
    the reverse: refused); a reference snapshot gives ``rng`` None.  The
    store halves come back as ``HostPopulationStore``s when ``num_clients``
    is given, else as the packed dicts; None where the snapshot has none."""
    flat, meta = load_flat(directory, step)
    srv = like_state.server
    rng = None
    if RNG_KEY in flat:
        dev = (like_state.rng.device if like_state.rng is not None
               else like_state.params.device)
        saved = meta.get("rng_device")
        if saved != dev.type:
            raise ValueError(f"snapshot's generator is a {saved} generator; it cannot resume "
                             f"on {dev.type} (its state is another kind of generator's)")
        rng = torch.Generator(device=dev)
        rng.set_state(flat[RNG_KEY])
    server = srv._replace(
        momentum=_restore_plane(flat, "server/.momentum", spec, srv.momentum),
        second_moment=_restore_plane(flat, "server/.second_moment", spec, srv.second_moment),
        round=flat["state/.server/.round"].to(srv.round.device),
    )
    residuals = like_state.residuals
    if residuals is not None:
        if "state/.residuals" not in flat:
            raise KeyError("checkpoint missing leaf 'state/.residuals'")
        residuals = flat["state/.residuals"].to(residuals.device)
    state = like_state._replace(
        params=_restore_plane(flat, "params", spec, like_state.params),
        server=server,
        rng=rng,
        residuals=residuals,
        client_states=_restore_plane(flat, "client_states", spec, like_state.client_states,
                                     stacked=True),
    )
    return (state, _store(flat, "population", num_clients),
            _store(flat, "residuals", num_clients), meta)
