"""Atomic model publication: versioned payloads + a "latest" pointer.

Counterpart of ``repro.fleet.publisher``; a directory either package
publishes is read by the other (the same payload layout and pointer).

Built on the checkpoint layer's atomicity primitive (``save_checkpoint``'s
tmp + fsync + rename + dir-fsync): a publish writes the COMPLETE payload
file first, then atomically renames the ``LATEST.json`` pointer over the
old one.  A reader therefore either sees the previous complete version or
the new complete version — never a torn payload and never a pointer to a
half-written file.  Versions are strictly monotone.

Retention is a bounded ring: only the newest ``retain`` payload files are
kept (``retain >= 2`` enforced, so the version a reader just resolved
from the pointer survives at least one further publish).  A reader that
lags MORE than ``retain`` publishes behind can race a retention unlink —
``ParamsWatch.poll`` handles that by re-reading the pointer and loading
the (newer) version it now names, preserving monotonicity.

Layout::

    <dir>/step_<version>.msgpack   payload: {"params": <pytree>} (+ meta)
    <dir>/LATEST.json              {"schema", "version", "file", "step", ...}

``watch(dir)`` / ``ParamsWatch`` is the subscriber half the serving loop
polls between decode steps: ``poll()`` returns ``None`` while the
published version is unchanged, else ``(version, params, meta)`` for the
new one — the hot-swap seam of ``repro_torch.launch.serve.serve_loop``.
``GroupParamsWatch`` is the same for the ranks of a model group: rank 0
reads the pointer and every rank loads its share of the version it
broadcasts, so every rank swaps at the same step.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import (
    fsync_dir,
    latest_step,
    load_checkpoint,
    load_flat,
    save_checkpoint,
)

POINTER = "LATEST.json"
POINTER_SCHEMA = 1


def read_pointer(directory: str) -> Optional[Dict[str, Any]]:
    """The current ``LATEST.json`` contents, or None before any publish.
    The pointer is only ever replaced atomically, so a successful read is
    always a complete pointer."""
    try:
        with open(os.path.join(directory, POINTER), "rb") as f:
            return json.loads(f.read())
    except FileNotFoundError:
        return None


class ModelPublisher:
    """Writer half: ``publish(params, step=...)`` → new monotone version.

    Reopening an existing directory continues its version sequence (from
    the pointer, falling back to the newest payload file on disk)."""

    def __init__(self, directory: str, *, retain: int = 4) -> None:
        if retain < 2:
            raise ValueError(
                f"retain={retain}: the ring must keep >= 2 versions so a "
                "reader's just-resolved version survives the next publish"
            )
        self.directory = str(directory)
        self.retain = int(retain)
        os.makedirs(self.directory, exist_ok=True)
        ptr = read_pointer(self.directory)
        self._version = int(ptr["version"]) if ptr else (
            latest_step(self.directory) or 0
        )

    @property
    def version(self) -> int:
        """Last published version (0 = nothing published yet)."""
        return self._version

    def publish(self, params: Any, *, step: int,
                meta: Optional[Dict[str, Any]] = None) -> int:
        """Atomically publish ``params`` as the next version.

        Order is load-bearing: (1) payload file lands complete+fsynced
        under its final name, (2) pointer renames over LATEST.json,
        (3) retention unlinks ring overflow.  A kill between any two
        steps leaves a consistent directory (worst case: an unreferenced
        payload file, reclaimed by the next publish's retention pass)."""
        version = self._version + 1
        # save_checkpoint claims the "step" meta key for its own step —
        # the VERSION here — so the training round travels as "fed_step"
        # (load_published normalizes it back to meta["step"])
        save_checkpoint(
            self.directory, version, {"params": params},
            meta=dict(meta or {}, fed_step=int(step), version=version),
        )
        pointer = {
            "schema": POINTER_SCHEMA,
            "version": version,
            "file": f"step_{version}.msgpack",
            "step": int(step),
            "t_unix": time.time(),
        }
        tmp = os.path.join(self.directory, POINTER + ".tmp")
        with open(tmp, "w") as f:
            f.write(json.dumps(pointer))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.directory, POINTER))
        fsync_dir(self.directory)
        self._version = version
        self._retire(version)
        return version

    def _retire(self, version: int) -> None:
        floor = version - self.retain
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".msgpack"):
                try:
                    v = int(name[len("step_"):-len(".msgpack")])
                except ValueError:
                    continue
                if v <= floor:
                    try:
                        os.unlink(os.path.join(self.directory, name))
                    except FileNotFoundError:
                        pass


def load_published(directory: str, template: Any = None,
                   version: Optional[int] = None,
                   take: Optional[Callable[[str, Any], Any]] = None) -> Tuple[int, Any, Dict]:
    """Load a published version → ``(version, params, meta)``.

    ``version=None`` resolves the pointer.  With ``template`` the params
    restore through the typed template path (structure fixed, each leaf on
    its template leaf's device; ``take(path, whole)``: a rank's share of
    each leaf, ``checkpoint.ckpt.load_checkpoint``); without one they come
    back as the raw ``{path: CPU tensor}`` map."""
    if version is None:
        ptr = read_pointer(directory)
        if ptr is None:
            raise FileNotFoundError(f"{directory}: nothing published yet")
        version = int(ptr["version"])
    if template is not None:
        tree, meta = load_checkpoint(directory, version, {"params": template}, take)
        return version, tree["params"], _norm_meta(meta)
    flat, meta = load_flat(directory, version)
    params = {k.split("/", 1)[1]: v for k, v in flat.items()
              if k.startswith("params/")}
    return version, params, _norm_meta(meta)


def _norm_meta(meta: Dict[str, Any]) -> Dict[str, Any]:
    """Surface the training round as ``meta["step"]`` (stored as
    ``fed_step`` because ckpt.py's own ``step`` slot holds the version)."""
    meta = dict(meta)
    if "fed_step" in meta:
        meta["step"] = meta["fed_step"]
    return meta


class ParamsWatch:
    """Subscriber half: detect + load new versions without racing a
    concurrent publish.  ``poll()`` is cheap when nothing changed (one
    pointer read)."""

    def __init__(self, directory: str, template: Any = None,
                 *, max_retries: int = 8) -> None:
        self.directory = str(directory)
        self.template = template
        self.max_retries = int(max_retries)
        self.version = 0  # last version returned (0 = none yet)

    def poll(self) -> Optional[Tuple[int, Any, Dict]]:
        """``None`` if the published version is unchanged; else
        ``(version, params, meta)`` for the new latest.  Versions returned
        across calls are strictly increasing."""
        ptr = read_pointer(self.directory)
        if ptr is None or int(ptr["version"]) <= self.version:
            return None
        # the pointer may advance (and retention may unlink the version we
        # just resolved) between reading LATEST.json and opening the
        # payload — on FileNotFoundError, re-resolve and try the newer one
        for _ in range(self.max_retries):
            version = int(ptr["version"])
            try:
                version, params, meta = load_published(
                    self.directory, self.template, version
                )
            except FileNotFoundError:
                nxt = read_pointer(self.directory)
                if nxt is None or int(nxt["version"]) <= version:
                    raise
                ptr = nxt
                continue
            self.version = version
            return version, params, meta
        raise RuntimeError(
            f"{self.directory}: publisher outran the watcher "
            f"{self.max_retries}x in one poll — raise retain or max_retries"
        )


GROUP_WATCH_RETRIES = 8  # versions a group's poll tries before it gives up


class GroupParamsWatch:
    """``ParamsWatch`` for the ranks of a model group, or of a grid's whole
    world (its data group's gathers need every rank on one version), which
    must swap at the same decode step to the same version: each rank polling on its own
    could see a publish a step apart from the others, or resolve different
    versions when retention unlinks a file.  Every rank calls ``poll()`` at
    every step boundary.  Rank 0 alone reads the pointer and broadcasts the
    version over ``group``; every rank loads exactly that version, its share
    of it (``take``); the ranks then agree (an ``all_reduce`` of a flag)
    whether every one of them opened it, and if one did not (retention
    unlinked it after rank 0 read the pointer) rank 0 reads the pointer
    again and all retry together on the version it names now."""

    def __init__(self, directory: str, template: Any, group,
                 *, take: Optional[Callable[[str, Any], Any]] = None) -> None:
        self.directory = str(directory)
        self.template = template
        self.take = take
        self.group = group
        self.version = 0  # last version returned (0 = none yet)
        self._rank = dist.get_rank(group)
        self._src = dist.get_global_rank(group, 0)
        self._dev = (torch.device("cuda", torch.cuda.current_device())
                     if dist.get_backend(group) == "nccl" else torch.device("cpu"))

    def _pointer(self) -> int:
        """Rank 0: the version ``LATEST.json`` names (0 before any)."""
        ptr = read_pointer(self.directory)
        return 0 if ptr is None else int(ptr["version"])

    def _agree(self, value: int, op) -> int:
        t = torch.tensor([value], dtype=torch.int64, device=self._dev)
        if op is None:
            dist.broadcast(t, src=self._src, group=self.group)
        else:
            dist.all_reduce(t, op=op, group=self.group)
        return int(t.item())

    def poll(self) -> Optional[Tuple[int, Any, Dict]]:
        """``None`` on every rank if rank 0's pointer names no newer version;
        else ``(version, params, meta)``, the same version on every rank."""
        version = self._agree(self._pointer() if self._rank == 0 else 0, None)
        for _ in range(GROUP_WATCH_RETRIES):
            if version <= self.version:
                return None
            try:
                got = load_published(self.directory, self.template, version, self.take)
            except FileNotFoundError:
                got = None
            if self._agree(int(got is not None), dist.ReduceOp.MIN):
                self.version = version
                return got
            newer = self._pointer() if self._rank == 0 else 0
            version = self._agree(newer if newer > version else -1, None)
            if version < 0:
                raise FileNotFoundError(f"{self.directory}: a published version vanished and "
                                        f"nothing newer is published")
        raise RuntimeError(
            f"{self.directory}: publisher outran the group's watch "
            f"{GROUP_WATCH_RETRIES}x in one poll — raise retain"
        )


def watch(directory: str, template: Any = None) -> ParamsWatch:
    return ParamsWatch(directory, template)
