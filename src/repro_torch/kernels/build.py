"""Build the CUDA sources of ``repro_torch/csrc`` with ``nvcc`` and bind them
with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C launch function, so it compiles
in seconds without PyTorch's headers.  A build goes into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), named by a hash of
the source, every shared header ``csrc/*.cuh`` and the flags, so an edited
source or header is rebuilt and an unchanged one is reused.  Nothing is
built when a module is imported: the first launch of a kernel builds it,
and ``build_all`` builds several at once (one ``nvcc`` process per source,
all started together).

``NativeKernel`` is the binding of one C entry point of a source (a source
may hold several, each with its own binding): its ``load()`` builds and
loads the library, ``launch()`` calls the C function, raises on a non-zero
``cudaGetLastError()``, and adds one to ``launches`` — the plain integer
count that shows a run went through the kernel.

A dry-run (``repro_torch.launch.dryrun``) calls the wrappers with
``FakeTensor`` inputs, which have no memory to launch on: each wrapper then
allocates its outputs and workspaces as a launch would, calls
``fake_launch`` (which tells every hook in ``FAKE_LAUNCH_HOOKS`` — a census,
``launch.hlo_stats.CensusMode`` — and leaves ``launches`` alone) and builds
nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """The library built from ``csrc/<name>.cu``: a source may include any
    ``csrc/*.cuh``, so every header is part of the key."""
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc_command(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str]) -> Dict[str, dict]:
    """Build every named source that has no current library, in parallel.

    Returns ``{name: {"path", "seconds", "log"}}``; ``log`` holds nvcc's
    output (``-Xptxas -v``: registers and spills per kernel), empty for a
    library that was already built.  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, done = {}, {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.exists():
            done[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (path, tmp, subprocess.Popen(
            _nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (path, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        done[name] = {"path": path, "seconds": time.perf_counter() - t0, "log": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


# hook(name, nbytes, flops) of every fake launch: the bytes the launch would
# move (its inputs read once, its outputs written once) and its operations
FAKE_LAUNCH_HOOKS: List[Callable[[str, int, int], None]] = []


class NativeKernel:
    """The ctypes binding of entry point ``symbol`` of ``csrc/<source>.cu``
    (``source`` defaults to ``name``) and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence,
                 source: str = "") -> None:
        self.name = name
        self.source = source or name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    def load(self):
        """Build (if needed) and load the library; returns the C launch
        function."""
        with self._lock:
            if self._fn is None:
                path = build_all([self.source])[self.source]["path"]
                lib = ctypes.CDLL(str(path))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, f"{self.source}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib, self._fn, self._err = lib, fn, err
            return self._fn

    def launch(self, fn, *args) -> None:
        """Call the loaded C function ``fn``; raise on a CUDA error, count
        the launch otherwise."""
        code = fn(*args)
        if code != 0:
            msg = self._err(code).decode() if self._err is not None else str(code)
            raise RuntimeError(f"{self.name} launch failed: CUDA error {code} ({msg})")
        self.launches += 1

    def fake_launch(self, tensors: Sequence, flops: int = 0) -> None:
        """Record a launch on ``FakeTensor`` operands (a dry-run): each hook
        of ``FAKE_LAUNCH_HOOKS`` is told this binding's name, the bytes of
        ``tensors`` (the launch's inputs and outputs) and ``flops``.
        Nothing is built or launched, and ``launches`` stays as it is."""
        nbytes = sum(t.numel() * t.element_size() for t in tensors if t is not None)
        for hook in list(FAKE_LAUNCH_HOOKS):
            hook(self.name, nbytes, flops)
