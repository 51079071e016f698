"""A step's census from eager dispatch: collectives, aten ops, bytes and kernel
launches (counterpart of ``repro.launch.hlo_stats``).

The reference parses the partitioned HLO of a compiled program.  There is no
HLO here: the port runs eagerly, so ``CensusMode``, a ``TorchDispatchMode``,
sees every op a step dispatches, on real tensors or on a dry-run's
``FakeTensor``s (``launch.dryrun``), and records

* every c10d collective by kind, under the reference's names (``"all-reduce"``,
  ``"all-gather"``, ``"reduce-scatter"``, ``"all-to-all"``, and
  ``"broadcast"``, which a compiled SPMD program has no need of), each with
  ``count``, ``bytes`` (the result's bytes on this rank, the reference's
  convention) and ``sent`` (the input's bytes, the convention of
  ``models.layers.ParallelContext.counts["bytes"]``), by process group
  where the census is given the groups' names;
* every aten op by name (``op_census``) and ``op_bytes``: the bytes of each
  op's tensor inputs and outputs, views and fresh allocations excepted, which
  is what eager PyTorch moves with no fusion (not XLA's "bytes accessed");
* each hand kernel's launches on ``FakeTensor`` operands, with the bytes and
  operations each would take (``kernels.build.NativeKernel.fake_launch``);
* host reads (``aten._local_scalar_dense``: ``.item()``, ``bool()``): on a
  ``FakeTensor`` there is no value to read, so the census answers 1 (True)
  and counts the read; a step that makes none (the resident round, the
  serving steps) is the same step on fake tensors as on real ones;
* which threads run GEMMs that torch sends to cuBLAS on the card (the
  caller's, and autograd's device thread for a backward) and which of them
  run one with a bias epilogue (cuBLASLt): on the card each holds a
  workspace of its own that the caching allocator counts
  (``blas_workspace_bytes``).
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import build

# c10d op → the reference's collective kind
KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast_": "broadcast",
}
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "broadcast")
# ops that write into an output operand: args[0] is the result, args[1] the input
_OUT_IN = ("all-gather", "reduce-scatter", "all-to-all")
# ops that allocate and move nothing, and the host read
_NO_BYTES = {"empty", "empty_like", "empty_strided", "zeros", "ones", "full", "arange",
             "scalar_tensor", "randn", "rand", "randint", "randperm", "detach", "lift_fresh",
             "_local_scalar_dense"}


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in ``tree`` (nested lists, tuples, dicts)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(tensor_bytes(t) for t in tree.values())
    return 0


def _group_of(args) -> Optional[Any]:
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a)
    return None


_HOST_READ = object()
# aten ops that run as cuBLAS GEMMs on the card
_BLAS = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
         "_addmm_activation"}
_LT_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16)


def _uses_lt(name: str, args, kwargs) -> bool:
    """Whether torch runs this GEMM through cuBLASLt with a bias epilogue:
    ``addmm`` of a contiguous 1-D bias at beta 1 over matrices of more than
    one row and column (``_addmm_activation`` always)."""
    if name == "_addmm_activation":
        return True
    if name != "addmm" or kwargs.get("beta", 1) != 1:
        return False
    bias, m1, m2 = args[:3]
    return (bias.dim() == 1 and bias.is_contiguous() and bias.dtype in _LT_DTYPES
            and min(m1.shape) > 1 and min(m2.shape) > 1)


def _classify(func):
    """What the census does with ``func``: the host read, or ``(aten op
    name or None, whether its bytes count, collective kind or None)``."""
    if func is torch.ops.aten._local_scalar_dense.default:
        return _HOST_READ
    name = func.overloadpacket.__name__
    if func.namespace == "c10d":
        return None, False, KINDS.get(name)
    if func.namespace == "aten":
        return name, not func.is_view and name not in _NO_BYTES, None
    return None, False, None


def _empty_stats() -> Dict[str, Dict[str, int]]:
    return {k: {"count": 0, "bytes": 0, "sent": 0} for k in COLLECTIVES}


def totals(stats: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """``stats`` (kind → count / bytes / sent) with the reference's ``"total"``."""
    out = {k: dict(v) for k, v in stats.items() if k != "total"}
    out["total"] = {f: sum(v[f] for v in out.values()) for f in ("count", "bytes", "sent")}
    return out


class CensusMode(TorchDispatchMode):
    """Record what a step dispatches (see the module docstring).  ``groups``
    names the process groups whose collectives ``by_group`` keeps apart
    (``{"model": …, "data": …}``); a collective on any other group counts
    under ``"other"``.  ``collective_stats()`` sums every group."""

    def __init__(self, groups: Optional[Dict[str, Any]] = None) -> None:
        super().__init__()
        self.groups = {g.group_name: name for name, g in (groups or {}).items()
                       if g is not None}
        self.by_group: Dict[str, Dict[str, Dict[str, int]]] = {}
        self.ops: Counter = Counter()
        self.op_bytes = 0
        self.launches: Counter = Counter()
        self.kernel_bytes = 0
        self.kernel_flops = 0
        self.host_reads = 0
        self.blas: set = set()  # ("forward" | "backward", "cublas" | "cublaslt")
        self._what: Dict[Any, Any] = {}

    def _kernel(self, name: str, nbytes: int, flops: int) -> None:
        self.launches[name] += 1
        self.kernel_bytes += nbytes
        self.kernel_flops += flops

    def __enter__(self):
        build.FAKE_LAUNCH_HOOKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        build.FAKE_LAUNCH_HOOKS.remove(self._kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        what = self._what.get(func)
        if what is None:
            what = self._what[func] = _classify(func)
        if what is _HOST_READ:
            self.host_reads += 1
            t = args[0]
            if isinstance(t, FakeTensor):  # no value to read: answer 1 (True)
                return True if t.dtype == torch.bool else (1.0 if t.is_floating_point() else 1)
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        name, moves, kind = what
        if kind is not None:
            group = _group_of(args)
            where = "other" if group is None else self.groups.get(group.group_name, "other")
            stats = self.by_group.setdefault(where, _empty_stats())[kind]
            result, sent = (args[0], args[1]) if kind in _OUT_IN else (args[0], args[0])
            stats["count"] += 1
            stats["bytes"] += tensor_bytes(result)
            stats["sent"] += tensor_bytes(sent)
        elif name is not None:
            self.ops[name] += 1
            if name in _BLAS:
                thread = ("forward" if torch._C._current_autograd_node() is None
                          else "backward")
                self.blas.add((thread, "cublaslt" if _uses_lt(name, args, kwargs)
                               else "cublas"))
            if moves:
                self.op_bytes += tensor_bytes(args) + tensor_bytes(kwargs) + tensor_bytes(out)
        return out

    def collective_stats(self) -> Dict[str, Dict[str, int]]:
        """Every group's collectives summed by kind, with ``"total"``."""
        out = _empty_stats()
        for stats in self.by_group.values():
            for kind, v in stats.items():
                for f in v:
                    out[kind][f] += v[f]
        return totals(out)

    def group_stats(self, name: str) -> Dict[str, Dict[str, int]]:
        """The collectives on the group ``name`` by kind, with ``"total"``."""
        return totals(self.by_group.get(name, _empty_stats()))


def blas_workspace_bytes(census: CensusMode) -> int:
    """The cuBLAS workspaces the census's step allocates on the card when
    none is held yet (a fresh process, or after
    ``torch._C._cuda_clearCublasWorkspaces``): one for each thread that
    runs a cuBLAS GEMM, one for each that runs a cuBLASLt one
    (``launch.mesh.CUBLAS_WORKSPACE_BYTES``, ``CUBLASLT_WORKSPACE_BYTES``)."""
    from repro_torch.launch.mesh import CUBLAS_WORKSPACE_BYTES, CUBLASLT_WORKSPACE_BYTES

    size = {"cublas": CUBLAS_WORKSPACE_BYTES, "cublaslt": CUBLASLT_WORKSPACE_BYTES}
    return sum(size[kind] for _, kind in census.blas)


def op_census(ops: Counter, top: int = 12) -> Dict[str, int]:
    """The ``top`` most frequent ops of the counter ``ops`` (the reference's
    ``op_census`` over HLO op kinds): where a remat recompute shows."""
    return dict(sorted(ops.items(), key=lambda kv: (-kv[1], kv[0]))[:top])


def parallel_counts(census: CensusMode) -> Dict[str, int]:
    """The census in the keys of ``ParallelContext.counts`` (what the model's
    collectives tally on real ranks), for a census whose groups are named
    ``"model"`` and ``"data"``: the model group's all-reduces and
    all-gathers and the bytes sent into them; the data group's all-gathers
    (FSDP gathers), reduce-scatters and all-reduces."""
    m, d = census.group_stats("model"), census.group_stats("data")
    return {"all_reduce": m["all-reduce"]["count"], "all_gather": m["all-gather"]["count"],
            "bytes": m["all-reduce"]["sent"] + m["all-gather"]["sent"],
            "data_all_gather": d["all-gather"]["count"],
            "data_reduce_scatter": d["reduce-scatter"]["count"],
            "data_all_reduce": d["all-reduce"]["count"]}


COUNT_KEYS = ("all_reduce", "all_gather", "bytes", "data_all_gather", "data_reduce_scatter",
              "data_all_reduce")


def comparable_counts(counts: Dict[str, int]) -> Dict[str, int]:
    """``ParallelContext.counts`` restricted to the keys a census predicts
    (``parallel_counts``'s)."""
    return {k: int(counts.get(k, 0)) for k in COUNT_KEYS}
