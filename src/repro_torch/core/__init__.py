"""FedCM core: the declarative algorithm registry and the round engine.

Counterpart of ``repro.core``.  ``repro_torch.core.registry`` is the public
algorithm API: one ``AlgorithmSpec`` (a client-direction coefficient row
or a ``direction_fn``, server-fold coefficient rows or a ``server_fn``,
state-plane flags) drives the sync round, the async ring, the host store
and cohort sharding, with the fused CUDA kernels under the affine rows;
a round whose clients are model groups runs beside cohort sharding, the
reference's ``fed_dryrun`` grid (``FederatedEngine``'s ``cohort_group`` and
``model_group`` together).
``repro_torch.core.algorithms`` holds the builtin specs;
``@register_algorithm`` adds new ones as data.

The per-leaf tree path (``use_flat_plane=False``, ROADMAP A.16 (d) 4) is
the reference's oracle route: ``FederatedEngine`` keeps the params tree as
its state and runs each round leaf by leaf with the registry's tree
interpreters, launching no kernel; ``client_update`` / ``ClientOutputs``
are its one-client local steps and uplink, and ``flat_client_update`` /
``FlatClientOutputs`` the flat plane's (one row of the engine's cohort
pass).

The reference's exports are all here but one, which has no counterpart:

* ``FlatMaster``: the reference's f32 cache of a sub-f32 tree's planes
  across calls.  The port's state already is the f32 plane
  (``FedState.params``), so there is nothing to cache.
"""
import importlib

# each export by its module; imported on first use (PEP 562), so importing a
# kernel wrapper, which the engine imports in turn, never cycles through here
_HOME = {
    "repro_torch.core.algorithms": ("ALGORITHMS", "FlatClientOutputs",
                                    "sparse_client_finalize"),
    "repro_torch.core.engine": ("AsyncRoundMetrics", "FederatedEngine", "FedState",
                                "RoundMetrics", "client_update", "cohort_capacity",
                                "flat_client_update", "local_learning_rate",
                                "make_eval_fn", "sample_cohort", "sample_cohort_ex"),
    "repro_torch.core.faults": ("FaultPlan", "corrupt_uplink", "fault_masks", "rows_finite",
                                "zero_rows"),
    "repro_torch.core.flat": ("CohortUplink", "FlatSpec", "LeafSpec", "ring_push"),
    "repro_torch.core.registry": ("Algorithm", "AlgorithmSpec", "ClientOutputs", "DirectionRow",
                                  "FoldPass",
                                  "ServerState", "client_state_init", "describe_algorithm",
                                  "get_algorithm", "list_algorithms", "register_algorithm",
                                  "routing_table_md", "server_init", "unregister_algorithm"),
}
_MODULE_OF = {name: module for module, names in _HOME.items() for name in names}

__all__ = sorted(_MODULE_OF)

#: the reference's exports with no counterpart here (see the module docstring)
NOT_PORTED = ("FlatMaster",)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if _MODULE_OF[name] != "repro_torch.core.algorithms":
        importlib.import_module("repro_torch.core.algorithms")  # the builtin specs register
    return getattr(importlib.import_module(_MODULE_OF[name]), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
