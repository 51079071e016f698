"""Port vs reference: the async ring against the reference's
``run_rounds_async`` on its kernel route (its Pallas kernels in interpret
mode), for fedcm, scaffold, mimelite, feddyn and fedadam at
(D, S, γ) ∈ {(2, 1, 0.9), (3, 0, 1.0), (4, 2, 0.9)}.

Each case replays the reference's draws — its ``_sample_round`` chain from
the run's initial key, which the scan draws round by round as the sync
schedule does, since the round counter is launch-aligned — through the
port's own loop (``run_rounds_async_on``), from one nonzero start state
(momentum, second moment, client states).  D + 1 launches overlap their
cohorts (N = 6, cohort 3), so a client's state row is read at launch and
read again at fold time after another cohort wrote it.  Params, momentum,
second moment and client states are held at ``RTOL`` after the loop and at
``ROUND_ATOL`` after the drain; the loop's metrics as well
(tests/_torch_parity.py).
"""
from functools import lru_cache

import pytest
import torch

from _torch_parity import RING_CASES, assert_ring_metrics, assert_ring_states, ring_parity

torch.set_num_threads(1)
ROUTE = "kernel"


@lru_cache(maxsize=None)
def _run(algo, depth, stale, gamma):
    kw = {"eta_g": 0.03} if algo == "fedadam" else {}
    return ring_parity(algo, depth, stale, gamma, ROUTE, **kw)


@pytest.mark.parametrize("algo, depth, stale, gamma", RING_CASES)
def test_ring_state_matches_reference(algo, depth, stale, gamma):
    assert_ring_states(_run(algo, depth, stale, gamma))


@pytest.mark.parametrize("algo, depth, stale, gamma", RING_CASES)
def test_ring_metrics_match_reference(algo, depth, stale, gamma):
    r = _run(algo, depth, stale, gamma)
    assert_ring_metrics(r)
    assert r["port"]["pending"] == depth - 1  # drain=False left the rest in flight
