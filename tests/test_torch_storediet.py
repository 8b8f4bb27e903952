"""The byte-diet store's cadence helpers and the C = 1 identity.

The port's :mod:`dispersy_tpu_torch.storediet` against
``dispersy_tpu.storediet`` over a grid of ``(compact_every, cohorts,
round)``, as host ints and as u32 arrays (tolerance 0: integer work);
and, port only, a diet that compacts every round equal to the legacy
round on every shared leaf (the JAX package pins the same identity in
``tests/test_storediet.py``).
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dispersy_tpu import storediet as jdiet
from dispersy_tpu.config import CommunityConfig as JaxConfig
from dispersy_tpu.storediet import StoreConfig as JaxStore

from dispersy_tpu_torch import engine, init_state
from dispersy_tpu_torch import storediet as sdiet
from dispersy_tpu_torch.bridge import state_to_numpy
from dispersy_tpu_torch.config import CommunityConfig
from dispersy_tpu_torch.planes import StoreConfig

# One torch thread, as in test_torch_ops.
torch.set_num_threads(1)

from test_torch_ops import release_xla_executables  # noqa: E402,F401

GRID = [(c, k) for c, k in itertools.product((1, 4, 8, 12), (1, 2, 4))
        if c % k == 0]
ROUNDS = list(range(0, 40)) + [1000, 2 ** 31 + 7]
WRAP = [0xFFFFFFFF - j for j in range(0, 30, 3)]


def cfgs(c, k):
    kw = dict(n_peers=96, n_trackers=2)
    return (JaxConfig(**kw, store=JaxStore(staging=4, compact_every=c,
                                           cohorts=k)),
            CommunityConfig(**kw, store=StoreConfig(staging=4,
                                                    compact_every=c,
                                                    cohorts=k)))


@pytest.mark.parametrize("c,k", GRID)
def test_cadence_helpers_equal_jax(c, k):
    jc, pc = cfgs(c, k)
    assert sdiet.stagger_of(pc) == jdiet.stagger_of(jc)
    for coh in range(k):
        assert sdiet.cohort_phase(pc, coh) == jdiet.cohort_phase(jc, coh)
    for rnd in ROUNDS:
        assert sdiet.epoch_of(pc, rnd) == jdiet.epoch_of(jc, rnd)
        assert sdiet.sync_round_of(pc, rnd) == jdiet.sync_round_of(jc, rnd)
        assert sdiet.phase_of(pc, rnd) == jdiet.phase_of(jc, rnd)
        assert sdiet.active_cohort(pc, rnd) == jdiet.active_cohort(jc, rnd)
        for coh in range(k):
            assert (sdiet.epoch_of_cohort(pc, rnd, coh)
                    == jdiet.epoch_of_cohort(jc, rnd, coh))
    # Per-peer tensors, the way the engine calls them (u32 in JAX,
    # int64 carriers here), including rounds where the u32 sum wraps.
    idx = np.arange(96, dtype=np.uint32)
    assert np.array_equal(
        sdiet.cohort_of(pc, torch.from_numpy(idx.astype(np.int64))).numpy(),
        np.asarray(jdiet.cohort_of(jc, jnp.asarray(idx))))
    coh = idx % k
    for rnd in ROUNDS[:5] + WRAP:
        want = np.asarray(jdiet.epoch_of_cohort(jc, jnp.uint32(rnd),
                                                jnp.asarray(coh)))
        got = sdiet.epoch_of_cohort(pc, rnd, torch.from_numpy(
            coh.astype(np.int64)))
        assert np.array_equal(got.numpy(), want.astype(np.int64)), rnd
        a = sdiet.active_cohort(pc, rnd)
        assert a == int(jdiet.active_cohort(jc, jnp.uint32(rnd)))
        assert (sdiet.epoch_of_cohort(pc, rnd, a) == int(
            jdiet.epoch_of_cohort(jc, jnp.uint32(rnd), jnp.uint32(a))))


# ---- C = 1: the diet that compacts every round is the legacy round -------

# The JAX package's pin (tests/test_storediet.py): a pull-only chain with
# churn, loss and a create event.
C1_BASE = dict(n_peers=48, n_trackers=2, msg_capacity=24, bloom_capacity=16,
               k_candidates=8, request_inbox=4, tracker_inbox=8,
               response_budget=4, forward_fanout=0, churn_rate=0.02,
               packet_loss=0.05)


def _run(store, rounds, seed=7):
    cfg = CommunityConfig(**C1_BASE, store=store)
    s = init_state(cfg, seed, device="cpu")
    s = engine.seed_overlay(s, cfg, 4)
    n = cfg.n_peers
    s = engine.create_messages(s, cfg, torch.arange(n) % 6 == 5, 1,
                               torch.arange(n))
    out = []
    for _ in range(rounds):
        s = engine.step(s, cfg)
        out.append(state_to_numpy(s))
    return out


def test_compact_every_round_equals_legacy():
    rounds = 20
    legacy = _run(StoreConfig(), rounds)
    diet = _run(StoreConfig(staging=16, compact_every=1), rounds)
    shared = [k for k in legacy[0] if legacy[0][k].shape == diet[0][k].shape
              and not k.startswith("sta_")]
    assert "store_gt" in shared and "stats.msgs_stored" in shared
    for rnd, (a, b) in enumerate(zip(legacy, diet)):
        for k in shared:
            assert np.array_equal(a[k], b[k]), (rnd, k)
        # Every round compacts, so the staging buffer ends each round
        # empty.
        assert (b["sta_gt"] == 0xFFFFFFFF).all(), rnd
    assert legacy[-1]["stats.msgs_stored"].sum() > C1_BASE["n_peers"]
