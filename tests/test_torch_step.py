"""The slice as a whole: the port's round on the CPU equals
``dispersy_tpu.engine.step`` on every PeerState leaf and every stats
counter after every round (tolerance 0 -- every op of the round is
integer or elementwise float32 work, and every random choice is a counter
hash both packages compute alike).  The legacy ring and the byte-diet
store (staging, digest, cohort stagger, u16 aux and candidate stamps)
each have their cases."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dispersy_tpu import engine as jeng
from dispersy_tpu import metrics as jmetrics
from dispersy_tpu import state as jstate
from dispersy_tpu.config import CommunityConfig as JaxConfig
from dispersy_tpu.storediet import StoreConfig as JaxStore

from dispersy_tpu_torch import engine, init_state, metrics
from dispersy_tpu_torch.bridge import assert_states_equal, state_to_numpy
from dispersy_tpu_torch.config import CommunityConfig
from dispersy_tpu_torch.planes import StoreConfig
from dispersy_tpu_torch.storediet import phase_of

BASE = dict(n_peers=128, n_trackers=2, k_candidates=8, msg_capacity=32)
CASES = {
    "warm": (BASE, True),
    "cold": (BASE, False),
    "lossy_churn_modulo": (dict(BASE, packet_loss=0.1, churn_rate=0.02,
                                sync_strategy="modulo"), True),
}
ROUNDS = 20


def start(kw, warm, seed=5, store=None):
    jc, pc = JaxConfig(**kw), CommunityConfig(**kw)
    if store is not None:
        jc = jc.replace(store=JaxStore(**store))
        pc = pc.replace(store=StoreConfig(**store))
    js = jstate.init_state(jc, jax.random.PRNGKey(seed))
    ps = init_state(pc, seed, device="cpu")
    assert_states_equal(ps, js, "init_state")
    if warm:
        js = jeng.seed_overlay(js, jc, degree=6)
        ps = engine.seed_overlay(ps, pc, 6)
        assert_states_equal(ps, js, "seed_overlay")
    n = kw["n_peers"]
    authors = np.arange(n) % 16 == 3
    payload = (np.arange(n) * 7 + 11).astype(np.uint32)
    js = jeng.create_messages(js, jc, jnp.asarray(authors), 1,
                              jnp.asarray(payload))
    ps = engine.create_messages(ps, pc, torch.from_numpy(authors), 1,
                                torch.from_numpy(payload.astype(np.int64)))
    assert_states_equal(ps, js, "create_messages")
    return jc, pc, js, ps


@pytest.mark.parametrize("case", sorted(CASES))
def test_rounds_equal_jax_every_leaf(case):
    kw, warm = CASES[case]
    jc, pc, js, ps = start(kw, warm)
    for rnd in range(ROUNDS):
        js = jeng.step(js, jc)
        ps = engine.step(ps, pc)
        assert_states_equal(ps, js, f"{case}, round {rnd}")
    # The run did real work: records spread and walks succeeded.
    stats = state_to_numpy(ps)
    assert stats["stats.msgs_stored"].sum() > kw["n_peers"]
    assert stats["stats.walk_success"].sum() > 0
    assert float(engine.coverage(ps, 3, 2, 1, 3 * 7 + 11)) == float(
        jeng.coverage(js, 3, 2, 1, 3 * 7 + 11))


def test_multi_step_and_snapshot_match():
    jc, pc, js, ps = start(BASE, True, seed=9)
    js = jeng.multi_step(js, jc, 4)
    ps = engine.multi_step(ps, pc, 4)
    assert_states_equal(ps, js, "multi_step")
    same_snapshot(ps, pc, js, jc)


def same_snapshot(ps, pc, js, jc):
    want, got = jmetrics.snapshot(js, jc), metrics.snapshot(ps, pc)
    for key, val in got.items():
        if isinstance(val, float):
            # float32 means reduced in another order: a few ulps.
            assert val == pytest.approx(want[key], rel=1e-6), key
        else:
            assert val == want[key], key


# ---- the byte-diet round ---------------------------------------------------

BENCH_STORE = dict(staging=8, compact_every=12, aux_bits=16, cohorts=4,
                   cand_bits=16)
DIET_CASES = {  # (config, store, rounds)
    # profiling.bench_config's store at N = 128: two compaction windows.
    "bench_shaped": (BASE, BENCH_STORE, 26),
    "stagger_churn_loss": (dict(BASE, churn_rate=0.05, packet_loss=0.05),
                           dict(staging=8, compact_every=4, cohorts=4), 13),
    "cohorts1_churn_loss": (dict(BASE, churn_rate=0.02, packet_loss=0.05),
                            dict(staging=8, compact_every=4, aux_bits=16),
                            12),
}


@pytest.mark.parametrize("case", sorted(DIET_CASES))
def test_diet_rounds_equal_jax_every_leaf(case):
    kw, store, rounds = DIET_CASES[case]
    jc, pc, js, ps = start(kw, True, store=store)
    staged = False
    for rnd in range(rounds):
        js = jeng.step(js, jc)
        ps = engine.step(ps, pc)
        assert_states_equal(ps, js, f"{case}, round {rnd}")
        staged |= bool((ps.sta_gt.view(torch.int32) != -1).any())
    cov = float(engine.coverage(ps, 3, 2, 1, 3 * 7 + 11))
    assert cov == float(jeng.coverage(js, 3, 2, 1, 3 * 7 + 11))
    same_snapshot(ps, pc, js, jc)
    # The run did real work: records were staged and compacted into the
    # rings, the digests filled, walks succeeded.
    arrays = state_to_numpy(ps)
    assert staged
    assert arrays["stats.msgs_stored"].sum() > kw["n_peers"]
    assert arrays["digest"].any()
    assert arrays["stats.walk_success"].sum() > 0
    assert cov > 0.0


def test_diet_phase_argument_equals_cadence():
    """step(phase=phase_of(round)) is the default step, and multi_step
    follows the same cadence."""
    kw, store, _ = DIET_CASES["bench_shaped"]
    _, pc, _, ps = start(kw, True, store=store)
    a = b = ps
    for rnd in range(7):
        a = engine.step(a, pc)
        b = engine.step(b, pc, phase_of(pc, rnd))
        assert_states_equal(a, b, f"round {rnd}")
    assert_states_equal(engine.multi_step(ps, pc, 7), a, "multi_step")
    with pytest.raises(ValueError, match="phase"):
        engine.step(ps, pc, "compact")


@pytest.mark.parametrize("field", ["sync_enabled", "last_sync_history"])
def test_diet_off_slice_raises(field):
    """The diet without the sync exchange, and LastSync history, are not
    ported."""
    n_meta = CommunityConfig(**BASE).n_meta
    extra = ({"sync_enabled": False} if field == "sync_enabled" else
             {"last_sync_history": (2,) + (0,) * (n_meta - 1)})
    cfg = CommunityConfig(**BASE, **extra, store=StoreConfig(staging=4))
    st = init_state(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match=field):
        engine.step(st, cfg)


@pytest.mark.parametrize("field,value", [
    ("timeline_enabled", True),
    ("malicious_enabled", True),
    ("identity_enabled", True),
    ("p_symmetric", 0.25),
])
def test_off_slice_config_raises(field, value):
    cfg = CommunityConfig(**dict(BASE, **{field: value}))
    st = init_state(CommunityConfig(**BASE), 0, device="cpu")
    with pytest.raises(NotImplementedError, match=field):
        engine.step(st, cfg)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card refusal cannot show")
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(CommunityConfig(**BASE), 0)
