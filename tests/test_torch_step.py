"""The slice as a whole: the port's round on the CPU equals
``dispersy_tpu.engine.step`` on every PeerState leaf and every stats
counter after every round (tolerance 0 -- every op of the round is
integer or elementwise float32 work, and every random choice is a counter
hash both packages compute alike)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dispersy_tpu import engine as jeng
from dispersy_tpu import state as jstate
from dispersy_tpu.config import CommunityConfig as JaxConfig

from dispersy_tpu_torch import engine, init_state, metrics
from dispersy_tpu_torch.bridge import assert_states_equal, state_to_numpy
from dispersy_tpu_torch.config import CommunityConfig

BASE = dict(n_peers=128, n_trackers=2, k_candidates=8, msg_capacity=32)
CASES = {
    "warm": (BASE, True),
    "cold": (BASE, False),
    "lossy_churn_modulo": (dict(BASE, packet_loss=0.1, churn_rate=0.02,
                                sync_strategy="modulo"), True),
}
ROUNDS = 20


def start(kw, warm, seed=5):
    jc, pc = JaxConfig(**kw), CommunityConfig(**kw)
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
    from dispersy_tpu import metrics as jmetrics
    want, got = jmetrics.snapshot(js, jc), metrics.snapshot(ps, pc)
    for key, val in got.items():
        if isinstance(val, float):
            # float32 means reduced in another order: a few ulps.
            assert val == pytest.approx(want[key], rel=1e-6), key
        else:
            assert val == want[key], key


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
