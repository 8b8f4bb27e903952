"""The slice as a whole: the port's round on the CPU equals
``dispersy_tpu.engine.step`` on every PeerState leaf and every stats
counter after every round (tolerance 0 -- every op of the round is
integer or elementwise float32 work, and every random choice is a counter
hash both packages compute alike).  The legacy ring, the byte-diet
store (staging, digest, cohort stagger, u16 aux and candidate stamps)
and the permissioned community (the Timeline, driven by
``profiling.permissioned_schedule``) each have their cases."""

import dataclasses

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
from dispersy_tpu_torch import profiling
from dispersy_tpu_torch.bridge import first_difference
from dispersy_tpu_torch.config import META_DYNAMIC
from dispersy_tpu_torch.planes import StoreConfig
from dispersy_tpu_torch.storediet import phase_of

from test_torch_ops import ref, release_xla_executables  # noqa: F401

# One torch thread, as in test_torch_ops.
torch.set_num_threads(1)

BASE = dict(n_peers=128, n_trackers=2, k_candidates=8, msg_capacity=32)
CASES = {
    "warm": (BASE, True),
    "cold": (BASE, False),
    # With tests/test_nat.py's symmetric-NAT share: the introduction
    # filters and the puncture gate.
    "lossy_churn_modulo": (dict(BASE, packet_loss=0.1, churn_rate=0.02,
                                sync_strategy="modulo", p_symmetric=0.3),
                           True),
}
ROUNDS = 20


def start(kw, warm, seed=5, store=None):
    jc, pc = JaxConfig(**kw), CommunityConfig(**kw)
    if store is not None:
        jc = jc.replace(store=JaxStore(**store))
        pc = pc.replace(store=StoreConfig(**store))
    js = ref(jstate.init_state, jc, jax.random.PRNGKey(seed))
    ps = init_state(pc, seed, device="cpu")
    assert_states_equal(ps, js, "init_state")
    if warm:
        js = ref(jeng.seed_overlay, js, jc, degree=6)
        ps = engine.seed_overlay(ps, pc, 6)
        assert_states_equal(ps, js, "seed_overlay")
    n = kw["n_peers"]
    authors = np.arange(n) % 16 == 3
    payload = (np.arange(n) * 7 + 11).astype(np.uint32)
    js = ref(jeng.create_messages, js, jc, authors, 1, payload)
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
    # The diet without the sync exchange (one cohort: the JAX package
    # refuses more without sync): no digest, freshness the exact test
    # against ring and staging, records spread by push alone.
    "syncless_churn_loss": (dict(BASE, churn_rate=0.02, packet_loss=0.05,
                                 sync_enabled=False),
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
    # rings, the digests filled (there is none without sync), walks
    # succeeded.
    arrays = state_to_numpy(ps)
    assert staged
    assert arrays["stats.msgs_stored"].sum() > kw["n_peers"]
    if kw.get("sync_enabled", True):
        assert arrays["digest"].any()
    else:
        assert arrays["digest"].size == 0
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


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card refusal cannot show")
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(CommunityConfig(**BASE), 0)


# ---- the permissioned community (the Timeline) ------------------------------

def jax_config(pc):
    """The JAX package's CommunityConfig with a port config's fields (the
    plane configs at their defaults)."""
    return JaxConfig(**{f.name: getattr(pc, f.name)
                        for f in dataclasses.fields(pc)
                        if not dataclasses.is_dataclass(getattr(pc, f.name))})


def run_both(pc, rounds, creates, seed=5, degree=6, store=None):
    """Drive both packages through ``rounds`` rounds with the schedule's
    creates and plants; returns (JAX config, port config, JAX state, port
    state, the first leaf difference after each round's creates and
    after each round, or None)."""
    jc = jax_config(pc)
    if store is not None:
        jc = jc.replace(store=JaxStore(**store))
        pc = pc.replace(store=StoreConfig(**store))
    js = ref(lambda key: jeng.seed_overlay(jstate.init_state(jc, key), jc,
                                           degree=degree),
             jax.random.PRNGKey(seed))
    ps = engine.seed_overlay(init_state(pc, seed, device="cpu"), pc, degree)

    def rows(ids):
        return tuple(np.asarray(getattr(js, k))[ids]
                     for k in ("store_gt", "store_member", "store_meta"))
    diffs = []
    for rnd in range(rounds):
        for c in creates:
            if c.round != rnd:
                continue
            if isinstance(c, profiling.Plant):
                cols = {k: np.asarray(getattr(js, f"fwd_{k}"))
                        for k in profiling.FWD_COLS}
                new = profiling.plant_fwd(cols, c)
                js = js.replace(**{f"fwd_{k}": jnp.asarray(
                    new[k].astype(cols[k].dtype)) for k in cols})
                continue
            aux = (c.aux if c.aux is not None
                   else profiling.pin_gt(c.payload, c.authors, rows))
            # The jitted form compiles once per (config, meta).
            js = jeng.create_messages_jit(js, jc, jnp.asarray(c.authors),
                                          c.meta, jnp.asarray(c.payload),
                                          jnp.asarray(aux))
        ps = profiling.run_creates(ps, pc, creates, rnd)
        diffs.append((f"round {rnd} creates", first_difference(
            state_to_numpy(ps), state_to_numpy(js))))
        js, ps = jeng.step(js, jc), engine.step(ps, pc)
        diffs.append((f"round {rnd}", first_difference(
            state_to_numpy(ps), state_to_numpy(js))))
    return jc, pc, js, ps, diffs


PERM_N, PERM_ROUNDS = 256, 20
PERM_CASES = {"permissioned": {},
              "permissioned_lossy_churn": dict(packet_loss=0.1,
                                               churn_rate=0.02)}


@pytest.mark.parametrize("case", sorted(PERM_CASES))
def test_permissioned_rounds_equal_jax_every_leaf(case):
    """The schedule's creates and rounds (the destroy included) leave the
    port equal to the JAX package on every leaf and counter, and
    metrics.snapshot (``killed`` included) equal to the JAX package's once
    the destroy has spread.  On the clean case each feature of the
    schedule really happens in the JAX run (:func:`assert_features`)."""
    pc = profiling.permissioned_config(PERM_N).replace(**PERM_CASES[case])
    jc, pc, js, ps, diffs = run_both(
        pc, PERM_ROUNDS, profiling.permissioned_schedule(PERM_N))
    bad = [(where, d) for where, d in diffs if d is not None]
    assert not bad, f"{case}: {bad[0]}"
    same_snapshot(ps, pc, js, jc)
    assert metrics.snapshot(ps, pc)["killed"] > 1
    if case == "permissioned":
        assert_features(js)


def assert_features(js):
    """A delegated grant folded, a pin is stored away from its author,
    the revoke unwound rows and removed records, an undo marked, a flip
    let a non-granted member pin, LastSync evicted, the destroy killed."""
    a = {k: np.asarray(getattr(js, k)) for k in (
        "auth_member", "auth_issuer", "store_meta", "store_member",
        "store_flags", "store_payload")}
    roles = profiling.permissioned_roles(PERM_N)
    f, mods, dels = roles["founder"], roles["mods"], roles["delegates"]
    live = a["auth_member"] != 0xFFFFFFFF
    assert (live & np.isin(a["auth_issuer"], mods)).any()     # delegated
    rows = np.arange(PERM_N)[:, None]
    pins = a["store_meta"] == profiling.PIN
    assert (pins & (a["store_member"] != rows)).any()         # spread
    assert int(np.asarray(js.stats.auth_unwound).sum()) > 0
    assert int(np.asarray(js.stats.msgs_retro).sum()) > 0
    assert ((a["store_flags"] & 1) == 1).any()                # undone
    assert ((a["store_meta"] == META_DYNAMIC).sum(1) > 0)[
        np.arange(PERM_N) != f].any()
    granted = np.concatenate([[f], mods, dels])
    assert (pins & ~np.isin(a["store_member"], granted)).any()  # public
    # keep-last-1: peer 64 wrote two profiles and keeps the second; no
    # store holds two profiles of one member
    prof = a["store_meta"] == profiling.PROFILE
    own = prof[64] & (a["store_member"][64] == 64)
    assert a["store_payload"][64][own].tolist() == [64 + 2]
    for r in range(PERM_N):
        authors = a["store_member"][r][prof[r]]
        assert len(authors) == len(set(authors.tolist()))
    assert int((a["store_meta"] == 0xF5).any(1).sum()) > 1    # killed


def test_permissioned_config_is_the_forum_compile():
    """permissioned_config equals, field for field, what the JAX
    Community compiles from examples/forum.py's three declarations at the
    slice's widths."""
    from dispersy_tpu.community import (Community, CommunityDestination,
                                        DynamicResolution,
                                        FullSyncDistribution,
                                        LastSyncDistribution,
                                        LinearResolution,
                                        MemberAuthentication, Message,
                                        PublicResolution)

    class Forum(Community):
        def initiate_meta_messages(self):
            return [
                Message("post", MemberAuthentication(), PublicResolution(),
                        FullSyncDistribution(synchronization_direction="ASC"),
                        CommunityDestination(node_count=3)),
                Message("pin", MemberAuthentication(),
                        DynamicResolution(LinearResolution(),
                                          PublicResolution()),
                        FullSyncDistribution(),
                        CommunityDestination(node_count=3)),
                Message("profile", MemberAuthentication(),
                        PublicResolution(),
                        LastSyncDistribution(history_size=1),
                        CommunityDestination(node_count=3))]

    pc = profiling.permissioned_config(256)
    sc = profiling.slice_config(256)
    compiled = {"n_meta", "protected_meta_mask", "seq_meta_mask",
                "direct_meta_mask", "desc_meta_mask", "last_sync_history",
                "meta_priority", "dynamic_meta_mask", "timeline_enabled",
                "forward_fanout", "n_peers"}
    widths = {f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)
              if f.name not in compiled
              and not dataclasses.is_dataclass(getattr(sc, f.name))
              and getattr(sc, f.name) != getattr(CommunityConfig(n_peers=256),
                                                 f.name)}
    jc = Forum(n_peers=256, k_authorized=8, **widths).config
    for f in dataclasses.fields(pc):
        if not dataclasses.is_dataclass(getattr(pc, f.name)):
            assert getattr(pc, f.name) == getattr(jc, f.name), f.name


def test_hardened_config_is_the_debug_community_compile():
    """hardened_config equals, field for field, what the JAX Community
    compiles from the full-sync-text and sequence-text declarations of
    Dispersy's test community at the slice's widths, with the identity
    gate and double-sign conviction with gossip on."""
    from dispersy_tpu.community import (Community, CommunityDestination,
                                        FullSyncDistribution,
                                        MemberAuthentication, Message,
                                        PublicResolution)

    class Debug(Community):
        def initiate_meta_messages(self):
            return [
                Message("full-sync-text", MemberAuthentication(),
                        PublicResolution(), FullSyncDistribution(),
                        CommunityDestination(node_count=3)),
                Message("sequence-text", MemberAuthentication(),
                        PublicResolution(),
                        FullSyncDistribution(enable_sequence_number=True),
                        CommunityDestination(node_count=3))]

    hc = profiling.hardened_config(256)
    sc = profiling.slice_config(256)
    compiled = {"n_meta", "protected_meta_mask", "seq_meta_mask",
                "direct_meta_mask", "desc_meta_mask", "last_sync_history",
                "meta_priority", "dynamic_meta_mask", "timeline_enabled",
                "forward_fanout", "n_peers"}
    widths = {f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)
              if f.name not in compiled
              and not dataclasses.is_dataclass(getattr(sc, f.name))
              and getattr(sc, f.name) != getattr(CommunityConfig(n_peers=256),
                                                 f.name)}
    jc = Debug(n_peers=256, identity_enabled=True, identity_required=True,
               malicious_enabled=True, k_malicious=8, malicious_gossip=True,
               **widths).config
    for f in dataclasses.fields(hc):
        if not dataclasses.is_dataclass(getattr(hc, f.name)):
            assert getattr(hc, f.name) == getattr(jc, f.name), f.name


# ---- LastSync under the diet; meta priorities and DESC sync -----------------

def creates_on(metas, rounds, n, every=16):
    """Create calls of every ``every``-th peer on each meta at each round."""
    idx = np.arange(n)
    return [profiling.Create(r, m, idx % every == (3 + m) % every,
                             (idx * 7 + 11 + 1000 * r).astype(np.uint32),
                             np.zeros(n, np.uint32))
            for r in rounds for m in metas]


ORDER_CASES = {  # (config, store, rounds): two compaction windows each
    "diet_lastsync": (dict(BASE, n_meta=3, last_sync_history=(0, 2, 1)),
                      BENCH_STORE, 24),
    "priority_desc_diet": (dict(BASE, n_meta=3, meta_priority=(64, 200, 128),
                                desc_meta_mask=0b101),
                           dict(staging=8, compact_every=4, cohorts=4), 24),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES))
def test_lastsync_and_priority_rounds_equal_jax_every_leaf(case):
    """LastSync keep-last-k on the byte-diet store (evictions in the
    create's ring insert and at compaction), and per-meta priorities
    with DESC sync on the staggered store (the block serve's ordered view
    and the priority forward rank; the legacy responder's ordered view
    runs in every permissioned case), every leaf every round."""
    kw, store, rounds = ORDER_CASES[case]
    creates = creates_on((0, 1, 2), (0, 2, 5, 7), kw["n_peers"])
    _, _, js, ps, diffs = run_both(CommunityConfig(**kw), rounds, creates,
                                   store=store)
    bad = [(where, d) for where, d in diffs if d is not None]
    assert not bad, f"{case}: {bad[0]}"
    stored = int(np.asarray(js.stats.msgs_stored).sum())
    assert stored > kw["n_peers"]
    if "lastsync" in case:
        # Each author's own store keeps its newest profile (meta 2,
        # keep-last-1) and its two newest pins (meta 1, keep-last-2).
        meta, member, payload = (np.asarray(getattr(js, k)) for k in (
            "store_meta", "store_member", "store_payload"))
        for c in creates:
            r = np.flatnonzero(c.authors)[0]
            own = (member[r] == r) & (meta[r] == c.meta)
            assert own.sum() == {0: 4, 1: 2, 2: 1}[c.meta]
            if c.meta == 2:
                assert payload[r][own][0] == r * 7 + 11 + 7000
