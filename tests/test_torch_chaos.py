"""The chaos round: the fault, recovery, overload and parallel planes of
the port against the JAX package, bit for bit (tolerance 0: integer work
and float32 draws compared alike).

The ops of the planes (``ops/faults.py``, ``ops/overload.py``,
``ops/recovery.py``; the Bloom build against the JAX package's chunked
one) on numpy-seeded inputs; then every state leaf after every round of
``engine.step`` in the configs of the JAX package's own tests of these
planes (``tests/test_parallel.py``'s chaos config without its
telemetry, with ``tests/test_oracle.py``'s priority admission on its
capped exchange; ``tests/test_recovery.py``'s quarantining one with
partitions on uncapped shards) and the unsharded chaos round of
``profiling.chaos_config``; each case asserts that its planes engaged.
The JAX side runs the jitted ``step``: one compile per config, so each
case arms several planes.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import dispersy_tpu.config as jconfig
from dispersy_tpu import engine as jeng
from dispersy_tpu import faults as jfaults
from dispersy_tpu import metrics as jmetrics
from dispersy_tpu import overload as jovl
from dispersy_tpu import recovery as jrec
from dispersy_tpu import shardplane, storediet, telemetry, traceplane
from dispersy_tpu import state as jstate
from dispersy_tpu.ops import bloom as jbloom
from dispersy_tpu.ops import faults as jflt
from dispersy_tpu.ops import overload as jovo
from dispersy_tpu.ops import recovery as jrco
from dispersy_tpu.ops import store as jstore

from dispersy_tpu_torch import engine, init_state, metrics, profiling
from dispersy_tpu_torch import faults, overload, recovery
from dispersy_tpu_torch.bridge import assert_states_equal, state_to_numpy
from dispersy_tpu_torch.config import CommunityConfig
from dispersy_tpu_torch.ops import bloom, inbox
from dispersy_tpu_torch.ops import faults as flt
from dispersy_tpu_torch.ops import overload as ovo
from dispersy_tpu_torch.ops import recovery as rco
from dispersy_tpu_torch.ops import store as st
from dispersy_tpu_torch.planes import (FaultModel, OverloadConfig,
                                       ParallelConfig, RecoveryConfig,
                                       StoreConfig)

from test_torch_ops import same, to_np, to_t, u32
from test_torch_step import same_snapshot

_JAX_PLANES = {"StoreConfig": storediet.StoreConfig,
               "FaultModel": jfaults.FaultModel,
               "TelemetryConfig": telemetry.TelemetryConfig,
               "TraceConfig": traceplane.TraceConfig,
               "RecoveryConfig": jrec.RecoveryConfig,
               "OverloadConfig": jovl.OverloadConfig,
               "ParallelConfig": shardplane.ParallelConfig}


def to_jax(pc: CommunityConfig):
    """The JAX package's config with every field of a port config, the
    plane configs converted field by field."""
    kw = {}
    for f in dataclasses.fields(pc):
        v = getattr(pc, f.name)
        if dataclasses.is_dataclass(v):
            v = _JAX_PLANES[type(v).__name__](**{
                g.name: getattr(v, g.name) for g in dataclasses.fields(v)})
        kw[f.name] = v
    return jconfig.CommunityConfig(**kw)


def scalars(seed=0xC0FFEE, rnd=7):
    return (jnp.uint32(seed), jnp.uint32(rnd),
            torch.tensor(seed, dtype=torch.int64),
            torch.tensor(rnd, dtype=torch.int64))


# ---- the planes' ops ----------------------------------------------------------

def test_ge_advance_and_partition_blocked():
    rs = np.random.default_rng(1)
    n = 500
    ge = rs.random(n) < 0.4
    js, jr, ps, pr = scalars()
    want = jflt.ge_advance(jnp.asarray(ge), js, jr,
                           jnp.arange(n, dtype=jnp.int32), 0.05, 0.3)
    got = flt.ge_advance(to_t(ge), ps, pr, torch.arange(n), 0.05, 0.3)
    same([got], [want])
    assert to_np(got).any() and not to_np(got).all()
    parts = (((2, 12), (22, 32)), ((40, 50), (0, 3)))
    src = rs.integers(-1, 60, size=(30, 7)).astype(np.int32)
    dst = rs.integers(-1, 60, size=(30, 7)).astype(np.int32)
    for p in (parts, ()):
        want = jflt.partition_blocked(jnp.asarray(src), jnp.asarray(dst), p)
        got = flt.partition_blocked(to_t(src), to_t(dst), p)
        same([got], [want])
    assert to_np(flt.partition_blocked(to_t(src), to_t(dst), parts)).any()


def test_popcount_and_store_invariant():
    rs = np.random.default_rng(2)
    x = u32(rs, 40, 15)
    same([flt.popcount_u32(to_t(x)).numpy().astype(np.uint32)],
         [jflt.popcount_u32(jnp.asarray(x))])
    gt = np.sort(u32(rs, 50, 12, hi=40), axis=1)
    gt[:, 9:] = 0xFFFFFFFF
    member = u32(rs, 50, 12, hi=3)
    gt[5, 2], gt[9, 10] = gt[5, 1], 3          # a tie and a live row after a hole
    want = jflt.store_invariant_violated(jnp.asarray(gt), jnp.asarray(member))
    got = flt.store_invariant_violated(to_t(gt), to_t(member))
    same([got], [want])
    assert to_np(got).any() and not to_np(got).all()


def test_admission_class_and_buckets():
    rs = np.random.default_rng(3)
    meta = rs.integers(0, 256, size=600).astype(np.uint8)
    meta[:40] = np.arange(0xF0, 0xF8).repeat(5)        # the control band
    prio = (200, 128, 7)
    want = jovo.admission_class(jnp.asarray(meta), 3, prio)
    got = ovo.admission_class(to_t(meta), 3, prio)
    same([got.numpy().astype(np.uint32)], [want])
    assert [overload.admission_class(int(m), 3, prio) for m in meta[:80]] \
        == [jovl.admission_class(int(m), 3, prio) for m in meta[:80]]
    n = 300
    bucket = rs.integers(0, 33, size=n).astype(np.uint8)
    js, jr, ps, pr = scalars()
    for rate, depth in ((2.5, 8), (8.0, 32), (0.3, 1)):
        want = jovo.bucket_refill(jnp.asarray(bucket), js, jr,
                                  jnp.arange(n, dtype=jnp.int32), rate, depth)
        got = ovo.bucket_refill(to_t(bucket), ps, pr, torch.arange(n), rate,
                                depth)
        same([got.numpy().astype(np.uint32)], [want])
        att = rs.integers(0, 40, size=n).astype(np.uint32)
        same([ovo.bucket_spend(got, to_t(att).to(torch.int64))],
             [jovo.bucket_spend(want, jnp.asarray(att))])


def test_store_repair_and_gates():
    rs = np.random.default_rng(4)
    n, m = 40, 16
    gt = u32(rs, n, m, hi=30)
    gt[rs.random((n, m)) < 0.2] = 0xFFFFFFFF
    cols = dict(gt=gt, member=u32(rs, n, m, hi=4),
                meta=rs.integers(0, 3, size=(n, m)).astype(np.uint8),
                payload=u32(rs, n, m, hi=5), aux=u32(rs, n, m),
                flags=rs.integers(0, 2, size=(n, m)).astype(np.uint8))
    for c in cols.values():                     # whole-record duplicates
        c[:, 5] = c[:, 2]
    mask = rs.random(n) < 0.6
    want = jrco.store_repair(jstore.StoreCols(
        **{k: jnp.asarray(v) for k, v in cols.items()}), jnp.asarray(mask))
    got = rco.store_repair(st.StoreCols(
        **{k: to_t(v) for k, v in cols.items()}), to_t(mask))
    same(got, want)
    backoff = rs.integers(0, 7, size=n).astype(np.uint8)
    quar = u32(rs, n, hi=20)
    for rnd in (0, 5, 8, 12, 64):
        same([rco.backoff_gate(torch.tensor(rnd), to_t(backoff))],
             [jrco.backoff_gate(jnp.uint32(rnd), jnp.asarray(backoff))])
        same([rco.quarantine_active(torch.tensor(rnd), to_t(quar))],
             [jrco.quarantine_active(jnp.uint32(rnd), jnp.asarray(quar))])


@pytest.mark.parametrize("chunks", [2, 3, 8])
def test_bloom_build_chunks_keep_the_bits(chunks):
    """``parallel.scatter_chunks`` cannot change the bits: the port's one
    build equals the JAX package's chunked ``bloom_build_from``, with one
    salt or one salt per row."""
    rs = np.random.default_rng(chunks)
    n, m, w, k = 37, 48, 15, 7
    hashes, mask = u32(rs, n, m), rs.random((n, m)) < 0.6
    for salt in (np.uint32(9), u32(rs, n)):
        ps = to_t(np.asarray(salt, np.uint32)).reshape(np.shape(salt))
        got = bloom.bloom_build(to_t(hashes), to_t(mask), 32 * w, k, ps)
        want = jbloom.bloom_build_from(
            jbloom.probe_bits(jnp.asarray(hashes), 32 * w, k,
                              salt=jnp.asarray(salt).reshape(
                                  (-1, 1) if np.ndim(salt) else ())),
            jnp.asarray(mask), 32 * w, chunks=chunks)
        same([got], [want])


# ---- the round ------------------------------------------------------------------

ORACLE_BASE = dict(n_peers=32, n_trackers=2, msg_capacity=32,
                   bloom_capacity=16, k_candidates=8, request_inbox=4,
                   tracker_inbox=8, response_budget=4)
# tests/test_recovery.py's CHAOS partitions and its recovery knobs.
PARTITIONS = (((2, 12), (22, 32)),)
RECOV = RecoveryConfig(enabled=True, backoff_limit=3, backoff_decay=0.5,
                       quarantine_rounds=5, requarantine_window=4)

# name: (config, rounds, seed).  Each case arms several planes at once,
# since each config costs one JAX step compile.
CASES = {
    # tests/test_parallel.py's _chaos_cfg without its telemetry -- the GE
    # channel, flooders and health on the diet store, 8 capped shards --
    # with tests/test_oracle.py's priority admission (:172-177) on the
    # capped exchange (:158-161).  A push inbox of 1 and buckets of rate
    # 4, depth 8 make the priority and rate sheds engage beside the cap.
    "chaos_diet": (CommunityConfig(
        n_peers=64, n_trackers=2, k_candidates=8, msg_capacity=32,
        bloom_capacity=16, request_inbox=4, tracker_inbox=16,
        response_budget=4, churn_rate=0.05, packet_loss=0.1,
        forward_fanout=2, forward_buffer=2, push_inbox=1,
        faults=FaultModel(ge_p_bad=0.3, ge_p_good=0.4, ge_loss_bad=0.9,
                          ge_loss_good=0.02, flood_senders=(3, 5),
                          flood_fanout=6, health_checks=True),
        overload=OverloadConfig(enabled=True, bucket_rate=4.0,
                                bucket_depth=8),
        store=StoreConfig(staging=8, compact_every=4, aux_bits=16),
        parallel=ParallelConfig(shards=8, cross_shard_budget=2)), 12, 7),
    # tests/test_recovery.py::test_all_recovery_stages_trace without its
    # telemetry, plus the CHAOS mix's partitions, on 4 uncapped shards
    # (tests/test_oracle.py:187-190, where the shards do not show): soft
    # repairs, backoff bumps, quarantines and severed edges.
    "quarantine": (CommunityConfig(
        **dict(ORACLE_BASE, bloom_capacity=4), push_inbox=2,
        packet_loss=0.05, churn_rate=0.03,
        faults=FaultModel(flood_senders=(5, 9), flood_fanout=24,
                          partitions=PARTITIONS, dup_rate=0.2,
                          corrupt_rate=0.1, health_checks=True,
                          health_drop_limit=2), recovery=RECOV,
        parallel=ParallelConfig(shards=4)), 12, 1),
    # The chaos round unsharded (profiling.chaos_config(256, shards=0)):
    # K1 takes the admission classes.
    "chaos_unsharded": (profiling.chaos_config(256, shards=0), 12, 5),
}
SLOW_CASES = {
    # The tentpole config itself at 256 peers, budget 4: slow to compile.
    "chaos_sharded": (profiling.chaos_config(256, shards=8, budget=4), 12, 5),
}


def run_pair(pc, rounds, seed, spies=None):
    """Both packages through ``rounds`` rounds (every 16th peer authors
    one record first), every leaf held equal after each round.  Returns
    the port's state and the largest health OR seen."""
    jc = to_jax(pc)
    js = jstate.init_state(jc, jax.random.PRNGKey(seed))
    ps = init_state(pc, seed, device="cpu")
    assert_states_equal(ps, js, "init_state")
    js = jeng.seed_overlay(js, jc, degree=4)
    ps = engine.seed_overlay(ps, pc, 4)
    n = pc.n_peers
    authors = np.arange(n) % 16 == 5
    payload = (np.arange(n) * 7 + 11).astype(np.uint32)
    js = jeng.create_messages_jit(js, jc, jnp.asarray(authors), 1,
                                  jnp.asarray(payload))
    ps = engine.create_messages(ps, pc, torch.from_numpy(authors), 1,
                                torch.from_numpy(payload.astype(np.int64)))
    assert_states_equal(ps, js, "create_messages")
    flagged = ge_seen = 0
    for rnd in range(rounds):
        js = jeng.step(js, jc)
        ps = engine.step(ps, pc)
        assert_states_equal(ps, js, f"round {rnd}")
        flagged = max(flagged, int((state_to_numpy(ps)["health"] != 0).sum()))
        ge_seen += int(ps.ge_bad.sum())
    same_snapshot(ps, pc, js, jc)
    return ps, flagged, ge_seen


def total(ps, name):
    return int(state_to_numpy(ps)[f"stats.{name}"].astype(np.uint64).sum())


@pytest.fixture
def spies(monkeypatch):
    """Counts of the port's ragged and class-ordered deliveries and of
    the edges a partition severed."""
    counts = {"ragged": 0, "cls": 0, "severed": 0}
    real_ragged, real_deliver = inbox.deliver_ragged, inbox.deliver
    real_blocked = flt.partition_blocked

    def ragged(*a, **kw):
        counts["ragged"] += 1
        return real_ragged(*a, **kw)

    def deliver(*a, **kw):
        counts["cls"] += (kw.get("cls") if "cls" in kw else
                          (a[5] if len(a) > 5 else None)) is not None
        return real_deliver(*a, **kw)

    def blocked(*a, **kw):
        out = real_blocked(*a, **kw)
        counts["severed"] += int(out.sum())
        return out
    monkeypatch.setattr(inbox, "deliver_ragged", ragged)
    monkeypatch.setattr(inbox, "deliver", deliver)
    monkeypatch.setattr(flt, "partition_blocked", blocked)
    return counts


def check_engaged(case, ps, flagged, ge_seen, counts):
    shed = total(ps, "xshard_shed")
    if case in ("chaos_diet", "chaos_sharded"):
        assert shed > 0, "the cross-shard budget never bound"
        assert counts["ragged"] > 0
    if case == "chaos_diet":
        assert total(ps, "msgs_shed_priority") > 0
        assert total(ps, "msgs_shed_rate") > 0
    if case == "chaos_unsharded":
        assert total(ps, "msgs_shed_priority") + total(
            ps, "msgs_shed_rate") > 0
    if case in ("chaos_diet", "chaos_unsharded", "chaos_sharded"):
        assert ge_seen > 0, "no Gilbert–Elliott channel went bad"
        assert total(ps, "msgs_corrupt_dropped") > 0
    if case == "quarantine":
        # Every full-population channel rode the exchange, and nothing
        # sheds (the leaf is zero-width without a budget).
        assert counts["ragged"] >= 3 * CASES[case][1]
        assert ps.stats.xshard_shed.numel() == 0
        assert flagged > 0, "no health sentinel latched"
        assert counts["severed"] > 0
        for name in ("recov_soft", "recov_backoff", "recov_quarantine"):
            assert total(ps, name) > 0, name
    if case == "chaos_unsharded":
        assert counts["cls"] > 0 and counts["ragged"] == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_chaos_rounds_equal_jax_every_leaf(case, spies):
    pc, rounds, seed = CASES[case]
    ps, flagged, ge_seen = run_pair(pc, rounds, seed)
    check_engaged(case, ps, flagged, ge_seen, spies)


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(SLOW_CASES))
def test_chaos_sharded_equals_jax_every_leaf(case, spies):
    pc, rounds, seed = SLOW_CASES[case]
    ps, flagged, ge_seen = run_pair(pc, rounds, seed)
    check_engaged(case, ps, flagged, ge_seen, spies)


# ---- the host-side reports --------------------------------------------------------

def test_plane_reports_equal_jax():
    """``faults.health_report`` / ``debug_validate`` /
    ``enablement_signature``, ``overload.overload_report`` and
    ``recovery.recovery_report`` on the same state in both packages."""
    pc = CASES["quarantine"][0]
    jc = to_jax(pc)
    rs = np.random.default_rng(9)
    ps = init_state(pc, 1, device="cpu")
    n = pc.n_peers
    health = rs.integers(0, 16, size=n).astype(np.uint32)
    backoff = rs.integers(0, 4, size=n).astype(np.uint8)
    quar = rs.integers(0, 6, size=n).astype(np.uint32)
    ps = ps.replace(health=to_t(health), backoff=to_t(backoff),
                    quar_until=to_t(quar))
    js = jstate.init_state(jc, jax.random.PRNGKey(1)).replace(
        health=jnp.asarray(health), backoff=jnp.asarray(backoff),
        quar_until=jnp.asarray(quar))
    assert faults.health_report(ps, pc) == jfaults.health_report(js, jc)
    assert recovery.recovery_report(ps, pc) == jrec.recovery_report(js, jc)
    assert faults.enablement_signature(pc) == \
        jfaults.enablement_signature(jc)
    assert faults.debug_validate(ps, pc) == jfaults.debug_validate(js, jc)
    bad = ps.replace(store_gt=to_t(np.full((n, pc.msg_capacity), 5,
                                           np.uint32)))
    assert faults.debug_validate(bad, pc)
    with pytest.raises(AssertionError, match="debug_validate"):
        faults.debug_validate(bad, pc, raise_on_error=True)
    oc = CASES["chaos_diet"][0]
    ps = init_state(oc, 1, device="cpu")
    js = jstate.init_state(to_jax(oc), jax.random.PRNGKey(1))
    bucket = rs.integers(0, 5, size=oc.n_peers).astype(np.uint8)
    shed = u32(rs, oc.n_peers, hi=9)
    ps = ps.replace(bucket=to_t(bucket), stats=ps.stats.replace(
        msgs_shed_rate=to_t(shed)))
    js = js.replace(bucket=jnp.asarray(bucket), stats=js.stats.replace(
        msgs_shed_rate=jnp.asarray(shed)))
    assert overload.overload_report(ps, oc) == jovl.overload_report(
        js, to_jax(oc))
    same_snapshot(ps, oc, js, to_jax(oc))
