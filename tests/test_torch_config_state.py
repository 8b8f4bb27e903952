"""The port's configs and state against the JAX package's: the same fields,
defaults, derived properties and validation; ``init_state`` equal leaf for
leaf; the numpy bridge round-trips."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import dispersy_tpu.config as jconfig
from dispersy_tpu import faults, overload, recovery, shardplane, storediet
from dispersy_tpu import profiling as jprofiling
from dispersy_tpu import state as jstate
from dispersy_tpu import telemetry, traceplane
from dispersy_tpu.exceptions import ConfigError as JaxConfigError

import dispersy_tpu_torch.config as pconfig
from dispersy_tpu_torch import planes, profiling
from dispersy_tpu_torch.bridge import (assert_states_equal, state_from_numpy,
                                       state_to_numpy)
from dispersy_tpu_torch.exceptions import ConfigError
from dispersy_tpu_torch.state import init_state

# One torch thread, as in test_torch_ops.
torch.set_num_threads(1)

from test_torch_ops import release_xla_executables  # noqa: E402,F401

PAIRS = [
    (jconfig.CommunityConfig, pconfig.CommunityConfig),
    (storediet.StoreConfig, planes.StoreConfig),
    (faults.FaultModel, planes.FaultModel),
    (telemetry.TelemetryConfig, planes.TelemetryConfig),
    (traceplane.TraceConfig, planes.TraceConfig),
    (recovery.RecoveryConfig, planes.RecoveryConfig),
    (overload.OverloadConfig, planes.OverloadConfig),
    (shardplane.ParallelConfig, planes.ParallelConfig),
]

# Configs whose derived properties are compared (CommunityConfig kwargs;
# plane configs are converted field by field).
CONFIGS = [
    {},
    dict(n_peers=128, n_trackers=2, k_candidates=8, msg_capacity=32),
    dict(n_peers=64, n_trackers=1, sync_strategy="modulo",
         packet_loss=0.2, churn_rate=0.05, bloom_capacity=40,
         bloom_error_rate=0.05),
    dict(n_peers=64, n_trackers=2, timeline_enabled=True, n_meta=4,
         protected_meta_mask=0b10, delay_inbox=3),
    dict(n_peers=64, n_trackers=2, store=dict(staging=8, compact_every=12,
                                              aux_bits=16, cohorts=4,
                                              cand_bits=16)),
]

BAD = [
    dict(n_peers=0),
    dict(n_peers=8, n_trackers=9),
    dict(p_revisit_walked=0.9),
    dict(delay_inbox=2),
    dict(forward_fanout=99),
    dict(store=dict(aux_bits=16)),
    dict(store=dict(cohorts=3, staging=4, compact_every=8)),
    dict(faults=dict(dup_rate=2.0)),
    dict(telemetry=dict(history=4)),
    dict(recovery=dict(backoff_limit=99)),
    dict(overload=dict(bucket_depth=0)),
    dict(parallel=dict(cross_shard_budget=4)),
]

PLANE_ARGS = {"store": (storediet.StoreConfig, planes.StoreConfig),
              "faults": (faults.FaultModel, planes.FaultModel),
              "telemetry": (telemetry.TelemetryConfig,
                            planes.TelemetryConfig),
              "trace": (traceplane.TraceConfig, planes.TraceConfig),
              "recovery": (recovery.RecoveryConfig, planes.RecoveryConfig),
              "overload": (overload.OverloadConfig, planes.OverloadConfig),
              "parallel": (shardplane.ParallelConfig,
                           planes.ParallelConfig)}


def build(kw):
    """The same config in both packages."""
    jkw, pkw = dict(kw), dict(kw)
    for name, (jcls, pcls) in PLANE_ARGS.items():
        if name in kw:
            jkw[name], pkw[name] = jcls(**kw[name]), pcls(**kw[name])
    return jconfig.CommunityConfig(**jkw), pconfig.CommunityConfig(**pkw)


def properties(cls):
    return sorted(n for n, v in vars(cls).items() if isinstance(v, property))


@pytest.mark.parametrize("jcls,pcls", PAIRS, ids=[p[1].__name__
                                                  for p in PAIRS])
def test_fields_defaults_properties(jcls, pcls):
    jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
    pf = [(f.name, f.default) for f in dataclasses.fields(pcls)]
    # Plane-config defaults are instances of the two packages' own
    # classes: compare those through their fields.
    assert [n for n, _ in pf] == [n for n, _ in jf]
    for (name, jd), (_, pd) in zip(jf, pf):
        if dataclasses.is_dataclass(jd):
            assert dataclasses.asdict(pd) == dataclasses.asdict(jd), name
        else:
            assert pd == jd, name
    assert set(properties(jcls)) <= set(properties(pcls))
    jd_, pd_ = jcls(), pcls()
    for name in properties(jcls):
        assert getattr(pd_, name) == getattr(jd_, name), name


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_community_properties_match(kw):
    jc, pc = build(kw)
    for name in properties(jconfig.CommunityConfig):
        assert getattr(pc, name) == getattr(jc, name), name


@pytest.mark.parametrize("kw", BAD, ids=range(len(BAD)))
def test_same_inputs_refused(kw):
    with pytest.raises(JaxConfigError):
        build(kw)
    jkw, pkw = dict(kw), dict(kw)
    with pytest.raises(ConfigError):
        for name, (_, pcls) in PLANE_ARGS.items():
            if name in pkw:
                pkw[name] = pcls(**pkw[name])
        pconfig.CommunityConfig(**pkw)


def test_bench_config_matches():
    for n in (1 << 20, 1 << 16):
        for platform in ("tpu", "cpu"):
            want = jprofiling.bench_config(n, platform)
            got = profiling.bench_config(n, platform)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    sl = profiling.slice_config(1 << 20)
    assert sl.store == planes.StoreConfig()
    assert (sl.n_peers, sl.n_trackers, sl.k_candidates, sl.msg_capacity,
            sl.bloom_words, sl.request_inbox, sl.tracker_inbox,
            sl.response_budget) == (1 << 20, 8, 16, 48, 15, 4, 1024, 8)


@pytest.mark.parametrize("kw", CONFIGS, ids=range(len(CONFIGS)))
def test_init_state_equal_and_round_trips(kw):
    jc, pc = build(kw)
    want = jstate.init_state(jc, jax.random.PRNGKey(123456789012))
    got = init_state(pc, 123456789012, device="cpu")
    assert_states_equal(got, want, "init_state")
    arrays = state_to_numpy(got)
    back = state_from_numpy(arrays, pc, device="cpu")
    assert_states_equal(back, got, "round trip")
    arrays["store_gt"][0, 0] ^= 1
    with pytest.raises(AssertionError, match="store_gt"):
        assert_states_equal(state_from_numpy(arrays, pc, device="cpu"), got)


def test_state_from_numpy_checks():
    _, pc = build(CONFIGS[1])
    arrays = state_to_numpy(init_state(pc, 0, device="cpu"))
    with pytest.raises(KeyError):
        state_from_numpy({k: v for k, v in arrays.items()
                          if k != "stats.bytes_up"}, pc, device="cpu")
    _, other = build(dict(CONFIGS[1], n_peers=64))
    with pytest.raises(ValueError):
        state_from_numpy(arrays, other, device="cpu")
    assert isinstance(state_from_numpy(arrays, pc, device="cpu").store_gt,
                      torch.Tensor)
    assert arrays["store_gt"].dtype == np.uint32


# ---- the chaos planes on the slice ---------------------------------------------

CHAOS_PLANES = {
    "faults": dict(faults=dict(ge_p_bad=0.05, ge_p_good=0.3,
                               ge_loss_bad=0.5, partitions=(((2, 9),
                                                             (20, 30)),),
                               dup_rate=0.02, corrupt_rate=0.02,
                               flood_senders=(3, 5), flood_fanout=4,
                               health_checks=True)),
    "recovery": dict(faults=dict(health_checks=True),
                     recovery=dict(enabled=True)),
    "overload": dict(overload=dict(enabled=True)),
    "parallel": dict(parallel=dict(shards=8, cross_shard_budget=4,
                                   scatter_chunks=2)),
}


@pytest.mark.parametrize("plane", sorted(CHAOS_PLANES))
def test_check_slice_accepts_the_chaos_planes(plane):
    """Each chaos plane runs: a CPU state takes one round."""
    _, pc = build(dict(CONFIGS[1], **CHAOS_PLANES[plane]))
    one_round(pc)


def one_round(pc):
    """A fresh seeded state of ``pc`` takes one CPU ``step``."""
    from dispersy_tpu_torch import engine
    st = engine.step(engine.seed_overlay(init_state(pc, 1, device="cpu"),
                                         pc, 4), pc)
    assert int(st.round_index.view(torch.int32)) == 1


# The telemetry and trace planes, symmetric NAT and the diet without
# sync: on the slice, with every leaf sized as the JAX package sizes it.
NEW_PLANES = {
    "telemetry": dict(faults=dict(health_checks=True),
                      telemetry=dict(enabled=True, history=8,
                                     histograms=True, flight_recorder=4)),
    "trace": dict(trace=dict(enabled=True, tracked_slots=3)),
    "p_symmetric": dict(p_symmetric=0.3),
    "sync_enabled": dict(sync_enabled=False,
                         store=dict(staging=8, compact_every=4)),
}
SIZED = {
    "telemetry_row": dict(telemetry=dict(enabled=True)),
    "telemetry_ring_hist_flight": NEW_PLANES["telemetry"],
    "every_row_plane": dict(
        faults=dict(health_checks=True), n_meta=3,
        telemetry=dict(enabled=True, history=5, histograms=True,
                       hist_buckets=9, flight_recorder=6,
                       flight_per_round=2),
        trace=dict(enabled=True, tracked_slots=5),
        overload=dict(enabled=True), recovery=dict(enabled=True)),
    "syncless_diet_traced": dict(NEW_PLANES["sync_enabled"],
                                 trace=dict(enabled=True)),
}


@pytest.mark.parametrize("field", sorted(NEW_PLANES))
def test_check_slice_accepts_the_new_planes(field):
    """Each of these planes runs: a CPU state takes one round."""
    _, pc = build(dict(CONFIGS[1], **NEW_PLANES[field]))
    one_round(pc)


@pytest.mark.parametrize("case", sorted(SIZED))
def test_init_state_sizes_the_new_planes(case):
    """tele_row / tele_ring (the row's width), fr_ring / fr_pos,
    walk_streak, trace_* and the digest sized as the JAX package sizes
    them, leaf for leaf."""
    from test_torch_ops import ref
    jc, pc = build(dict(CONFIGS[1], **SIZED[case]))
    got = init_state(pc, 9, device="cpu")
    assert_states_equal(got, ref(jstate.init_state, jc,
                                 jax.random.PRNGKey(9)), "init_state")
    tc = pc.telemetry
    assert got.tele_row.shape == (telemetry.row_width(jc),)
    assert got.tele_ring.shape == (tc.history, telemetry.row_width(jc))
    assert got.fr_ring.shape == (tc.flight_recorder, 8)
    assert got.walk_streak.numel() == (pc.n_peers if tc.histograms else 0)
    t = pc.trace.tracked_slots if pc.trace.enabled else 0
    assert got.trace_first.shape == ((pc.n_peers, t) if t else (0, 0))
    if not pc.sync_enabled:
        assert got.digest.numel() == 0


_PEN = dict(delay_inbox=3, timeline_enabled=True, n_meta=6,
            protected_meta_mask=0b10)


@pytest.mark.parametrize("field,kw", [
    ("delay_inbox", _PEN),
    ("proof_requests", dict(_PEN, proof_requests=True)),
    ("seq_requests", dict(_PEN, seq_meta_mask=0b100, seq_requests=True)),
    ("msg_requests", dict(_PEN, msg_requests=True)),
    ("identity_requests", dict(_PEN, identity_enabled=True,
                               identity_required=True,
                               identity_requests=True)),
    ("double_meta_mask", dict(double_meta_mask=1)),
    ("direct_meta_mask", dict(direct_meta_mask=1)),
    ("communities", dict(communities=((30, 1), (32, 1)))),
])
def test_check_slice_accepts_and_runs(field, kw):
    """Each knob that the slice once refused is accepted: a config with
    it runs two rounds on the CPU and sizes its leaves as the JAX
    package does."""
    from dispersy_tpu_torch import engine
    jc, pc = build(dict(CONFIGS[1], n_peers=64, **kw))
    st = engine.seed_overlay(init_state(pc, 3, device="cpu"), pc, 4)
    st = engine.multi_step(st, pc, 2)
    assert int(st.round_index.view(torch.int32)) == 2
    want = jstate.init_state(jc, jax.random.PRNGKey(3))
    for name in ("dly_gt", "dly_src", "sig_target", "sig_since"):
        assert tuple(getattr(st, name).shape) == tuple(
            np.shape(getattr(want, name))), name


def test_chaos_config_init_state_equal():
    """``profiling.chaos_config`` sizes every plane leaf as the JAX
    package does for the same planes."""
    pc = profiling.chaos_config(256)
    kw = {f.name: getattr(pc, f.name) for f in dataclasses.fields(pc)}
    for name, (jcls, _) in PLANE_ARGS.items():
        kw[name] = jcls(**dataclasses.asdict(kw[name]))
    jc = jconfig.CommunityConfig(**kw)
    want = jstate.init_state(jc, jax.random.PRNGKey(5))
    got = init_state(pc, 5, device="cpu")
    assert_states_equal(got, want, "init_state")
    for leaf in ("health", "ge_bad", "backoff", "bucket"):
        assert getattr(got, leaf).shape == (256,), leaf
    assert got.stats.xshard_shed.shape == (256,)
