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
    from dispersy_tpu_torch import engine
    _, pc = build(dict(CONFIGS[1], **CHAOS_PLANES[plane]))
    engine.check_slice(pc)


@pytest.mark.parametrize("field,kw", [
    ("telemetry", dict(telemetry=planes.TelemetryConfig(enabled=True))),
    ("trace", dict(trace=planes.TraceConfig(enabled=True))),
    ("communities", dict(communities=((60, 1), (66, 1)))),
    ("delay_inbox", dict(delay_inbox=3, timeline_enabled=True, n_meta=4,
                         protected_meta_mask=0b10)),
])
def test_check_slice_still_refuses(field, kw):
    from dispersy_tpu_torch import engine
    pc = pconfig.CommunityConfig(**dict(CONFIGS[1], **kw))
    with pytest.raises(NotImplementedError, match=field):
        engine.check_slice(pc)


def test_chaos_config_init_state_equal():
    """``profiling.chaos_config`` sizes every plane leaf as the JAX
    package does for the same planes."""
    pc = profiling.chaos_config(256)
    kw = {f.name: getattr(pc, f.name) for f in dataclasses.fields(pc)}
    for name, (jcls, _) in dict(
            PLANE_ARGS, trace=(traceplane.TraceConfig, None)).items():
        kw[name] = jcls(**dataclasses.asdict(kw[name]))
    jc = jconfig.CommunityConfig(**kw)
    want = jstate.init_state(jc, jax.random.PRNGKey(5))
    got = init_state(pc, 5, device="cpu")
    assert_states_equal(got, want, "init_state")
    for leaf in ("health", "ge_bad", "backoff", "bucket"):
        assert getattr(got, leaf).shape == (256,), leaf
    assert got.stats.xshard_shed.shape == (256,)
