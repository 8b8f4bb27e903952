"""The telemetry and trace planes of the port against the JAX package's.

The ops (``ops/telemetry.py``, ``ops/trace.py``) on numpy-seeded inputs
with their edge values, bit for bit; the host helpers
(``telemetry.py``, ``traceplane.py``) on the same rows and leaves, with
no JAX compile; and the JAX package's committed golden runs
(``artifacts/golden_trace.json``, ``golden_recovery.json``,
``golden_overload.json``) regenerated by the port on the CPU through
``engine.step`` / ``track_record`` / ``MetricsLog.extend_from_ring``
and matched row for row, key for key, with no tolerance.  The planes
also ride the step-parity cases of ``test_torch_chaos.py`` and
``test_torch_step.py``.
"""

import json
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dispersy_tpu import engine as jeng
from dispersy_tpu import telemetry as jtlm
from dispersy_tpu import traceplane as jtrp
from dispersy_tpu.ops import telemetry as jtele
from dispersy_tpu.ops import trace as jtrc

from dispersy_tpu_torch import engine, init_state, metrics
from dispersy_tpu_torch import telemetry as tlm
from dispersy_tpu_torch import traceplane as trp
from dispersy_tpu_torch.config import CommunityConfig
from dispersy_tpu_torch.ops import telemetry as tele
from dispersy_tpu_torch.ops import trace as trc
from dispersy_tpu_torch.planes import (FaultModel, OverloadConfig,
                                       RecoveryConfig, StoreConfig,
                                       TelemetryConfig, TraceConfig)
from dispersy_tpu_torch.u32 import narrow

from test_torch_chaos import to_jax
from test_torch_ops import (ref, release_xla_executables,  # noqa: F401
                            same, to_np, to_t, u32)

# One torch thread, as in test_torch_ops.
torch.set_num_threads(1)

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
U32_MAX = 0xFFFFFFFF


# ---- the ops ---------------------------------------------------------------

def test_col_sum_u64_near_the_top_of_every_lane():
    """Exact 64-bit column sums with every word near 0xFFFFFFFF (every
    byte lane carries), a zero column and a column of random words."""
    rs = np.random.default_rng(21)
    n = 1000
    x = np.stack([U32_MAX - u32(rs, n, hi=4), np.full(n, U32_MAX, np.uint32),
                  np.zeros(n, np.uint32), u32(rs, n),
                  np.full(n, 0x80808080, np.uint32)], axis=1)
    same([tele.col_sum_u64(to_t(x))], [ref(jtele.col_sum_u64, x)])
    want = x.astype(np.uint64).sum(axis=0)
    got = to_np(tele.col_sum_u64(to_t(x))).astype(np.uint64)
    assert (got[0] | (got[1] << np.uint64(32))).tolist() == want.tolist()
    same([tele.sum_u64(to_t(x[:, 0]))], [ref(jtele.sum_u64, x[:, 0])])
    same([tele.col_sum_u64(to_t(x[:, :0]))], [ref(jtele.col_sum_u64,
                                                  x[:, :0])])


def test_counter_matrix_zero_width_counter_reads_zero():
    """A compiled-out counter (``msgs_corrupt_dropped`` without its
    fault knobs) is a zero column of the snapshot's counter matrix."""
    pc = CommunityConfig(n_peers=48, n_trackers=2, k_candidates=8,
                         msg_capacity=16)
    rs = np.random.default_rng(22)
    ps = init_state(pc, 1, device="cpu")
    vals = {nm: u32(rs, 48) for nm in ("walk_success", "bytes_up",
                                       "msgs_dropped")}
    vals["bytes_down"] = np.full(48, U32_MAX, np.uint32)
    ps = ps.replace(stats=ps.stats.replace(
        **{k: to_t(v) for k, v in vals.items()}))
    assert ps.stats.msgs_corrupt_dropped.numel() == 0
    # The same stats leaves for the JAX package's function.
    jstats = types.SimpleNamespace(**{k: jnp.asarray(to_np(v))
                                      for k, v in ps.stats.items()})
    got = engine.counter_matrix(ps.stats, 48)
    same([got], [ref(jeng.counter_matrix, jstats, 48)])
    col = tlm.U64_COUNTERS.index("msgs_corrupt_dropped")
    assert not to_np(got)[:, col].any()


def test_histograms_edges():
    """hist_linear's clamp at cap (and its u32-wrapping product for huge
    values), hist_log2 at 0, 1, 2^31 and 0xFFFFFFFF, masked entries
    dropped, at 2, 5, 16 and 64 buckets."""
    rs = np.random.default_rng(23)
    n = 700
    val = u32(rs, n, hi=60)
    val[:12] = [0, 1, 47, 48, 49, 200, 1 << 31, (1 << 31) + 5, U32_MAX,
                U32_MAX - 1, 0x40000000, 0x3FFFFFFF]
    mask = rs.random(n) < 0.8
    mask[:12] = True
    for b in (2, 5, 16, 64):
        same([tele.hist_linear(to_t(val), to_t(mask), 48, b)],
             [ref(jtele.hist_linear, val, mask, 48, b)])
        same([tele.hist_log2(to_t(val), to_t(mask), b)],
             [ref(jtele.hist_log2, val, mask, b)])
    got = to_np(tele.hist_log2(to_t(val), to_t(mask), 64))
    assert got[32] == 4 and got[0] >= 1     # the four values >= 2^31; 0


def test_flight_append_wraps():
    """Consecutive appends into a depth-5 ring: ranks in order, the ring
    wrapping at pos % depth, invalid rows dropped, pos wrapping in u32."""
    rs = np.random.default_rng(24)
    ring = u32(rs, 5, 8)
    pos = np.array([3], np.uint32)
    jring, jpos = ring, pos
    jitted = jax.jit(jtele.flight_append)     # one compile for every call
    for valid in ([True, False, True, True], [False] * 4,
                  [True, True, True, True], [False, True, False, False]):
        recs = u32(rs, 4, 8)
        v = np.array(valid)
        got = tele.flight_append(to_t(ring), to_t(pos), to_t(recs),
                                 to_t(v))
        want = jitted(jring, jpos, recs, v)
        same(got, want)
        ring, pos = to_np(got[0]), to_np(got[1])
        jring, jpos = np.asarray(want[0]), np.asarray(want[1])
    top = np.array([U32_MAX - 1], np.uint32)
    recs, v = u32(rs, 4, 8), np.array([True] * 4)
    same(tele.flight_append(to_t(ring), to_t(top), to_t(recs), to_t(v)),
         jitted(ring, top, recs, v))


def test_slot_lineage_coverage_latches():
    """The lineage fold (first arrivals, channels, duplicates and the
    per-channel counts) on random batches with every channel code, three
    slots at once against the JAX package's fold of each slot, then the
    coverage counts and the latches at the percent boundaries."""
    rs = np.random.default_rng(25)
    n, b, t = 300, 10, 3
    first = np.where(rs.random((n, t)) < 0.3, u32(rs, n, t, hi=9) + 1,
                     0).astype(np.uint32)
    chan = rs.integers(0, 5, size=(n, t)).astype(np.uint8)
    dups = u32(rs, n, t, hi=5)
    dups[:3] = U32_MAX                         # the counter wraps
    match = rs.random((n, t, b)) < 0.4
    landed = rs.random((n, b)) < 0.5
    arrived = landed | (rs.random((n, b)) < 0.3)
    code = rs.integers(1, 5, size=b).astype(np.uint8)
    rpost = np.uint32(17)
    got = trc.slot_lineage(to_t(first), to_t(chan), to_t(dups),
                           to_t(match), to_t(landed), to_t(arrived),
                           to_t(code), torch.tensor(17))
    jitted = jax.jit(jtrc.slot_lineage)       # one compile for the slots
    want = [jitted(first[:, k], chan[:, k], dups[:, k], match[:, k],
                   landed, arrived, code, rpost) for k in range(t)]
    # The u32 outputs come as int64 carriers; the counts are summed over
    # the slots.
    same([narrow(got[0]), got[1], narrow(got[2])],
         [np.stack([np.asarray(w[i]) for w in want], axis=1)
          for i in range(3)])
    for i in (3, 4):
        np.testing.assert_array_equal(
            to_np(got[i]), sum(np.asarray(w[i]).astype(np.int64)
                               for w in want))
    firsts = np.where(rs.random((n, t)) < 0.5, 4, 0).astype(np.uint32)
    members = rs.random(n) < 0.9
    same([trc.coverage_counts(to_t(firsts), to_t(members))],
         [ref(jtrc.coverage_counts, firsts, members)])
    alive = int(members.sum())
    latch = np.array([[0, 0, 0], [3, 0, 0], [0, 0, 0]], np.uint32)
    reg = np.array([True, True, False])
    jitted = jax.jit(jtrc.latch_update)
    for cov in ((alive + 1) // 2, alive * 9 // 10, alive):
        c = np.full(t, cov, np.uint32)
        for a in (alive, 0):
            same([trc.latch_update(to_t(latch), to_t(c), to_t(reg),
                                   torch.tensor(a), torch.tensor(9))],
                 [jitted(latch, c, reg, np.uint32(a), np.uint32(9))])


# ---- the host helpers ------------------------------------------------------

PLANE_CASES = {
    "plain": CommunityConfig(n_peers=64, n_trackers=2,
                             telemetry=TelemetryConfig(enabled=True)),
    "everything": CommunityConfig(
        n_peers=64, n_trackers=2, n_meta=3,
        faults=FaultModel(health_checks=True),
        telemetry=TelemetryConfig(enabled=True, history=8, histograms=True,
                                  hist_buckets=7, flight_recorder=4),
        trace=TraceConfig(enabled=True, tracked_slots=3),
        overload=OverloadConfig(enabled=True),
        recovery=RecoveryConfig(enabled=True),
        store=StoreConfig(staging=8, compact_every=4)),
}


def random_values(rs, cfg) -> dict:
    """A ``{field: value}`` dict for the row of ``cfg`` (u64 values
    above 2^32, f32 sim time, histogram counts)."""
    out = {}
    for name, kind in tlm.row_schema(cfg):
        if kind == "u32":
            out[name] = int(rs.integers(1, 1 << 32))
        elif kind == "f32":
            out[name] = float(np.float32(rs.random() * 1e4))
        elif kind == "u64":
            out[name] = int(rs.integers(0, 1 << 62))
        else:
            out[name] = [int(x) for x in rs.integers(
                0, 1000, size=cfg.telemetry.hist_buckets)]
    return out


@pytest.mark.parametrize("case", sorted(PLANE_CASES))
def test_row_schema_pack_and_decode_equal_jax(case):
    """row_schema, row_width, word_kinds, hist_specs, pack_row_host,
    unpack_row, row_to_snapshot and ring_rows of both packages on the
    same rows."""
    pc = PLANE_CASES[case]
    jc = to_jax(pc)
    assert tlm.row_schema(pc) == jtlm.row_schema(jc)
    assert tlm.row_width(pc) == jtlm.row_width(jc)
    assert tlm.word_kinds(pc) == jtlm.word_kinds(jc)
    assert tlm.hist_specs(pc) == jtlm.hist_specs(jc)
    assert (tlm.U64_COUNTERS, tlm.HEALTH_NAMES, tlm.FLIGHT_FIELDS) == (
        jtlm.U64_COUNTERS, jtlm.HEALTH_NAMES, jtlm.FLIGHT_FIELDS)
    rs = np.random.default_rng(26)
    rows = []
    for rnd in (3, 1, 2):
        vals = random_values(rs, pc)
        vals["round"] = rnd
        row = tlm.pack_row_host(vals, pc)
        np.testing.assert_array_equal(row, jtlm.pack_row_host(vals, jc))
        assert tlm.unpack_row(row, pc) == jtlm.unpack_row(row, jc)
        assert tlm.row_to_snapshot(row, pc) == jtlm.row_to_snapshot(row,
                                                                    jc)
        rows.append(row)
    ring = np.stack(rows + [np.zeros_like(rows[0])])
    assert tlm.ring_rows(ring, pc) == jtlm.ring_rows(ring, jc)
    with pytest.raises(ValueError, match="row shape"):
        tlm.unpack_row(rows[0][1:], pc)


def test_bucket_percentiles_equal_jax():
    rs = np.random.default_rng(27)
    for _ in range(40):
        b = int(rs.integers(2, 65))
        counts = rs.integers(0, 5, size=b) * (rs.random(b) < 0.5)
        cap = int(rs.integers(0, 500))
        for kind in ("linear", "log2"):
            for q in ((50, 100), (99, 100), (1, 3), (100, 100)):
                assert tlm.bucket_percentile(counts, *q, kind, cap) == \
                    jtlm.bucket_percentile(counts, *q, kind, cap)
            for k in range(b):
                assert tlm.bucket_upper_bound(kind, cap, k, b) == \
                    jtlm.bucket_upper_bound(kind, cap, k, b)


def test_flight_records_and_trace_totals_equal_jax():
    """The flight-recorder decoder (a wrapped ring) and the trace
    totals (u64 channel sums, the f32 redundancy) on the same leaves."""
    pc = PLANE_CASES["everything"]
    jc = to_jax(pc)
    rs = np.random.default_rng(28)
    ring = u32(rs, 4, 8)
    ring[:, 2:4] = rs.integers(0, 16, size=(4, 2))
    ring[1, 0] = U32_MAX
    n, t = pc.n_peers, pc.trace.tracked_slots
    leaves = dict(
        fr_ring=ring, fr_pos=np.array([11], np.uint32),
        trace_first=np.where(rs.random((n, t)) < 0.5, 3, 0).astype(
            np.uint32),
        alive=rs.random(n) < 0.9, is_tracker=np.arange(n) < 2,
        trace_latch=u32(rs, t, 3, hi=40))
    stats = dict(trace_delivered=U32_MAX - u32(rs, n, 4, hi=3),
                 trace_dup=u32(rs, n, 4))
    jst = types.SimpleNamespace(stats=types.SimpleNamespace(**stats),
                                **leaves)
    pst = types.SimpleNamespace(
        stats=types.SimpleNamespace(**{k: to_t(v) for k, v in
                                       stats.items()}),
        **{k: to_t(v) for k, v in leaves.items()})
    assert tlm.flight_records(pst, pc) == jtlm.flight_records(jst, jc)
    assert len(tlm.flight_records(pst, pc)) == 3
    assert trp.trace_totals(pst, pc) == jtrp.trace_totals(jst, jc)
    for d, u in ((stats["trace_delivered"].astype(np.uint64).sum(0),
                  stats["trace_dup"].astype(np.uint64).sum(0)),
                 ([0] * 4, [5] * 4), ([1 << 40, 3, 0, 7], [2 ** 33, 1, 1,
                                                          0])):
        assert trp.redundancy_f32(d, u) == jtrp.redundancy_f32(d, u)
    assert (trp.CHANNEL_NAMES, trp.LATCH_PCTS, trp.CH_CREATE,
            trp.CH_WALK_SYNC, trp.CH_PUSH, trp.CH_FLOOD) == (
        jtrp.CHANNEL_NAMES, jtrp.LATCH_PCTS, jtrp.CH_CREATE,
        jtrp.CH_WALK_SYNC, jtrp.CH_PUSH, jtrp.CH_FLOOD)


def test_trace_report_helpers_equal_jax():
    """trace_report, channel_table, coverage_curve, latency_percentiles
    and slots_in_rows on the committed golden trace log."""
    rows = json.loads((ARTIFACTS / "golden_trace.json").read_text())[
        "rounds"]
    assert trp.trace_report(rows) == jtrp.trace_report(rows)
    assert trp.trace_report([]) == jtrp.trace_report([])
    assert trp.channel_table(rows) == jtrp.channel_table(rows)
    assert trp.slots_in_rows(rows) == jtrp.slots_in_rows(rows) == [0, 1]
    for k in (0, 1, 5):
        assert trp.coverage_curve(rows, k) == jtrp.coverage_curve(rows, k)
        assert trp.latency_percentiles(rows, k) == \
            jtrp.latency_percentiles(rows, k)


# ---- the golden runs -------------------------------------------------------

GOLDEN_BASE = dict(n_peers=48, n_trackers=2, msg_capacity=32,
                   bloom_capacity=16, k_candidates=8, request_inbox=4,
                   tracker_inbox=16, response_budget=8, push_inbox=2,
                   faults=FaultModel(flood_senders=(9, 21), flood_fanout=24,
                                     health_checks=True,
                                     health_drop_limit=2),
                   telemetry=TelemetryConfig(enabled=True, history=32))
# name: (config, seed, rounds, (author, payload) creates tracked first):
# tests/test_trace.py:487-521, test_recovery.py:542-565 and
# test_overload.py:712-735.
GOLDEN = {
    "golden_trace": (CommunityConfig(
        n_peers=40, n_trackers=2, msg_capacity=48, bloom_capacity=16,
        k_candidates=8, request_inbox=4, tracker_inbox=16,
        response_budget=4, push_inbox=8, packet_loss=0.05,
        trace=TraceConfig(enabled=True, tracked_slots=2),
        telemetry=TelemetryConfig(enabled=True, history=32),
        faults=FaultModel(ge_p_bad=0.1, ge_p_good=0.4, ge_loss_good=0.02,
                          ge_loss_bad=0.5, dup_rate=0.1, corrupt_rate=0.05,
                          flood_senders=(9,), flood_fanout=8)),
        11, 20, ((5, 42), (7, 43))),
    "golden_recovery": (CommunityConfig(
        **GOLDEN_BASE, recovery=RecoveryConfig(
            enabled=True, backoff_limit=3, backoff_decay=0.5,
            quarantine_rounds=5, requarantine_window=4)), 5, 24, ()),
    "golden_overload": (CommunityConfig(
        **GOLDEN_BASE, overload=OverloadConfig(
            enabled=True, bucket_rate=4.0, bucket_depth=8)), 5, 24, ()),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_port_regenerates_golden_log(name, tmp_path):
    """Every row and every key of the committed golden log, exactly (the
    log's floats are the row's host-side ratios and f32 words, which the
    JSON round trip keeps), and the file ``MetricsLog.dump`` writes reads
    back as the committed one; the fused snapshot is the log's last row
    and agrees with the leaf-reduced one on every key."""
    cfg, seed, rounds, setup = GOLDEN[name]
    state = engine.seed_overlay(init_state(cfg, seed, device="cpu"), cfg, 6)
    first_keys = metrics.snapshot(state, cfg).keys()
    for author, payload in setup:
        mask = torch.from_numpy(np.arange(cfg.n_peers) == author)
        state = engine.create_messages(
            state, cfg, mask, 1, torch.full((cfg.n_peers,), payload))
        gt = int(state.global_time.view(torch.int32)[author])
        state, slot = engine.track_record(state, cfg, author, gt)
        again, slot2 = engine.track_record(state, cfg, author, gt)
        assert again is state and slot2 == slot
    state = engine.multi_step(state, cfg, rounds)
    log = metrics.MetricsLog(meta={"n_peers": cfg.n_peers,
                                   "rounds": rounds})
    log.extend_from_ring(state, cfg)
    want = json.loads((ARTIFACTS / f"{name}.json").read_text())
    got = json.loads(json.dumps({"meta": log.meta, "rounds": log.rows}))
    assert len(got["rounds"]) == len(want["rounds"]) == rounds
    for r, (g, w) in enumerate(zip(got["rounds"], want["rounds"])):
        assert g == w, (r, [k for k in w if g.get(k) != w[k]])
    assert got == want
    log.dump(str(tmp_path / f"{name}.json"))
    assert json.loads((tmp_path / f"{name}.json").read_text()) == want
    fused = metrics.snapshot(state, cfg)
    assert fused == log.rows[-1] and fused.keys() == first_keys
    legacy = metrics.legacy_snapshot(state, cfg)
    assert legacy.keys() == fused.keys()
    for key, val in fused.items():
        if isinstance(val, float) and key != "trace_redundancy":
            assert legacy[key] == pytest.approx(val, rel=1e-6), key
        else:
            assert legacy[key] == val, key


def test_track_record_slots():
    """Idempotent re-registration, the free slots taken in order, the
    error when they run out or the plane is off, and the holders stamped
    on the create channel on the state's device."""
    cfg = CommunityConfig(n_peers=32, n_trackers=2,
                          trace=TraceConfig(enabled=True, tracked_slots=2))
    state = init_state(cfg, 3, device="cpu")
    mask = torch.from_numpy(np.arange(32) % 8 == 4)
    state = engine.create_messages(state, cfg, mask, 1,
                                   torch.arange(32) + 100)
    state, a = engine.track_record(state, cfg, 4, 2)
    state, b = engine.track_record(state, cfg, 12, 2)
    assert (a, b) == (0, 1)
    assert engine.track_record(state, cfg, 12, 2)[1] == 1
    first = to_np(state.trace_first)
    assert first[4, 0] == 1 and first[12, 1] == 1
    assert int((first != 0).sum()) == 2
    assert to_np(state.trace_chan)[4, 0] == trp.CH_CREATE
    assert to_np(state.stats.trace_delivered)[:, 0].sum() == 2
    assert state.trace_first.device.type == "cpu"
    with pytest.raises(ValueError, match="tracked slots are taken"):
        engine.track_record(state, cfg, 20, 2)
    plain = CommunityConfig(n_peers=32, n_trackers=2)
    with pytest.raises(ValueError, match="trace.enabled"):
        engine.track_record(init_state(plain, 0, device="cpu"), plain, 4, 2)
