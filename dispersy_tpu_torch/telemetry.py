"""The telemetry plane's packed-row schema and host decoders (port of
``dispersy_tpu/telemetry.py``;
:class:`~dispersy_tpu_torch.planes.TelemetryConfig` is the config).

With ``telemetry.enabled`` the round reduces every ``metrics.snapshot``
aggregate into one u32 row, ``PeerState.tele_row``, laid out by
:func:`row_schema`: ``u32`` fields one word, ``f32`` one word (the IEEE
bits), ``u64`` two words (lo, hi), ``hist`` ``hist_buckets`` words of
bucket counts.  ``history`` keeps the last rows in the device ring
``tele_ring`` (round r+1's row at slot ``r % history``), ``histograms``
appends six bucketed distributions, and ``flight_recorder`` keeps the
first ``flight_per_round`` peers whose health sentinel newly latched
each round in the ring ``fr_ring``.  Word 0 is the post-step round,
never 0, so an all-zero row is one no step has written.  Everything here
runs on the host.
"""

from __future__ import annotations

import numpy as np

from dispersy_tpu_torch.faults import HEALTH_BIT_NAMES
from dispersy_tpu_torch.traceplane import CHANNEL_NAMES, LATCH_PCTS

_M32 = 0xFFFFFFFF

# Counter totals carried as u64 (lo, hi) word pairs, in snapshot order.
U64_COUNTERS = (
    "walk_success", "walk_fail", "msgs_stored", "msgs_dropped",
    "msgs_rejected", "msgs_forwarded", "msgs_direct", "msgs_delayed",
    "msgs_corrupt_dropped", "requests_dropped", "punctures",
    "sig_signed", "sig_done", "sig_expired", "conflicts",
    "bytes_up", "bytes_down",
)

# Flight-recorder record layout: FLIGHT_WIDTH u32 words per record;
# ``peer`` is EMPTY (0xFFFFFFFF) on never-written ring slots.
FLIGHT_FIELDS = ("peer", "round", "new_bits", "health",
                 "requests_dropped", "msgs_dropped", "drop_delta",
                 "store_live")
FLIGHT_WIDTH = len(FLIGHT_FIELDS)

# Health-bit word order in the row (ascending bit).
HEALTH_NAMES = tuple(HEALTH_BIT_NAMES[b] for b in sorted(HEALTH_BIT_NAMES))


def hist_specs(cfg) -> tuple:
    """``(name, kind, cap)`` per histogram, in row order.  ``linear``
    buckets span [0, cap] (bucket = ``v * B // (cap + 1)``), ``log2``
    buckets by bit length.  Who contributes: every peer to
    ``store_fill`` (ring and staging), ``round_drops`` and ``bloom_fill``
    (none without sync); alive non-tracker members to ``cand_fill`` and
    ``walk_streak``; non-tracker rows to ``req_inbox``."""
    return (("store_fill", "linear", cfg.msg_capacity + cfg.store.staging),
            ("cand_fill", "linear", cfg.k_candidates),
            ("req_inbox", "linear", cfg.request_inbox),
            ("round_drops", "log2", 0),
            ("bloom_fill", "linear", cfg.bloom_bits),
            ("walk_streak", "log2", 0))


def row_schema(cfg) -> tuple:
    """``(field, kind)`` pairs of the packed row, in word order (a pure
    function of the config).  The trace, overload and recovery words and
    the histograms are there only with their planes."""
    entries = [("round", "u32"), ("sim_time", "f32"),
               ("alive_members", "u32"), ("killed", "u32")]
    entries += [(name, "u64") for name in U64_COUNTERS]
    entries += [("store_live", "u64"), ("cand_live", "u64")]
    entries += [("health_or", "u32"), ("health_flagged", "u32")]
    entries += [(f"health_{nm}", "u32") for nm in HEALTH_NAMES]
    entries += [(f"accepted_by_meta_{i}", "u64")
                for i in range(cfg.n_meta + 1)]
    if cfg.trace.enabled:
        t = cfg.trace.tracked_slots
        entries += [(f"trace_cov_{k}", "u32") for k in range(t)]
        for k in range(t):
            entries += [(f"trace_r{pct}_{k}", "u32")
                        for pct in LATCH_PCTS]
        entries += [(f"trace_delivered_{nm}", "u64")
                    for nm in CHANNEL_NAMES]
        entries += [(f"trace_dup_{nm}", "u64") for nm in CHANNEL_NAMES]
        entries += [("trace_redundancy", "f32")]
    if cfg.overload.enabled:
        entries += [("msgs_shed_rate", "u64"),
                    ("msgs_shed_priority", "u64"),
                    ("bucket_exhausted", "u32")]
    if cfg.recovery.enabled:
        entries += [("recov_soft", "u64"), ("recov_backoff", "u64"),
                    ("recov_quarantine", "u64")]
        entries += [(f"recov_cleared_{nm}", "u64")
                    for nm in HEALTH_NAMES]
    if cfg.telemetry.histograms:
        entries += [(f"hist_{name}", "hist")
                    for name, _, _ in hist_specs(cfg)]
    return tuple(entries)


def _kind_width(kind: str, cfg) -> int:
    if kind == "u64":
        return 2
    if kind == "hist":
        return cfg.telemetry.hist_buckets
    return 1


def row_width(cfg) -> int:
    """Words in the packed row (0 when the plane is off)."""
    if not cfg.telemetry.enabled:
        return 0
    return sum(_kind_width(kind, cfg) for _, kind in row_schema(cfg))


def pack_row_host(values: dict, cfg) -> np.ndarray:
    """Pack ``{field: value}`` into the u32 row: ``u64`` values are ints,
    ``f32`` floats, ``hist`` sequences of ``hist_buckets`` counts."""
    words: list[int] = []
    for name, kind in row_schema(cfg):
        v = values[name]
        if kind == "u32":
            words.append(int(v) & _M32)
        elif kind == "f32":
            words.append(int(np.float32(v).view(np.uint32)))
        elif kind == "u64":
            words += [int(v) & _M32, (int(v) >> 32) & _M32]
        else:
            if len(v) != cfg.telemetry.hist_buckets:
                raise ValueError(f"{name}: {len(v)} buckets, expected "
                                 f"{cfg.telemetry.hist_buckets}")
            words += [int(x) & _M32 for x in v]
    return np.asarray(words, np.uint32)


def unpack_row(row: np.ndarray, cfg) -> dict:
    """Inverse of :func:`pack_row_host`; raises on a width mismatch."""
    row = np.asarray(row, np.uint32)
    want = row_width(cfg)
    if row.shape != (want,):
        raise ValueError(f"telemetry row shape {row.shape}, config "
                         f"expects ({want},)")
    out: dict = {}
    off = 0
    for name, kind in row_schema(cfg):
        if kind == "u32":
            out[name] = int(row[off])
        elif kind == "f32":
            out[name] = float(row[off:off + 1].view(np.float32)[0])
        elif kind == "u64":
            out[name] = int(row[off]) | (int(row[off + 1]) << 32)
        else:
            hb = cfg.telemetry.hist_buckets
            out[name] = [int(x) for x in row[off:off + hb]]
        off += _kind_width(kind, cfg)
    return out


# Word-kind codes: how each row word reduces across replicas.
KIND_U32 = 0       # plain u32 word
KIND_F32 = 1       # IEEE-754 bits
KIND_U64_LO = 2    # low word of a u64 pair
KIND_U64_HI = 3    # high word of a u64 pair


def word_kinds(cfg) -> tuple:
    """Per-word kind codes of the row, in word order (length
    :func:`row_width`); histogram buckets are plain u32 counts."""
    codes: list[int] = []
    for _, kind in row_schema(cfg):
        if kind == "u32":
            codes.append(KIND_U32)
        elif kind == "f32":
            codes.append(KIND_F32)
        elif kind == "u64":
            codes += [KIND_U64_LO, KIND_U64_HI]
        else:
            codes += [KIND_U32] * cfg.telemetry.hist_buckets
    return tuple(codes)


def bucket_upper_bound(kind: str, cap: int, bucket: int,
                       n_buckets: int) -> int:
    """Largest value a histogram bucket can hold."""
    if kind == "linear":
        return min(cap, ((bucket + 1) * (cap + 1) - 1) // n_buckets)
    return (1 << bucket) - 1


def bucket_percentile(counts, q_num: int, q_den: int, kind: str,
                      cap: int) -> int:
    """The ``q_num / q_den`` percentile as a bucket's upper bound: the
    first bucket whose cumulative count reaches ``ceil(q * total)``; 0
    for an empty histogram."""
    counts = [int(c) for c in counts]
    total = sum(counts)
    if total == 0:
        return 0
    need = -(-q_num * total // q_den)
    cum = 0
    for b, c in enumerate(counts):
        cum += c
        if cum >= need:
            return bucket_upper_bound(kind, cap, b, len(counts))
    return bucket_upper_bound(kind, cap, len(counts) - 1, len(counts))


def row_to_snapshot(row: np.ndarray, cfg) -> dict:
    """The ``metrics.snapshot`` dict decoded from one packed row: the
    keys of the snapshot reduced from the leaves, plus, with histograms,
    ``hist_<name>_p50`` / ``_p99`` and the bucket lists."""
    raw = unpack_row(row, cfg)
    ws, wf = raw["walk_success"], raw["walk_fail"]
    n_members = max(raw["alive_members"], 1)
    out = {
        "round": raw["round"],
        "sim_time": raw["sim_time"],
        "alive_members": raw["alive_members"],
        "killed": raw["killed"],
        "walk_success": ws,
        "walk_fail": wf,
        "walk_success_rate": ws / max(ws + wf, 1),
    }
    for name in U64_COUNTERS[2:]:
        out[name] = raw[name]
    # Occupancy means from the exact integer numerators.
    out["store_fill"] = raw["store_live"] / float(
        cfg.n_peers * (cfg.msg_capacity + cfg.store.staging))
    out["candidate_fill"] = raw["cand_live"] / float(
        cfg.k_candidates * n_members)
    out["health_or"] = raw["health_or"]
    out["health_flagged"] = raw["health_flagged"]
    for nm in HEALTH_NAMES:
        out[f"health_{nm}"] = raw[f"health_{nm}"]
    out["accepted_by_meta"] = [raw[f"accepted_by_meta_{i}"]
                               for i in range(cfg.n_meta + 1)]
    if cfg.trace.enabled:
        for k in range(cfg.trace.tracked_slots):
            out[f"trace_cov_{k}"] = raw[f"trace_cov_{k}"]
            for pct in LATCH_PCTS:
                out[f"trace_r{pct}_{k}"] = raw[f"trace_r{pct}_{k}"]
        for nm in CHANNEL_NAMES:
            out[f"trace_delivered_{nm}"] = raw[f"trace_delivered_{nm}"]
            out[f"trace_dup_{nm}"] = raw[f"trace_dup_{nm}"]
        out["trace_redundancy"] = raw["trace_redundancy"]
    if cfg.overload.enabled:
        for nm in ("msgs_shed_rate", "msgs_shed_priority",
                   "bucket_exhausted"):
            out[nm] = raw[nm]
    if cfg.recovery.enabled:
        from dispersy_tpu_torch.recovery import availability_of
        for nm in ("recov_soft", "recov_backoff", "recov_quarantine"):
            out[nm] = raw[nm]
        for nm in HEALTH_NAMES:
            out[f"recov_cleared_{nm}"] = raw[f"recov_cleared_{nm}"]
        out["availability"] = availability_of(raw["health_flagged"],
                                              cfg.n_peers)
    if cfg.telemetry.histograms:
        for name, kind, cap in hist_specs(cfg):
            counts = raw[f"hist_{name}"]
            out[f"hist_{name}_p50"] = bucket_percentile(
                counts, 50, 100, kind, cap)
            out[f"hist_{name}_p99"] = bucket_percentile(
                counts, 99, 100, kind, cap)
            out[f"hist_{name}"] = counts
    return out


def ring_rows(ring: np.ndarray, cfg) -> list:
    """A drained ``tele_ring`` decoded into snapshot dicts, oldest round
    first; never-written (all-zero) slots are skipped."""
    ring = np.asarray(ring, np.uint32)
    rows = [row for row in ring if int(row[0]) > 0]
    rows.sort(key=lambda r: int(r[0]))
    return [row_to_snapshot(row, cfg) for row in rows]


def flight_records(state, cfg) -> list:
    """The flight-recorder ring decoded into event dicts, oldest first
    (``fr_pos`` counts every record written, so the order holds after
    the ring wraps), with the health bits also named."""
    if cfg.telemetry.flight_recorder <= 0:
        return []
    ring = state.fr_ring.detach().cpu().numpy().astype(np.uint32)
    pos = int(state.fr_pos.detach().cpu().numpy()[0])
    depth = ring.shape[0]
    live = min(pos, depth)
    out = []
    for i in range(pos - live, pos):
        rec = ring[i % depth]
        if int(rec[0]) == _M32:
            continue
        d = {k: int(v) for k, v in zip(FLIGHT_FIELDS, rec)}
        d["new_bit_names"] = [nm for bit, nm in HEALTH_BIT_NAMES.items()
                              if d["new_bits"] & bit]
        d["health_names"] = [nm for bit, nm in HEALTH_BIT_NAMES.items()
                             if d["health"] & bit]
        out.append(d)
    return out


def adapt_row_leaves(state, old_cfg, new_cfg):
    """``tele_row`` / ``tele_ring`` reset to zero at the new row width when
    a config swap changed it (a recovery or overload flip adds or drops
    its words; old rows cannot be decoded under the new schema).  The
    state unchanged when the width did not change."""
    import torch

    from dispersy_tpu_torch.u32 import zeros
    new_w = row_width(new_cfg)
    if new_w == row_width(old_cfg):
        return state
    dev = state.device
    return state.replace(
        tele_row=zeros((new_w,), torch.uint32, dev),
        tele_ring=zeros((new_cfg.telemetry.history, new_w), torch.uint32,
                        dev))
