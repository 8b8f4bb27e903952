"""The dissemination-tracing plane's constants and host helpers (port of
``dispersy_tpu/traceplane.py``; :class:`~dispersy_tpu_torch.planes.TraceConfig`
is the config).

Up to ``trace.tracked_slots`` records, registered by (author, global
time) through :func:`dispersy_tpu_torch.engine.track_record`, get
per-peer lineage leaves the round updates: ``trace_first`` (the
post-step round a record first landed in the peer's logical store, 0 for
not yet), ``trace_chan`` (the channel that carried it, :data:`CH_CREATE`
... :data:`CH_FLOOD`) and ``trace_dups`` (its other arrivals), plus the
coverage latches ``trace_latch`` and the per-channel counters
``stats.trace_delivered`` / ``stats.trace_dup``.  Lineage is disk-like:
it wipes with the store at a churn rebirth and at a quarantine.  The
round's ops are :mod:`dispersy_tpu_torch.ops.trace`; the helpers here
run on the host.
"""

from __future__ import annotations

import numpy as np

# First-delivery channel codes (trace_chan values; 0 = none yet).  Code
# c maps to CHANNEL_NAMES[c - 1].
CH_CREATE = 1      # authored locally, or held at registration
CH_WALK_SYNC = 2   # pulled through the Bloom-sync response
CH_PUSH = 3        # pushed by a forwarding peer
CH_FLOOD = 4       # the byzantine flood: junk never decodes, so a real
#                    record is never delivered by it (a measured zero)
CHANNEL_NAMES = ("create", "walk_sync", "push", "flood")
NUM_CHANNELS = len(CHANNEL_NAMES)

# Coverage-latch percentiles, in trace_latch column order.
LATCH_PCTS = (50, 90, 99)


def redundancy_f32(delivered, dup) -> float:
    """The row's redundancy ratio from the per-channel useful and
    duplicate totals, in float32 operation for operation as the round
    computes it: per channel ``lo + hi * 2^32`` in f32, accumulated in
    channel order; ``(useful + dup) / useful``, or 0 with no useful
    delivery yet."""
    two32 = np.float32(4294967296.0)
    useful_f = np.float32(0.0)
    dup_f = np.float32(0.0)
    for c in range(NUM_CHANNELS):
        d = int(delivered[c])
        u = int(dup[c])
        useful_f = np.float32(
            useful_f + np.float32(
                np.float32(d & 0xFFFFFFFF) + np.float32(d >> 32) * two32))
        dup_f = np.float32(
            dup_f + np.float32(
                np.float32(u & 0xFFFFFFFF) + np.float32(u >> 32) * two32))
    if not useful_f > 0:
        return 0.0
    return float(np.float32((useful_f + dup_f) / useful_f))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def trace_totals(state, cfg) -> dict:
    """The trace plane's snapshot keys from a state: per-slot coverage
    and latches, per-channel useful and duplicate totals, the redundancy
    ratio (the key set the telemetry row decodes to)."""
    t = cfg.trace.tracked_slots
    first = _host(state.trace_first)
    members = _host(state.alive) & ~_host(state.is_tracker)
    latch = _host(state.trace_latch)
    out: dict = {}
    for k in range(t):
        cov = int(((first[:, k] != 0) & members).sum()) if first.size \
            else 0
        out[f"trace_cov_{k}"] = cov
        for i, pct in enumerate(LATCH_PCTS):
            out[f"trace_r{pct}_{k}"] = (int(latch[k, i])
                                        if latch.size else 0)
    tdel = _host(state.stats.trace_delivered)
    tdup = _host(state.stats.trace_dup)
    delivered = (tdel.astype(np.uint64).sum(axis=0) if tdel.size
                 else np.zeros(NUM_CHANNELS, np.uint64))
    dup = (tdup.astype(np.uint64).sum(axis=0) if tdup.size
           else np.zeros(NUM_CHANNELS, np.uint64))
    for c, nm in enumerate(CHANNEL_NAMES):
        out[f"trace_delivered_{nm}"] = int(delivered[c])
        out[f"trace_dup_{nm}"] = int(dup[c])
    out["trace_redundancy"] = redundancy_f32(delivered, dup)
    return out


def slots_in_rows(rows) -> list:
    """The tracked-slot indices present in a row log (``trace_cov_<k>``
    keys), sorted."""
    slots: set[int] = set()
    for row in rows:
        for key in row:
            if key.startswith("trace_cov_"):
                try:
                    slots.add(int(key[len("trace_cov_"):]))
                except ValueError:
                    pass
    return sorted(slots)


def coverage_curve(rows, slot: int) -> list:
    """``(round, covered, alive_members)`` for one slot, rounds
    ascending."""
    out = []
    for row in sorted(rows, key=lambda r: int(r.get("round", 0))):
        if f"trace_cov_{slot}" not in row:
            continue
        out.append((int(row["round"]), int(row[f"trace_cov_{slot}"]),
                    int(row.get("alive_members", 0))))
    return out


def latency_percentiles(rows, slot: int,
                        pcts=(10, 25, 50, 75, 90, 99)) -> dict:
    """First-arrival latency percentiles of one tracked record, in
    rounds after its first appearance (the first round coverage reaches
    p% of the alive members); None where the log never got there."""
    curve = coverage_curve(rows, slot)
    start = next((rnd for rnd, cov, _ in curve if cov > 0), None)
    out: dict = {"start_round": start}
    for p in pcts:
        hit = next((rnd for rnd, cov, alive in curve
                    if alive > 0 and cov * 100 >= p * alive), None)
        out[f"p{p}"] = None if (hit is None or start is None) \
            else hit - start
    return out


def channel_table(rows) -> dict:
    """Per-channel useful and duplicate totals and useful shares from a
    row log's last row (the counters are cumulative)."""
    last = max(rows, key=lambda r: int(r.get("round", 0)), default={})
    out: dict = {}
    total = 0
    for nm in CHANNEL_NAMES:
        d = int(last.get(f"trace_delivered_{nm}", 0))
        out[f"delivered_{nm}"] = d
        out[f"dup_{nm}"] = int(last.get(f"trace_dup_{nm}", 0))
        total += d
    for nm in CHANNEL_NAMES:
        out[f"share_{nm}"] = (out[f"delivered_{nm}"] / total
                              if total else 0.0)
    out["delivered_total"] = total
    return out


def trace_report(rows) -> dict:
    """Dissemination summary of a row log: per-slot final coverage and
    latches, per-channel totals and shares, the redundancy ratio."""
    rows = [r for r in rows if isinstance(r, dict)]
    out: dict = {"rounds": len(rows)}
    if not rows:
        return out
    last = max(rows, key=lambda r: int(r.get("round", 0)))
    for k in slots_in_rows(rows):
        out[f"slot{k}_cov"] = int(last.get(f"trace_cov_{k}", 0))
        for pct in LATCH_PCTS:
            out[f"slot{k}_r{pct}"] = int(last.get(f"trace_r{pct}_{k}", 0))
    out.update(channel_table(rows))
    out["redundancy"] = float(last.get("trace_redundancy", 0.0))
    return out
