"""Aggregate metrics and the round log (port of ``snapshot`` and
``MetricsLog`` in ``dispersy_tpu/metrics.py``).

:func:`snapshot` has two paths, as in the JAX package.  With the
telemetry plane on and a step run, the round has already reduced every
aggregate into the packed row ``state.tele_row``: the snapshot is one
transfer of that row, decoded on the host (:mod:`telemetry`).
Otherwise (:func:`legacy_snapshot`) every aggregate is reduced from the
state's leaves, the plane reports (health, trace, overload, recovery)
through the host tools of :mod:`faults`, :mod:`traceplane`,
:mod:`overload` and :mod:`recovery`; counters are summed on the host in
uint64, so 1M-peer byte totals do not wrap.  :class:`MetricsLog` keeps
a row per round and drains the device ring of rows in one transfer.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

from dispersy_tpu_torch import telemetry as tlm
from dispersy_tpu_torch.config import EMPTY_U32, NO_PEER, CommunityConfig
from dispersy_tpu_torch.engine import counter_matrix, killed_mask
from dispersy_tpu_torch.faults import health_report, host
from dispersy_tpu_torch.overload import shed_totals
from dispersy_tpu_torch.recovery import action_totals, availability_of
from dispersy_tpu_torch.state import PeerState
from dispersy_tpu_torch.traceplane import trace_totals

logger = logging.getLogger(__name__)


def _u64_total(col: torch.Tensor) -> int:
    """Sum of a u32 counter leaf (a zero-width leaf totals 0)."""
    return int(host(col).astype(np.uint64).sum())


def snapshot(state: PeerState, cfg: CommunityConfig) -> dict:
    """Aggregate overlay metrics: decoded from the telemetry row once a
    step has written it (one host transfer), else
    :func:`legacy_snapshot`.  Counters are cumulative."""
    if cfg.telemetry.enabled:
        row = host(state.tele_row)
        if int(row[0]):                   # word 0: the post-step round
            return tlm.row_to_snapshot(row, cfg)
    return legacy_snapshot(state, cfg)


def legacy_snapshot(state: PeerState, cfg: CommunityConfig) -> dict:
    """The snapshot reduced from the state's leaves: the keys the row
    decodes to (histograms empty: they exist only in the round)."""
    s = state.stats
    members = state.alive & ~state.is_tracker
    n_members = max(int(members.sum()), 1)
    stacked = host(counter_matrix(s, cfg.n_peers))
    totals = {nm: int(v) for nm, v in zip(
        tlm.U64_COUNTERS, stacked.astype(np.uint64).sum(axis=0).tolist())}
    ws, wf = totals["walk_success"], totals["walk_fail"]
    # EMPTY_U32 reads as -1 through the int32 view.  The store is ring
    # and staging under the byte diet: the fill is over both capacities.
    store_live = (state.store_gt.view(torch.int32) != -1).sum(
        dim=1, dtype=torch.int32)
    if cfg.store_diet:
        store_live = store_live + (state.sta_gt.view(torch.int32) != -1).sum(
            dim=1, dtype=torch.int32)
    store_cap = cfg.msg_capacity + cfg.store.staging
    cand_live = (state.cand_peer != NO_PEER).sum(dim=1, dtype=torch.float32)
    abm = host(s.accepted_by_meta)
    out = {
        "round": int(state.round_index.view(torch.int32).item()) & EMPTY_U32,
        "sim_time": float(state.time),
        "alive_members": int(members.sum()),
        "killed": int(killed_mask(state.store_meta).sum()),
        "walk_success": ws,
        "walk_fail": wf,
        "walk_success_rate": ws / max(ws + wf, 1),
        **{name: totals[name] for name in tlm.U64_COUNTERS[2:]},
        "store_fill": float((store_live.to(torch.float32)
                             / store_cap).mean()),
        "candidate_fill": float(torch.where(
            members, cand_live / cfg.k_candidates, 0.0).mean())
        * (cfg.n_peers / float(n_members)),
        **health_report(state, cfg),
        "accepted_by_meta": [int(x) for x in
                             abm.astype(np.uint64).sum(axis=0)],
    }
    if cfg.trace.enabled:
        out.update(trace_totals(state, cfg))
    if cfg.overload.enabled:
        out.update(shed_totals(s))
        out["bucket_exhausted"] = int((state.bucket == 0).sum())
    if cfg.recovery.enabled:
        out.update(action_totals(s))
        out["availability"] = availability_of(out["health_flagged"],
                                              cfg.n_peers)
    if cfg.telemetry.histograms:
        for name, _, _ in tlm.hist_specs(cfg):
            out[f"hist_{name}_p50"] = 0
            out[f"hist_{name}_p99"] = 0
            out[f"hist_{name}"] = [0] * cfg.telemetry.hist_buckets
    return out


class MetricsLog:
    """Per-round metrics rows: ``append`` a snapshot (plus extra
    fields), drain the device ring with :meth:`extend_from_ring`, and
    write the run as JSON (``dump``) or JSON lines (``dump_jsonl``)."""

    def __init__(self, meta: dict | None = None):
        self.meta = meta or {}
        self.rows: list[dict] = []

    def append(self, state: PeerState, cfg: CommunityConfig,
               **extra) -> dict:
        row = snapshot(state, cfg)
        row.update(extra)
        self.rows.append(row)
        logger.debug("round %d: %s", row["round"], row)
        return row

    def extend_from_ring(self, state: PeerState,
                         cfg: CommunityConfig) -> list:
        """Append the ring's rows of every round since the last one
        logged (one host transfer); needs ``telemetry.history > 0`` and
        raises when rounds fell out of the ring before the drain.
        Returns the appended rows."""
        if cfg.telemetry.history <= 0:
            raise ValueError("extend_from_ring needs telemetry.history "
                             "> 0 (the device ring is compiled out)")
        rows = tlm.ring_rows(host(state.tele_ring), cfg)
        last = self.rows[-1]["round"] if self.rows else 0
        fresh = [r for r in rows if r["round"] > last]
        if fresh and fresh[0]["round"] > last + 1:
            raise ValueError(
                f"telemetry ring overflowed: oldest available round is "
                f"{fresh[0]['round']} but the log ends at {last} — "
                f"drain at least every telemetry.history="
                f"{cfg.telemetry.history} rounds")
        for row in fresh:
            self.rows.append(row)
            logger.debug("round %d: %s", row["round"], row)
        return fresh

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"meta": self.meta, "rounds": self.rows}, f, indent=1)

    def dump_jsonl(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for row in self.rows:
                f.write(json.dumps(row) + "\n")

    def series(self, key: str) -> list:
        """One metric across rounds."""
        return [row.get(key) for row in self.rows]
