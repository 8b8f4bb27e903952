"""Aggregate metrics (port of ``snapshot`` in ``dispersy_tpu/metrics.py``).

The telemetry plane's fused row is off the slice, so every aggregate is
reduced here from the state's leaves, the plane reports (health,
overload, recovery) through the host tools of :mod:`faults`,
:mod:`overload` and :mod:`recovery`.
Counters are summed on the host in uint64, as the JAX package does, so
1M-peer byte totals do not wrap.
"""

from __future__ import annotations

import numpy as np
import torch

from dispersy_tpu_torch.config import EMPTY_U32, NO_PEER, CommunityConfig
from dispersy_tpu_torch.engine import killed_mask
from dispersy_tpu_torch.faults import health_report
from dispersy_tpu_torch.overload import shed_totals
from dispersy_tpu_torch.recovery import action_totals, availability_of
from dispersy_tpu_torch.state import PeerState

# telemetry.U64_COUNTERS: every counter a snapshot totals, in row order.
U64_COUNTERS = (
    "walk_success", "walk_fail", "msgs_stored", "msgs_dropped",
    "msgs_rejected", "msgs_forwarded", "msgs_direct", "msgs_delayed",
    "msgs_corrupt_dropped", "requests_dropped", "punctures",
    "sig_signed", "sig_done", "sig_expired", "conflicts",
    "bytes_up", "bytes_down",
)


def _u64_total(col: torch.Tensor) -> int:
    """Sum of a u32 counter leaf (a zero-width leaf totals 0)."""
    return int(col.view(torch.int32).cpu().numpy().view(np.uint32)
               .astype(np.uint64).sum())


def snapshot(state: PeerState, cfg: CommunityConfig) -> dict:
    """Aggregate overlay metrics: the JAX package's snapshot keys (its
    legacy, telemetry-off path), the health report always, the overload
    and recovery reports when their planes are on; the trace plane is
    off the slice."""
    if cfg.telemetry.enabled:
        raise NotImplementedError(
            "the telemetry plane's fused snapshot is not ported yet")
    s = state.stats
    members = state.alive & ~state.is_tracker
    n_members = max(int(members.sum()), 1)
    totals = {name: _u64_total(getattr(s, name)) for name in U64_COUNTERS}
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
    abm = s.accepted_by_meta.view(torch.int32).cpu().numpy().view(np.uint32)
    out = {
        "round": int(state.round_index.view(torch.int32).item()) & EMPTY_U32,
        "sim_time": float(state.time),
        "alive_members": int(members.sum()),
        "killed": int(killed_mask(state.store_meta).sum()),
        "walk_success": ws,
        "walk_fail": wf,
        "walk_success_rate": ws / max(ws + wf, 1),
        **{name: totals[name] for name in U64_COUNTERS[2:]},
        "store_fill": float((store_live.to(torch.float32)
                             / store_cap).mean()),
        "candidate_fill": float(torch.where(
            members, cand_live / cfg.k_candidates, 0.0).mean())
        * (cfg.n_peers / float(n_members)),
        **health_report(state, cfg),
        "accepted_by_meta": [int(x) for x in
                             abm.astype(np.uint64).sum(axis=0)],
    }
    if cfg.overload.enabled:
        out.update(shed_totals(s))
        out["bucket_exhausted"] = int((state.bucket == 0).sum())
    if cfg.recovery.enabled:
        out.update(action_totals(s))
        out["availability"] = availability_of(out["health_flagged"],
                                              cfg.n_peers)
    return out
