"""Host-side tools of the recovery plane (port of the functions of
``dispersy_tpu/recovery.py``;
:class:`~dispersy_tpu_torch.planes.RecoveryConfig` is the config, the
round's pass lives in :mod:`engine`, its ops in :mod:`ops.recovery`).
"""

from __future__ import annotations

import numpy as np

from dispersy_tpu_torch.faults import HEALTH_BIT_NAMES, host
from dispersy_tpu_torch.planes import NUM_HEALTH_BITS


def action_totals(stats) -> dict:
    """The overlay-wide soft-repair, backoff and quarantine totals and the
    clears per health bit (zero-width leaves read as 0)."""
    out = {}
    for nm in ("recov_soft", "recov_backoff", "recov_quarantine"):
        col = host(getattr(stats, nm)).astype(np.uint64)
        out[nm] = int(col.sum()) if col.size else 0
    cl = host(stats.recov_cleared).astype(np.uint64)
    by_bit = cl.sum(axis=0) if cl.size else np.zeros(NUM_HEALTH_BITS,
                                                     np.uint64)
    for b, (_, nm) in enumerate(sorted(HEALTH_BIT_NAMES.items())):
        out[f"recov_cleared_{nm}"] = int(by_bit[b])
    return out


def availability_of(health_flagged: int, n_peers: int) -> float:
    """The fraction of peers unflagged this round."""
    return 1.0 - health_flagged / float(n_peers)


def recovery_report(state, cfg) -> dict:
    """Quarantined and backing-off peer counts, the largest backoff
    exponent, and the action totals."""
    rnd = int(host(state.round_index))
    bo = host(state.backoff)
    qu = host(state.quar_until)
    out = {
        "quarantined": int((qu > rnd).sum()) if qu.size else 0,
        "backing_off": int((bo > 0).sum()) if bo.size else 0,
        "max_backoff": int(bo.max()) if bo.size else 0,
    }
    out.update(action_totals(state.stats))
    return out


def adapt_state(state, old_cfg, new_cfg):
    """Resize the recovery plane's leaves across a flip of
    ``recovery.enabled`` (turned on: no backoff, quarantine or repair
    history and zero counters; turned off: dropped), and the telemetry
    row with them; any other swap passes the state through."""
    import torch

    from dispersy_tpu_torch.telemetry import adapt_row_leaves
    from dispersy_tpu_torch.u32 import zeros
    if old_cfg.recovery.enabled == new_cfg.recovery.enabled:
        return state
    n = new_cfg.n_peers if new_cfg.recovery.enabled else 0
    dev = state.device
    state = state.replace(
        backoff=torch.zeros((n,), dtype=torch.uint8, device=dev),
        quar_until=zeros((n,), torch.uint32, dev),
        repair_round=zeros((n,), torch.uint32, dev),
        stats=state.stats.replace(
            recov_soft=zeros((n,), torch.uint32, dev),
            recov_backoff=zeros((n,), torch.uint32, dev),
            recov_quarantine=zeros((n,), torch.uint32, dev),
            recov_cleared=zeros((n, NUM_HEALTH_BITS), torch.uint32, dev)))
    return adapt_row_leaves(state, old_cfg, new_cfg)
