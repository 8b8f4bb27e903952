"""Host-side tools of the ingress-protection plane (port of the
functions of ``dispersy_tpu/overload.py``;
:class:`~dispersy_tpu_torch.planes.OverloadConfig` is the config, the
round's branches live in :mod:`engine`, their ops in :mod:`ops.overload`).
"""

from __future__ import annotations

import numpy as np

from dispersy_tpu_torch.config import (META_AUTHORIZE, META_MALICIOUS,
                                       priority_of)
from dispersy_tpu_torch.faults import host


def admission_class(meta: int, n_meta: int, priorities) -> int:
    """Admission class of one wire meta byte (lower wins inbox slots):
    ``255 - priority`` for a user or control meta, 255 for a byte valid
    in neither band (most flood junk)."""
    if meta < n_meta or META_AUTHORIZE <= meta <= META_MALICIOUS:
        return 255 - priority_of(meta, n_meta, priorities)
    return 255


def shed_totals(stats) -> dict:
    """The overlay-wide rate and priority shed totals (zero-width leaves
    read as 0)."""
    out = {}
    for nm in ("msgs_shed_rate", "msgs_shed_priority"):
        col = host(getattr(stats, nm)).astype(np.uint64)
        out[nm] = int(col.sum()) if col.size else 0
    return out


def overload_report(state, cfg, top: int = 4) -> dict:
    """Shed totals, exhausted / min / max bucket levels, and the ``top``
    heaviest rate-shed senders (under a flood, the attackers)."""
    bk = host(state.bucket)
    out = {
        "bucket_exhausted": int((bk == 0).sum()) if bk.size else 0,
        "bucket_min": int(bk.min()) if bk.size else 0,
        "bucket_max": int(bk.max()) if bk.size else 0,
    }
    out.update(shed_totals(state.stats))
    shed = host(state.stats.msgs_shed_rate).astype(np.uint64)
    if shed.size:
        order = np.argsort(shed, kind="stable")[::-1][:top]
        out["top_shed_senders"] = [
            (int(i), int(shed[i])) for i in order if shed[i] > 0]
    else:
        out["top_shed_senders"] = []
    return out


def adapt_state(state, old_cfg, new_cfg):
    """Resize the overload plane's leaves across a flip of
    ``overload.enabled`` (turned on: empty buckets and zero shed
    counters; turned off: dropped), and the telemetry row with them; any
    other swap passes the state through."""
    import torch

    from dispersy_tpu_torch.telemetry import adapt_row_leaves
    from dispersy_tpu_torch.u32 import zeros
    if old_cfg.overload.enabled == new_cfg.overload.enabled:
        return state
    n = new_cfg.n_peers if new_cfg.overload.enabled else 0
    dev = state.device
    state = state.replace(
        bucket=torch.zeros((n,), dtype=torch.uint8, device=dev),
        stats=state.stats.replace(
            msgs_shed_rate=zeros((n,), torch.uint32, dev),
            msgs_shed_priority=zeros((n,), torch.uint32, dev)))
    return adapt_row_leaves(state, old_cfg, new_cfg)
