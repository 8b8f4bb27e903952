"""Host-side tools of the chaos harness (port of the functions of
``dispersy_tpu/faults.py``; :class:`~dispersy_tpu_torch.planes.FaultModel`
is the config).

The round's fault branches live in :mod:`engine` and their ops in
:mod:`ops.faults`.  The health sentinels latch into ``state.health``:
"""

from __future__ import annotations

import numpy as np

from dispersy_tpu_torch.config import EMPTY_META, EMPTY_U32, NO_PEER

HEALTH_COUNTER_WRAP = 1 << 0      # a byte counter wrapped this round
HEALTH_STORE_INVARIANT = 1 << 1   # the ring broke sorted / unique / holes-last
HEALTH_INBOX_DROP = 1 << 2        # drops this round >= health_drop_limit
HEALTH_BLOOM_SAT = 1 << 3         # the claimed Bloom is >= 7/8 full

HEALTH_BIT_NAMES = {
    HEALTH_COUNTER_WRAP: "counter_wrap",
    HEALTH_STORE_INVARIANT: "store_invariant",
    HEALTH_INBOX_DROP: "inbox_drop",
    HEALTH_BLOOM_SAT: "bloom_saturated",
}


def host(t) -> np.ndarray:
    """A state leaf on the host as numpy (u32 leaves stay uint32)."""
    return t.detach().cpu().numpy()


def enablement_signature(cfg) -> tuple:
    """The structural enablement bits that size state leaves: the GE
    channel (``ge_bad``) and corruption-or-flood
    (``stats.msgs_corrupt_dropped``)."""
    fm = cfg.faults
    return (fm.ge_enabled, fm.corrupt_rate > 0.0 or fm.flood_enabled)


def health_report(state, cfg) -> dict:
    """The overlay-wide OR of the latched health bits, the flagged-peer
    count and the count per bit."""
    h = host(state.health)
    out = {"health_or": int(np.bitwise_or.reduce(h)) if h.size else 0,
           "health_flagged": int((h != 0).sum())}
    for bit, name in HEALTH_BIT_NAMES.items():
        out[f"health_{name}"] = int(((h & bit) != 0).sum())
    return out


def debug_validate(state, cfg, raise_on_error: bool = False) -> list:
    """Deep host-side check of the structural invariants of a state:
    sorted, unique, holes-last rings; staging a valid prefix; hole
    sentinels; candidate tables without duplicates, self or tracker
    entries; a dense delay pen; clocks and health bits in range.
    Returns the problems found (empty when clean); with
    ``raise_on_error`` raises ``AssertionError`` carrying them."""
    problems: list[str] = []
    n = cfg.n_peers

    def check(cond: bool, msg: str) -> None:
        if not cond:
            problems.append(msg)

    gt = host(state.store_gt)
    member = host(state.store_member)
    meta = host(state.store_meta)
    check(meta.dtype == np.uint8, f"store_meta dtype {meta.dtype} != uint8")
    check(host(state.store_flags).dtype == np.uint8,
          "store_flags dtype drifted from uint8")
    live = gt != EMPTY_U32
    bad = np.flatnonzero(((~live[:, :-1]) & live[:, 1:]).any(axis=1))
    check(bad.size == 0, f"store holes precede live rows on peers "
                         f"{bad[:8].tolist()}")
    g0, g1 = gt[:, :-1], gt[:, 1:]
    m0, m1 = member[:, :-1], member[:, 1:]
    pair_ok = (~live[:, 1:]) | (g0 < g1) | ((g0 == g1) & (m0 < m1))
    bad = np.flatnonzero((~pair_ok).any(axis=1))
    check(bad.size == 0, f"store sort/uniqueness violated on peers "
                         f"{bad[:8].tolist()}")
    check(bool((meta[~live] == EMPTY_META).all()),
          "store holes with non-EMPTY_META meta")
    check(bool((member[~live] == EMPTY_U32).all()),
          "store holes with non-sentinel member")
    sgt = host(state.sta_gt)
    if sgt.shape[1]:
        s_live = sgt != EMPTY_U32
        s_bad = np.flatnonzero(((~s_live[:, :-1]) & s_live[:, 1:])
                               .any(axis=1))
        check(s_bad.size == 0, f"staging holes precede live rows on "
                               f"peers {s_bad[:8].tolist()}")
        check(bool((host(state.sta_meta)[~s_live] == EMPTY_META).all()),
              "staging holes with non-EMPTY_META meta")
    cp = host(state.cand_peer)
    if cp.shape[1] > 1:
        rows = np.sort(cp, axis=1)
        dup = (rows[:, 1:] == rows[:, :-1]) & (rows[:, 1:] != NO_PEER)
        bad = np.flatnonzero(dup.any(axis=1))
        check(bad.size == 0, f"duplicate candidate entries on peers "
                             f"{bad[:8].tolist()}")
    check(not ((cp == np.arange(n)[:, None]) & (cp != NO_PEER)).any(),
          "candidate table contains self-entries")
    check(not ((cp >= 0) & (cp < cfg.n_trackers)
               & (np.arange(n)[:, None] >= cfg.n_trackers)).any(),
          "member candidate tables contain tracker entries")
    dgt = host(state.dly_gt)
    if dgt.shape[1]:
        dlive = dgt != EMPTY_U32
        check(not ((~dlive[:, :-1]) & dlive[:, 1:]).any(),
              "delay pen has gaps (must be dense from slot 0)")
    dsrc = host(state.dly_src)
    check(bool(((dsrc == NO_PEER) | ((dsrc >= 0) & (dsrc < n))).all()),
          "dly_src out of range")
    check(bool((host(state.global_time) >= 1).all()), "global_time below 1")
    check(bool((host(state.health) < 16).all()),
          "health carries undefined bits")
    ge = host(state.ge_bad)
    check(ge.dtype == np.bool_, f"ge_bad dtype {ge.dtype} != bool")
    if raise_on_error and problems:
        raise AssertionError("debug_validate: " + "; ".join(problems))
    return problems
