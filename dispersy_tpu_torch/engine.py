"""The round engine: one walker interval for every peer (port of the
legacy-store and byte-diet rounds of ``dispersy_tpu/engine.py``).

``step(state, cfg)`` advances all peers one round, phase by phase in the
JAX package's order (its phase markers are kept below): churn, walker
send with the Bloom claim, push forwarding, request delivery, request
processing and the tracker fast path, puncture, response processing, the
sync responder, combined intake through the store merge, the forward
buffer, wrap-up.  Every random choice is a counter hash (:mod:`ops.rng`),
so the port equals ``dispersy_tpu.engine.step`` on every leaf.

The slice covers configs whose planes and protocol feature flags sit at
their defaults (:func:`check_slice`) except the permission engine: the
Timeline (authorize / revoke with delegation chains, DynamicResolution
flips, undo-own and undo-other, destroy, and the retroactive re-walk
after a revoke) on the legacy ring, LastSync keep-last-k, and per-meta
priorities and DESC sync; the hardened intake: double-sign
conviction with malicious-proof gossip (a bounded blacklist, the
eyewitness's own proof record, convicted members ejected from the
candidate table), the identity gate and sequence-numbered metas taken
strictly in order; and the chaos planes: the fault model (the
Gilbert–Elliott channel, partitions, duplication, corruption, flooders,
the health sentinels), the recovery pass, overload's token buckets and
priority admission, and the parallel plane (the shard-local ragged
exchange with its capped push buckets, :func:`_deliver`).  Any other
config raises ``NotImplementedError`` before a round starts.  The store is the legacy
ring (merged every round) or the byte-diet store (``store.staging > 0``,
:mod:`storediet`): arrivals land in a staging buffer, the Bloom claim
is a persistent digest salted with an epoch, and the sync exchange and
compaction run on sync rounds only -- for one cohort of peers at a time
under ``store.cohorts > 1``.  The JAX package chooses a round's phase
with a ``lax.cond`` on the round counter; here :func:`step` reads the
round index to the host once per round instead.  The Timeline's retro
pass is the JAX package's other ``lax.cond``: here its trigger is read
to the host, once per round, and so is the recovery pass's (a store
repair or a quarantine wipe anywhere).  The hot ops go through
the wrappers of :mod:`ops` — plain PyTorch for a CPU state, the
hand-written kernels for a CUDA state.

u32 values are carried in int64 between ops (``u32.py``); the store, the
staging buffer and the forward buffer stay in their ``torch.uint32`` /
``uint16`` / ``uint8`` columns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dispersy_tpu_torch import storediet as sdiet
from dispersy_tpu_torch.config import (CONTROL_PRIORITY, EMPTY_META,
                                       EMPTY_U32, IDENTITY_PRIORITY,
                                       INTRO_REQUEST_BASE_BYTES,
                                       INTRO_RESPONSE_BYTES, META_AUTHORIZE,
                                       META_DESTROY, META_DYNAMIC,
                                       META_IDENTITY, META_MALICIOUS,
                                       META_REVOKE,
                                       META_UNDO_OTHER, META_UNDO_OWN,
                                       NO_PEER, PERM_AUTHORIZE, PERM_REVOKE,
                                       PERM_UNDO, PUNCTURE_BYTES,
                                       PUNCTURE_REQUEST_BYTES, RECORD_BYTES,
                                       CommunityConfig, user_perm_mask)
from dispersy_tpu_torch.faults import (HEALTH_BLOOM_SAT,
                                       HEALTH_COUNTER_WRAP,
                                       HEALTH_INBOX_DROP,
                                       HEALTH_STORE_INVARIANT)
from dispersy_tpu_torch.ops import bloom
from dispersy_tpu_torch.ops import candidates as cand
from dispersy_tpu_torch.ops import faults as flt
from dispersy_tpu_torch.ops import inbox, intake
from dispersy_tpu_torch.ops import overload as ovl
from dispersy_tpu_torch.ops import recovery as rcv
from dispersy_tpu_torch.ops import rng
from dispersy_tpu_torch.ops import store as st
from dispersy_tpu_torch.ops import timeline as tl
from dispersy_tpu_torch.ops.hashing import record_hash
from dispersy_tpu_torch.planes import (NUM_HEALTH_BITS, TelemetryConfig,
                                       TraceConfig)
from dispersy_tpu_torch.state import FLAG_UNDONE, NEVER, PeerState
from dispersy_tpu_torch.u32 import (MASK, bits, cast, narrow, narrow16,
                                    unbits, wide, zeros)

# Loss-draw salt blocks (engine.py): one disjoint block per packet kind.
_LOSS_REQUEST = 0 << 16
_LOSS_RESPONSE = 1 << 16
_LOSS_PUNCTURE_REQ = 2 << 16
_LOSS_PUNCTURE = 3 << 16
_LOSS_SYNC = 4 << 16
_LOSS_FORWARD = 5 << 16
_TRACKER_SALT = 1 << 15
_TRACKER_INTRO_SALT = 1 << 20
# The chaos harness: flood sends draw loss from their own block;
# corruption and duplication draw one sub-block per delivery channel.
_LOSS_FLOOD = 16 << 16
_FAULT_SYNC = 0 << 16
_FAULT_PUSH = 1 << 16

# The round's counters that the slice writes; the rest pass through.
_COUNTERS = ("walk_success", "walk_fail", "msgs_stored", "msgs_dropped",
             "requests_dropped", "punctures", "msgs_forwarded", "bytes_up",
             "bytes_down", "accepted_by_meta")
# ... the Timeline's and the blacklist's (zero-width leaves without them).
_TIMELINE_COUNTERS = ("auth_unwound", "msgs_retro")
_MALICIOUS_COUNTERS = ("conflicts", "convictions_rx")
# ... and the chaos planes'.
_OVERLOAD_COUNTERS = ("msgs_shed_rate", "msgs_shed_priority")
_RECOVERY_COUNTERS = ("recov_soft", "recov_backoff", "recov_quarantine")


def check_slice(cfg: CommunityConfig) -> None:
    """Raise ``NotImplementedError`` naming the first field of ``cfg`` that
    is off the ported slice (the legacy or byte-diet store, every plane
    and protocol feature flag at its default but the Timeline, LastSync
    history, meta priorities and DESC sync, the identity gate,
    sequence-numbered metas and double-sign conviction with its gossip,
    and the fault, recovery, overload and parallel planes; public
    NAT)."""
    off = [
        ("sync_enabled", cfg.store_diet and not cfg.sync_enabled),
        ("telemetry", cfg.telemetry != TelemetryConfig()),
        ("trace", cfg.trace != TraceConfig()),
        ("communities", bool(cfg.communities)),
        ("delay_inbox", cfg.delay_inbox > 0),
        ("proof_requests", cfg.proof_requests),
        ("seq_requests", cfg.seq_requests),
        ("msg_requests", cfg.msg_requests),
        ("identity_requests", cfg.identity_requests),
        ("double_meta_mask", bool(cfg.double_meta_mask)),
        ("direct_meta_mask", bool(cfg.direct_meta_mask)),
        ("p_symmetric", cfg.p_symmetric > 0.0),
    ]
    for name, is_off in off:
        if is_off:
            raise NotImplementedError(
                f"CommunityConfig.{name} is off the ported slice (the "
                "legacy-store and byte-diet rounds with every optional "
                "plane and feature flag at its default but the Timeline, "
                "LastSync history, meta priorities, DESC sync, the identity "
                "gate, sequence numbers, double-sign conviction and the "
                "fault, recovery, overload and parallel planes; the diet "
                "needs sync_enabled)")


class _EffFaults(NamedTuple):
    """The round's fault-channel knobs: each ``*_on`` gate and value from
    the static config (the fleet's traced per-replica values are not
    ported)."""
    packet_loss_on: bool
    packet_loss: float
    ge_on: bool
    ge_p_bad: float
    ge_p_good: float
    ge_loss_good: float
    ge_loss_bad: float
    dup_on: bool
    dup_rate: float
    corrupt_on: bool
    corrupt_rate: float


def effective_faults(cfg: CommunityConfig) -> _EffFaults:
    """The static path of the JAX package's ``effective_faults``: the one
    place where the fleet's traced per-replica values would enter."""
    fm = cfg.faults
    return _EffFaults(
        packet_loss_on=cfg.packet_loss > 0.0, packet_loss=cfg.packet_loss,
        ge_on=fm.ge_enabled, ge_p_bad=fm.ge_p_bad, ge_p_good=fm.ge_p_good,
        ge_loss_good=fm.ge_loss_good, ge_loss_bad=fm.ge_loss_bad,
        dup_on=fm.dup_rate > 0.0, dup_rate=fm.dup_rate,
        corrupt_on=fm.corrupt_rate > 0.0, corrupt_rate=fm.corrupt_rate)


def _f32(x: float, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def _fill(mask: torch.Tensor, col: torch.Tensor, fill) -> torch.Tensor:
    """``where(mask, fill, col)`` in ``col``'s dtype (through bit views)."""
    fb = st.fill_bits((), fill, col.dtype, col.device)
    return unbits(torch.where(mask, fb, bits(col)), col.dtype)


def _bcast_edges(col: torch.Tensor, n: int, f: int, c: int) -> torch.Tensor:
    """[N, F] column -> [N·F·C] edge column, each entry repeated C times."""
    b = bits(col)[:, :, None].expand(n, f, c).reshape(-1)
    return unbits(b.contiguous(), col.dtype)


def _lost(kn: _EffFaults, ge_bad, seed, rnd, edge_peer, salt_base: int,
          salt) -> torch.Tensor:
    """Per-packet loss: the base i.i.d. Bernoulli draw ORed with the
    Gilbert–Elliott state-dependent one of ``edge_peer``'s channel (the
    sender's on sends, the receiver's on pickups), from independent
    counter streams."""
    dev = seed.device
    salt = salt if isinstance(salt, torch.Tensor) else torch.tensor(
        salt, device=dev)
    out = None
    if kn.packet_loss_on:
        u = rng.rand_uniform(seed, rnd, edge_peer, rng.P_LOSS,
                             salt + salt_base)
        out = u < _f32(kn.packet_loss, dev)
    if kn.ge_on:
        p = torch.where(ge_bad[edge_peer], _f32(kn.ge_loss_bad, dev),
                        _f32(kn.ge_loss_good, dev))
        g = rng.rand_uniform(seed, rnd, edge_peer, rng.P_GE_LOSS,
                             salt + salt_base) < p
        out = g if out is None else out | g
    if out is None:
        shape = torch.broadcast_shapes(tuple(edge_peer.shape),
                                       tuple(salt.shape))
        return torch.zeros(shape, dtype=torch.bool, device=dev)
    return out


def _deliver(cfg: CommunityConfig, dst, cols, valid, n_peers: int,
             inbox_size: int, cls=None, need_receipts: bool = True,
             capped: bool = False):
    """Route one full-population delivery: :func:`inbox.deliver` when the
    parallel plane is off, the shard-local ragged exchange
    (:func:`inbox.deliver_ragged`) when ``parallel.shards > 1``.  Only
    the ``capped`` channel (the push blast, whose edge count the senders
    choose) rides ``cross_shard_budget``; the others take the exact
    exchange.  Returns ``(Delivery, shed)``, ``shed`` the bool[E]
    sender-side overflow (None unless the cap is armed)."""
    pp = cfg.parallel
    if pp.shards <= 1:
        return inbox.deliver(dst, cols, valid, n_peers, inbox_size,
                             cls), None
    budget = pp.cross_shard_budget if capped else 0
    rd = inbox.deliver_ragged(dst, cols, valid, n_peers, inbox_size,
                              pp.shards, budget, cls, need_receipts)
    return rd.delivery, (rd.shed if budget > 0 else None)


def _blank_tab(tab: cand.CandTable, m: torch.Tensor) -> cand.CandTable:
    """``tab`` with the slots (or rows, for a [N, 1] mask) of ``m``
    emptied."""
    never = _f32(NEVER, m.device)
    return cand.CandTable(
        peer=torch.where(m, NO_PEER, tab.peer),
        last_walk=torch.where(m, never, tab.last_walk),
        last_stumble=torch.where(m, never, tab.last_stumble),
        last_intro=torch.where(m, never, tab.last_intro))


def _wipe_store_cols(m1: torch.Tensor, stc: st.StoreCols) -> st.StoreCols:
    return st.StoreCols(*(_fill(m1, c, f) for c, f in zip(stc, _STORE_FILLS)))


def _rebirth_wipe(mask, tab, stc, fwd, auth, mal, global_time, session,
                  wipe_store: bool = True):
    """The wiped-disk rebirth of the masked peers, shared by churn and the
    quarantine escalation: empty candidate table, store (unless the
    caller wiped it already), forward buffer, auth table and convictions;
    the clock back to 1 and the session bumped."""
    m1 = mask[:, None]
    tab = _blank_tab(tab, m1)
    if wipe_store:
        stc = _wipe_store_cols(m1, stc)
    fwd = tuple(_fill(m1, c, st.empty_of(c.dtype)) for c in fwd)
    # The auth table is folded from the (wiped) store: it wipes too.
    auth = tl.AuthTable(
        member=_fill(m1, auth.member, EMPTY_U32),
        mask=_fill(m1, auth.mask, 0), gt=_fill(m1, auth.gt, 0),
        rev=auth.rev & ~m1, issuer=_fill(m1, auth.issuer, EMPTY_U32))
    # Convictions live in the process's memory: they die with it.
    mal = _fill(m1, mal, EMPTY_U32)
    global_time = torch.where(mask, 1, global_time)
    session = session + mask.to(torch.int64)
    return tab, stc, fwd, auth, mal, global_time, session


def _fold_gt(own, seen, seen_valid, rng_range: int) -> torch.Tensor:
    """Lamport fold over acceptable observed global times (carriers)."""
    acceptable = seen_valid & (seen <= ((own[:, None] + rng_range) & MASK))
    best = torch.where(acceptable, seen, 0).amax(dim=1) \
        if seen.shape[1] else torch.zeros_like(own)
    return torch.maximum(own, best)


def _cand_deq(col: torch.Tensor, cfg: CommunityConfig) -> torch.Tensor:
    """Candidate-timestamp leaf -> f32 sim-seconds.  Under
    ``store.cand_bits == 16`` the leaf is a u16 round-stamp: 0 is never,
    stamp s is ``(s - 1) * walk_interval``; identity otherwise."""
    if col.dtype != torch.uint16:
        return col
    dev = col.device
    w = wide(col)
    sec = (w.to(torch.float32) - _f32(1.0, dev)) * _f32(cfg.walk_interval,
                                                        dev)
    return torch.where(w == 0, _f32(NEVER, dev), sec)


def _cand_quant(col: torch.Tensor, cfg: CommunityConfig) -> torch.Tensor:
    """f32 sim-seconds -> the candidate-timestamp leaf: NEVER -> stamp 0,
    else ``round(sec / walk_interval) + 1`` (half to even, in f32)
    clipped to [1, 65535]; identity unless ``store.cand_bits == 16``."""
    if cfg.store.cand_bits != 16:
        return col
    dev = col.device
    q = torch.round(col / _f32(cfg.walk_interval, dev)).to(torch.int32) + 1
    q = q.clamp(1, 65535).to(torch.int64)
    return narrow16(torch.where(col == _f32(NEVER, dev), 0, q))


def _tab(state: PeerState, cfg: CommunityConfig) -> cand.CandTable:
    return cand.CandTable(peer=state.cand_peer,
                          last_walk=_cand_deq(state.cand_last_walk, cfg),
                          last_stumble=_cand_deq(state.cand_last_stumble,
                                                 cfg),
                          last_intro=_cand_deq(state.cand_last_intro, cfg))


def _store(state: PeerState) -> st.StoreCols:
    return st.StoreCols(gt=state.store_gt, member=state.store_member,
                        meta=state.store_meta, payload=state.store_payload,
                        aux=state.store_aux, flags=state.store_flags)


def _staging(state: PeerState) -> st.StoreCols:
    return st.StoreCols(gt=state.sta_gt, member=state.sta_member,
                        meta=state.sta_meta, payload=state.sta_payload,
                        aux=state.sta_aux, flags=state.sta_flags)


_STORE_FILLS = (EMPTY_U32, EMPTY_U32, EMPTY_META, EMPTY_U32, 0, 0)


# ---- the Timeline's helpers ---------------------------------------------------

def _auth(state: PeerState) -> tl.AuthTable:
    return tl.AuthTable(member=state.auth_member, mask=state.auth_mask,
                        gt=state.auth_gt, rev=state.auth_rev,
                        issuer=state.auth_issuer)


def _founder_col(cfg: CommunityConfig, dev) -> torch.Tensor:
    """u32[N]: the founder each row answers to (one community:
    ``cfg.founder``)."""
    return _u32(cfg.founder, dev).expand(cfg.n_peers)


def killed_mask(store_meta: torch.Tensor) -> torch.Tensor:
    """bool[N]: which peers are hard-killed (their store holds the
    founder's dispersy-destroy-community record)."""
    return (store_meta == META_DESTROY).any(dim=1)


def _priority_vec(cfg: CommunityConfig, meta: torch.Tensor) -> torch.Tensor:
    """int64 serving / forwarding priority per record: the declared
    per-meta priorities for user metas, IDENTITY_PRIORITY for
    dispersy-identity, CONTROL_PRIORITY otherwise."""
    m = meta.to(torch.int64)
    prio = torch.tensor(cfg.priorities, dtype=torch.int64, device=m.device)
    return torch.where(m < cfg.n_meta, prio[m.clamp(max=cfg.n_meta - 1)],
                       torch.where(m == META_IDENTITY, IDENTITY_PRIORITY,
                                   CONTROL_PRIORITY))


def _response_order(stc: st.StoreCols, cfg: CommunityConfig) -> st.StoreCols:
    """The sync responder's serving order over a store: priority DESC,
    then global time ASC or DESC per meta (the JAX package's 4-key sort
    on (255 - priority, gt or ~gt, gt, member), empty slots last).  The
    keys make every live record distinct (UNIQUE(member, gt)) and every
    empty slot the same record, so three stable sorts -- member, gt, then
    the packed (255 - priority, gt or ~gt) -- give the same order.
    Identity when the community declares no ordering."""
    if not cfg.needs_response_order:
        return stc
    g = wide(stc.gt)
    valid = g != EMPTY_U32
    meta = stc.meta.to(torch.int64)
    # 256 stands for the empty key (EMPTY_U32): every priority is <= 255.
    key1 = torch.where(valid, 255 - _priority_vec(cfg, stc.meta), 256)
    desc = (((cfg.desc_meta_mask >> meta.clamp(max=31)) & 1) == 1) \
        & (meta < cfg.n_meta)
    key2 = torch.where(desc, g ^ MASK, g)
    perm = torch.sort(wide(stc.member), dim=-1, stable=True).indices
    for key in (g, (key1 << 32) | key2):
        order = torch.sort(torch.gather(key, -1, perm), dim=-1,
                           stable=True).indices
        perm = torch.gather(perm, -1, order)
    return st.StoreCols(*(unbits(torch.gather(bits(c), -1, perm), c.dtype)
                          for c in stc))


def _author_linear(state: PeerState, cfg: CommunityConfig, meta: int,
                   gt_at: torch.Tensor) -> torch.Tensor:
    """bool[N]: is user meta ``meta`` LinearResolution at ``gt_at`` (u32
    [N]) per each row's own stored dynamic-settings flips (the static
    protected bit when no flip applies or the meta is not dynamic)."""
    n, dev = cfg.n_peers, state.device
    static = bool((cfg.protected_meta_mask >> meta) & 1)
    if not (meta < cfg.n_meta and (cfg.dynamic_meta_mask >> meta) & 1):
        return torch.full((n,), static, dtype=torch.bool, device=dev)
    best = wide(intake.flip_best(_store(state), _u32(meta, dev).expand(n, 1),
                                 gt_at[:, None])[:, 0])
    return torch.where(best > 0, (best & 1) == 1, static)


def _empty_auth(n: int, a: int, dev) -> tl.AuthTable:
    def u32(fill):
        return unbits(st.fill_bits((n, a), fill, torch.uint32, dev),
                      torch.uint32)
    return tl.AuthTable(member=u32(EMPTY_U32), mask=u32(0), gt=u32(0),
                        rev=torch.zeros((n, a), dtype=torch.bool,
                                        device=dev),
                        issuer=u32(EMPTY_U32))


def _rebuild_valid_table(stc: st.StoreCols, cfg: CommunityConfig,
                         founder_col: torch.Tensor, a_slots: int):
    """(table, rows_unwound i32[N]): the auth table as a pure function of
    the store -- every stored authorize/revoke record folded in store
    order into an empty top-A window, re-walked (``tl.revalidate``) and
    compacted (survivors left, order kept)."""
    n = stc.gt.shape[0]
    is_rev_row = stc.meta == META_REVOKE
    is_crow = (stc.meta == META_AUTHORIZE) | is_rev_row
    auth = tl.fold(_empty_auth(n, a_slots, stc.gt.device),
                   target=stc.payload,
                   mask=narrow(wide(stc.aux) & user_perm_mask(cfg.n_meta)),
                   gt=stc.gt, is_revoke=is_rev_row, valid=is_crow,
                   issuer=stc.member).table
    keep = tl.revalidate(auth, founder_col, cfg.n_meta)
    live = bits(auth.member) != -1
    n_unwound = (live & ~keep).sum(-1, dtype=torch.int32)
    rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    slot = torch.where(keep, rank, a_slots)
    auth = tl.AuthTable(*st.rank_compact_many(
        [(auth.member, EMPTY_U32), (auth.mask, 0), (auth.gt, 0),
         (auth.rev, False), (auth.issuer, EMPTY_U32)], slot, a_slots))
    return auth, n_unwound


def _protected_now(meta: torch.Tensor, cfg: CommunityConfig,
                   best) -> torch.Tensor:
    """bool: is each record's meta LinearResolution at its own gt --
    the static protected bit, replaced for dynamic metas by the
    policy of the highest-gt flip at or below it (``best``: the
    ``gt * 2 | policy`` key, 0 for none)."""
    m = meta.to(torch.int64)
    shift = m.clamp(max=31)
    protected = (((cfg.protected_meta_mask >> shift) & 1) == 1) & (m < 32)
    if cfg.dynamic_meta_mask:
        is_dyn = (((cfg.dynamic_meta_mask >> shift) & 1) == 1) \
            & (m < cfg.n_meta)
        b = wide(best)
        linear_now = torch.where(b > 0, (b & 1) == 1, protected)
        protected = torch.where(is_dyn, linear_now, protected)
    return protected


class _Checked(NamedTuple):
    auth: tl.AuthTable            # the table after both fold passes
    accept: torch.Tensor          # bool[N, B]
    flags: torch.Tensor           # u8[N, B] the batch's pre-undone flags
    is_undo: torch.Tensor         # bool[N, B]
    fold_lost: torch.Tensor       # int64[N] rows dropped or evicted
    retro_trigger: torch.Tensor   # bool 0-dim: a fresh revoke or eviction


def _timeline_intake(auth: tl.AuthTable, stc: st.StoreCols,
                     batch: st.StoreCols, cfg: CommunityConfig, in_ok,
                     in_store, dup_in_batch, founder) -> _Checked:
    """The receive pipeline's permission check over the [N, B] batch,
    against the receiver's store and table (the JAX package's intake
    check block).  Control records carry their own authority rule: the
    founder (destroy, and the root of grants), the undoer itself
    (undo-own), or a chain.  Freshly learned authorize / revoke records
    fold first -- pass A the founder's, then the delegated ones that
    ``check_grant`` validates against the updated table (pass B) -- so a
    grant and a record it permits can land in one batch.  Then
    undo-other needs the UNDO bit on the target's stored meta, a flip the
    AUTHORIZE bit on its meta, and a protected user record (LinearResolution
    at its gt, replayed from the stored and this batch's flips) a permit.
    ``founder`` is a u32 [N, 1] column."""
    member, meta, payload, gt, aux = (batch.member, batch.meta, batch.payload,
                                      batch.gt, batch.aux)
    is_auth = meta == META_AUTHORIZE
    is_rev = meta == META_REVOKE
    is_undo_own = meta == META_UNDO_OWN
    is_undo_other = meta == META_UNDO_OTHER
    is_undo = is_undo_own | is_undo_other
    is_flip = meta == META_DYNAMIC
    is_ctrl = is_auth | is_rev | is_undo | is_flip | (meta == META_DESTROY)
    ctrl_ok0 = torch.where(is_undo_own, bits(member) == bits(payload),
                           bits(member) == bits(founder))
    fresh0 = in_ok & ~in_store & ~dup_in_batch
    grant_mask = narrow(wide(aux) & user_perm_mask(cfg.n_meta))
    is_grant = is_auth | is_rev
    fr = tl.fold(auth, target=payload, mask=grant_mask, gt=gt,
                 is_revoke=is_rev, valid=fresh0 & is_grant & ctrl_ok0,
                 issuer=member)
    auth = fr.table
    deleg_ok = is_grant & ~ctrl_ok0 & torch.where(
        is_rev,
        tl.check_grant(auth, member, grant_mask, gt, cfg.n_meta,
                       perm=PERM_REVOKE),
        tl.check_grant(auth, member, grant_mask, gt, cfg.n_meta,
                       perm=PERM_AUTHORIZE))
    fr2 = tl.fold(auth, target=payload, mask=grant_mask, gt=gt,
                  is_revoke=is_rev, valid=fresh0 & deleg_ok, issuer=member)
    auth = fr2.table
    undo_tmeta = intake.stored_meta_of(stc, payload, aux)
    undo_ok = is_undo_other & tl.check(auth, member, undo_tmeta, gt, founder,
                                       perm=PERM_UNDO)
    flip_grant_ok = is_flip & tl.check(auth, member, payload, gt, founder,
                                       perm=PERM_AUTHORIZE)
    ctrl_ok = ctrl_ok0 | deleg_ok | undo_ok | flip_grant_ok
    best = None
    if cfg.dynamic_meta_mask:
        flip_ok = fresh0 & is_flip & (ctrl_ok0 | flip_grant_ok)
        best = narrow(torch.maximum(
            wide(intake.flip_best(stc, meta, gt)),
            wide(intake.flip_best_batch(flip_ok, payload, gt, aux, meta,
                                        gt))))
    protected = _protected_now(meta, cfg, best)
    permitted = tl.check(auth, member, meta, gt, founder)
    accept = in_ok & torch.where(is_ctrl, ctrl_ok,
                                 torch.where(protected, permitted, True))
    # Arrivals whose undo is already stored come in pre-undone.
    pre_undone = (meta < 32) & intake.undo_marked(stc, member, gt)
    flags = torch.where(pre_undone, FLAG_UNDONE, 0).to(torch.uint8)
    evicted = fr.n_evicted + fr2.n_evicted
    lost = (fr.n_dropped + fr2.n_dropped + evicted).to(torch.int64)
    trigger = ((fresh0 & is_rev & (ctrl_ok0 | deleg_ok)).any()
               | (evicted > 0).any())
    return _Checked(auth, accept, flags, is_undo, lost, trigger)


def _retro_pass(auth: tl.AuthTable, stc: st.StoreCols, cfg: CommunityConfig,
                founder_col: torch.Tensor):
    """The retroactive permission re-walk after a revoke folds (or a
    table eviction): rebuild the table from the store, remove the stored
    control records whose authority is gone (authorize / revoke by the
    chain rule, flips by the AUTHORIZE bit), then the protected user
    records no longer permitted, then the undo-other records whose undoer
    or target is gone; re-derive the undone marks and rebuild the table
    from the pruned store.  Returns (auth', store', rows_unwound,
    records_removed), each count i32[N]."""
    a_slots = auth.member.shape[-1]
    auth, n_unwound = _rebuild_valid_table(stc, cfg, founder_col, a_slots)
    fcol = founder_col[:, None]
    user_aux = narrow(wide(stc.aux) & user_perm_mask(cfg.n_meta))
    by_founder = bits(stc.member) == bits(fcol)
    ok_auth = by_founder | tl.check_grant(auth, stc.member, user_aux, stc.gt,
                                          cfg.n_meta, perm=PERM_AUTHORIZE)
    ok_rev = by_founder | tl.check_grant(auth, stc.member, user_aux, stc.gt,
                                         cfg.n_meta, perm=PERM_REVOKE)
    kill = (((stc.meta == META_AUTHORIZE) & ~ok_auth)
            | ((stc.meta == META_REVOKE) & ~ok_rev))
    if cfg.dynamic_meta_mask:
        ok_flip = tl.check(auth, stc.member, stc.payload, stc.gt, fcol,
                           perm=PERM_AUTHORIZE)
        kill = kill | ((stc.meta == META_DYNAMIC) & ~ok_flip)
    r1 = st.store_remove(stc, kill)
    stc = r1.store
    best = (intake.flip_best(stc, stc.meta, stc.gt)
            if cfg.dynamic_meta_mask else None)
    protected = _protected_now(stc.meta, cfg, best)
    permitted = tl.check(auth, stc.member, stc.meta, stc.gt, fcol)
    r2 = st.store_remove(stc, protected & ~permitted)
    stc = r2.store
    undo_tmeta = intake.stored_meta_of(stc, stc.payload, stc.aux)
    ok_undo = tl.check(auth, stc.member, undo_tmeta, stc.gt, fcol,
                       perm=PERM_UNDO)
    r3 = st.store_remove(stc, (stc.meta == META_UNDO_OTHER) & ~ok_undo)
    stc = r3.store
    um = intake.undo_marked(stc, stc.member, stc.gt) & (stc.meta < 32)
    stc = stc._replace(flags=torch.where(um, stc.flags | FLAG_UNDONE,
                                         stc.flags & (0xFF ^ FLAG_UNDONE)))
    auth, _ = _rebuild_valid_table(stc, cfg, founder_col, a_slots)
    return (auth, stc, n_unwound,
            r1.n_removed + r2.n_removed + r3.n_removed)


def _u32(v: int, dev) -> torch.Tensor:
    """A 0-dim ``torch.uint32`` (a host-int salt)."""
    return narrow(torch.tensor(v & MASK, dtype=torch.int64, device=dev))


def _round_host(state: PeerState) -> int:
    """The round index on the host (one device sync)."""
    return int(state.round_index.view(torch.int32).item()) & MASK


def _layout_cols(cfg: CommunityConfig, dev):
    """Per-row (boot_base, boot_count, mem_base, mem_count), single
    community: the global tracker and member ranges."""
    n, t = cfg.n_peers, cfg.n_trackers

    def full(v):
        return torch.full((n,), v, dtype=torch.int32, device=dev)
    return full(0), full(t), full(t), full(n - t)


def _req_bytes_in(req_bytes, ok: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """int64 [rows]: the bytes of the accepted requests of each inbox row
    (a per-peer ``req_bytes`` vector is gathered at each source)."""
    if not isinstance(req_bytes, torch.Tensor):
        return ok.sum(dim=1) * req_bytes
    return torch.where(ok, req_bytes[src.to(torch.int64).clamp(min=0)],
                       0).sum(dim=1)


def _stats_out(state: PeerState, acc: dict):
    """Fold the round's int64 counter deltas into the u32 stats."""
    upd = {name: narrow(wide(getattr(state.stats, name)) + acc[name])
           for name in acc}
    return state.stats.replace(**upd)


def step(state: PeerState, cfg: CommunityConfig,
         phase: str | None = None) -> PeerState:
    """Advance every peer one walker interval (~5 simulated seconds).

    ``phase`` only matters under the byte-diet store
    (``cfg.store.staging > 0``): ``"sync"`` runs the sync exchange and
    compaction round, ``"quiet"`` the staging-only round, and ``None``
    picks the one the round counter's cadence names
    (:func:`storediet.phase_of`).  Under the diet the round index is
    read to the host once per round.  Runs on the state's device and
    never writes into ``state``'s tensors.
    """
    if phase not in (None, "sync", "quiet"):
        raise ValueError(f"unknown step phase {phase!r}: expected 'sync', "
                         "'quiet' or None")
    check_slice(cfg)
    if not cfg.store_diet:
        return _step_impl(state, cfg, "sync", None)
    rnd = _round_host(state)
    return _step_impl(state, cfg, phase or sdiet.phase_of(cfg, rnd), rnd)


def multi_step(state: PeerState, cfg: CommunityConfig, k: int) -> PeerState:
    """Advance ``k`` rounds along the cadence (one host read in all)."""
    check_slice(cfg)
    rnd = _round_host(state) if cfg.store_diet else None
    for _ in range(k):
        if rnd is None:
            state = _step_impl(state, cfg, "sync", None)
        else:
            state = _step_impl(state, cfg, sdiet.phase_of(cfg, rnd), rnd)
            rnd = (rnd + 1) & MASK
    return state


def _step_impl(state: PeerState, cfg: CommunityConfig, phase: str,
               rnd_h: int | None) -> PeerState:
    n, t = cfg.n_peers, cfg.n_trackers
    dev = state.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    idx_u32 = narrow(idx)
    seed = rng.fold_seed(wide(state.key))
    rnd = wide(state.round_index)
    salt = state.round_index            # u32 0-dim: the per-round bloom salt
    now = state.time
    z64 = torch.zeros(n, dtype=torch.int64, device=dev)
    acc = {name: z64.clone() for name in _COUNTERS}
    acc["accepted_by_meta"] = torch.zeros((n, cfg.n_meta + 1),
                                          dtype=torch.int64, device=dev)
    tline = cfg.timeline_enabled
    mal_on = cfg.malicious_enabled
    gossip = mal_on and cfg.malicious_gossip
    if tline:
        acc.update({name: z64.clone() for name in _TIMELINE_COUNTERS})
    if mal_on:
        acc.update({name: z64.clone() for name in _MALICIOUS_COUNTERS})
    # The intake gates that reject (the blacklist counts its own).
    gated = tline or bool(cfg.seq_meta_mask) or cfg.identity_required
    if gated or mal_on:
        acc["msgs_rejected"] = z64.clone()
    # The chaos planes: every branch below is gated on a static knob, so
    # a config with the planes at their defaults runs the round above.
    fm, rc, ov, pp = cfg.faults, cfg.recovery, cfg.overload, cfg.parallel
    kn = effective_faults(cfg)
    if kn.corrupt_on or fm.flood_enabled:
        acc["msgs_corrupt_dropped"] = z64.clone()
    if ov.enabled:
        acc.update({name: z64.clone() for name in _OVERLOAD_COUNTERS})
    if pp.shards > 1 and pp.cross_shard_budget > 0:
        acc["xshard_shed"] = z64.clone()
    if rc.enabled:
        acc.update({name: z64.clone() for name in _RECOVERY_COUNTERS})
        acc["recov_cleared"] = torch.zeros((n, NUM_HEALTH_BITS),
                                           dtype=torch.int64, device=dev)
    bucket_new = state.bucket
    # Each peer's Gilbert–Elliott channel moves once a round; this
    # round's loss draws condition on the new state.
    ge_bad = (flt.ge_advance(state.ge_bad, seed, rnd, idx, kn.ge_p_bad,
                             kn.ge_p_good) if kn.ge_on else state.ge_bad)
    bup, bdown = z64.clone(), z64.clone()
    rng_range = cfg.acceptable_global_time_range
    # Byte-diet store (storediet.py): arrivals land in the staging buffer,
    # the ring merges on sync rounds only, the Bloom claim is the
    # persistent digest, and the sync exchange runs on sync rounds only.
    diet = cfg.store_diet
    sync_on = cfg.sync_enabled and (not diet or phase == "sync")
    compact_now = diet and phase == "sync"
    # Cohort staggering: a sync round runs the claim / serve / compact
    # path for the active cohort's N / cohorts block only; every peer's
    # digest lives at its own cohort's epoch (the per-peer salt).
    stagger = cfg.store_stagger
    if stagger:
        ep = state.epoch
        a_coh = sdiet.active_cohort(cfg, rnd_h)
        ep_a = sdiet.epoch_of_cohort(cfg, rnd_h, a_coh)
        coh = cfg.store.cohorts
    elif diet:
        ep = _u32(sdiet.epoch_of(cfg, rnd_h), dev)
    # A quiet round's request carries no sync tuple; under staggering only
    # the active cohort's walkers carry it on a sync round.
    full_req = INTRO_REQUEST_BASE_BYTES + 4 * cfg.bloom_words
    if stagger and sync_on:
        req_bytes = torch.where(
            wide(state.cohort) == a_coh, full_req,
            INTRO_REQUEST_BASE_BYTES - 20)
    else:
        req_bytes = full_req if sync_on else INTRO_REQUEST_BASE_BYTES - 20

    # ---- phase 0: churn -------------------------------------------------
    # A churned peer restarts with a wiped disk: empty store, staging and
    # digest, empty candidate table and forward buffer, clock reset,
    # session bumped.  Trackers never churn.
    tab, stc = _tab(state, cfg), _store(state)
    sta = _staging(state) if diet else None
    dig = state.digest if diet else None
    epoch = state.epoch
    fwd = (state.fwd_gt, state.fwd_member, state.fwd_meta,
           state.fwd_payload, state.fwd_aux)
    global_time, session = wide(state.global_time), wide(state.session)
    loaded = state.loaded
    auth = _auth(state)
    mal = state.mal_member              # u32 [N, k_malicious] convictions
    health = state.health
    backoff, repair_round = state.backoff, state.repair_round
    quar_until = state.quar_until
    if cfg.churn_rate > 0.0:
        reborn = state.alive & ~state.is_tracker & (
            rng.rand_uniform(seed, rnd, idx, rng.P_CHURN)
            < _f32(cfg.churn_rate, dev))
        m1 = reborn[:, None]
        tab, stc, fwd, auth, mal, global_time, session = _rebirth_wipe(
            reborn, tab, stc, fwd, auth, mal, global_time, session)
        if diet:
            sta = _wipe_store_cols(m1, sta)
            dig = _fill(m1, dig, 0)
        if stagger:
            # The epoch leaf wipes with the store and is re-derived from
            # the round counter and the peer's cohort.
            epoch = narrow(torch.where(
                reborn, sdiet.epoch_of_cohort(cfg, rnd_h, wide(state.cohort)),
                wide(epoch)))
        if fm.health_checks:
            # A restart clears the health latch (the GE channel state is
            # the link's and survives).
            health = _fill(reborn, health, 0)
        if rc.enabled:
            # ... and the process's recovery memory; the quarantine is
            # the overlay's decision about the peer and survives.
            backoff = torch.where(reborn, 0, backoff).to(torch.uint8)
            repair_round = _fill(reborn, repair_round, 0)
        loaded = torch.where(reborn, True, loaded)
    alive = state.alive
    act = alive & loaded            # participating this round
    arrivals = torch.zeros(n, dtype=torch.bool, device=dev)
    # Hard-kill state: a peer whose (post-churn) store holds the founder's
    # destroy record walks, authors and takes in nothing, and serves and
    # pushes only the destroy record.
    killed = killed_mask(stc.meta) if tline else None

    # ---- phase 1: walker send ------------------------------------------
    # dispersy_get_walk_candidate + create_introduction_request; trackers
    # never walk.
    boot_base, boot_count, _, _ = _layout_cols(cfg, dev)
    if cfg.walker_enabled:
        target = cand.sample_walk_target(tab, now, cfg, seed, rnd, idx,
                                         boot_base, boot_count)
        walks = act & ~state.is_tracker
        if tline:
            walks = walks & ~killed
        if rc.enabled:
            # A backed-off peer walks one round in 2^backoff; a
            # quarantined one sits out until its release round.
            if rc.backoff_limit > 0:
                walks = walks & rcv.backoff_gate(rnd, backoff)
            if rc.quarantine_rounds > 0:
                walks = walks & ~rcv.quarantine_active(rnd, quar_until)
        target = torch.where(walks, target, NO_PEER)
    else:
        target = torch.full((n,), NO_PEER, dtype=torch.int32, device=dev)

    if sync_on and stagger:
        # Staggered claim: the serve below reads the requester's slice
        # and digest at the active block directly; nothing rides the wire.
        pass
    elif sync_on and diet:
        # Diet claim: the slice from the ring (unchanged since the last
        # compaction) and the persistent digest as the bloom.
        sl = st.claim_slice_largest(stc.gt, cfg.bloom_capacity)
        my_bloom = dig
    elif sync_on:
        # dispersy_claim_sync_bloom_filter: pick a store slice, fill a
        # bloom salted with the round index (the per-claim filter prefix).
        if cfg.sync_strategy == "modulo":
            sl = st.claim_slice_modulo(stc.gt, cfg.bloom_capacity, rnd)
        else:
            sl = st.claim_slice_largest(stc.gt, cfg.bloom_capacity)
        in_slice = st.slice_mask(stc.gt, sl)
        rec_h = narrow(record_hash(stc.member, stc.gt, stc.meta,
                                   stc.payload))
        my_bloom = bloom.bloom_build(rec_h, in_slice, cfg.bloom_bits,
                                     cfg.bloom_hashes, salt=salt)

    # ---- phase 1f: push forwarding (store_update_forward's _forward) ----
    # Last round's fresh records go to `forward_fanout` distinct verified
    # candidates, one candidate set per peer per round.
    if cfg.forward_fanout > 0 or fm.flood_enabled:
        # Edge-list segments: the real push fan-out, then the flooders'
        # junk blast.  One delivery serves both, so junk competes for the
        # same bounded inboxes (the saturation attack).
        e_dst, e_valid, e_junk = [], [], []
        e_cols: list[list] = [[] for _ in range(5)]
        if ov.enabled:
            # Per-sender token buckets: this round's credit is spent by
            # every attempted push or flood packet in emission order
            # (pre-loss); attempts beyond it are shed at the sender.
            ov_credit = ovl.bucket_refill(state.bucket, seed, rnd, idx,
                                          ov.bucket_rate, ov.bucket_depth)
            ov_shed, ov_att = z64.clone(), z64.clone()
        # With flood junk in the blast the aux column rides in u32 (the
        # JAX package's concatenation promotes a u16 aux).
        aux_dt = torch.uint32 if fm.flood_enabled else fwd[4].dtype
        if cfg.forward_fanout > 0:
            f, c = cfg.forward_buffer, cfg.forward_fanout
            fwd_targets = cand.sample_forward_targets(tab, now, cfg, seed,
                                                      rnd, idx)
            have_rec = (bits(fwd[0]) != -1)[:, :, None]
            tgt_ok = (fwd_targets != NO_PEER)[:, None, :]
            fc_salt = (torch.arange(f, device=dev)[:, None] * c
                       + torch.arange(c, device=dev)[None, :])[None]
            push_lost = _lost(kn, ge_bad, seed, rnd, idx[:, None, None],
                              _LOSS_FORWARD, fc_salt)
            send_rec_ok = act[:, None]
            if tline:
                send_rec_ok = send_rec_ok & (~killed[:, None]
                                             | (fwd[2] == META_DESTROY))
            push_sent = send_rec_ok[:, :, None] & have_rec & tgt_ok
            push_valid = push_sent & ~push_lost
            push_dst = fwd_targets[:, None, :].expand(n, f, c)
            if fm.partitions:
                push_valid = push_valid & ~flt.partition_blocked(
                    idx[:, None, None].expand(n, f, c), push_dst,
                    fm.partitions)
            if ov.enabled:
                # Rate gate: a sender's attempts in (f, c) order past its
                # credit shed (a lost packet still spent its credit).
                att = push_sent.reshape(n, f * c)
                ordn = torch.cumsum(att.to(torch.int64), dim=1) - 1
                in_budget = att & (ordn < ov_credit[:, None])
                ov_shed = ov_shed + (att & ~in_budget).sum(dim=1)
                ov_att = ov_att + att.sum(dim=1)
                push_valid = push_valid & in_budget.reshape(n, f, c)
            e_dst.append(push_dst.reshape(-1))
            e_valid.append(push_valid.reshape(-1))
            for e_col, col in zip(e_cols, fwd[:4] + (cast(fwd[4], aux_dt),)):
                e_col.append(_bcast_edges(col, n, f, c))
            e_junk.append(torch.zeros(n * f * c, dtype=torch.bool,
                                      device=dev))
        if fm.flood_enabled:
            fsrc = torch.tensor(fm.flood_senders, dtype=torch.int64,
                                device=dev)
            fl, ff = len(fm.flood_senders), fm.flood_fanout
            fsalt = torch.arange(ff, device=dev)[None, :]
            victims = (t + rng.rand_u32(seed, rnd, fsrc[:, None],
                                        rng.P_FLOOD, fsalt) % (n - t))

            def junk_field(block):
                return rng.rand_u32(seed, rnd, fsrc[:, None], rng.P_FLOOD,
                                    fsalt + (block << 12)).reshape(-1)
            alive_f = alive[fsrc]
            fl_lost = _lost(kn, ge_bad, seed, rnd, fsrc[:, None], _LOSS_FLOOD,
                            fsalt)
            fl_valid = alive_f[:, None] & ~fl_lost
            if fm.partitions:
                fl_valid = fl_valid & ~flt.partition_blocked(
                    fsrc[:, None].expand(fl, ff), victims, fm.partitions)
            if ov.enabled:
                # Flood blasts spend the same bucket, their ordinals
                # after the sender's real pushes (senders are distinct).
                att_f = alive_f[:, None].expand(fl, ff)
                ordf = ov_att[fsrc][:, None] + fsalt
                in_budget_f = att_f & (ordf < ov_credit[fsrc][:, None])
                ov_shed = ov_shed.index_add(
                    0, fsrc, (att_f & ~in_budget_f).sum(dim=1))
                ov_att = ov_att.index_add(0, fsrc, att_f.sum(dim=1))
                fl_valid = fl_valid & in_budget_f
            e_dst.append(victims.reshape(-1))
            e_valid.append(fl_valid.reshape(-1))
            e_cols[0].append(narrow(junk_field(1)))               # gt
            e_cols[1].append(narrow(junk_field(2)))               # member
            e_cols[2].append((junk_field(3) & 0xFF).to(torch.uint8))
            e_cols[3].append(narrow(junk_field(4)))               # payload
            e_cols[4].append(narrow(junk_field(5)))               # aux
            e_junk.append(torch.ones(fl * ff, dtype=torch.bool, device=dev))
            # The flooder's NIC sends every blast, pre-loss.
            bup = bup.index_add(0, fsrc, alive_f * (ff * RECORD_BYTES))
        push_cols = [unbits(torch.cat([bits(x) for x in cl]), cl[0].dtype)
                     for cl in e_cols]
        if fm.flood_enabled:
            push_cols.append(torch.cat(e_junk))
        if ov.enabled:
            # In-budget attempts drain the balance; the refill lands at
            # the next round's bucket_refill.
            bucket_new = ovl.bucket_spend(ov_credit, ov_att.clamp(min=0))
            acc["msgs_shed_rate"] += ov_shed
        push_cls = None
        if ov.enabled and ov.priority_admission:
            # Priority admission: the wire-visible meta byte classes each
            # packet, and overflow sheds the highest classes first.
            push_cls = ovl.admission_class(push_cols[2], cfg.n_meta,
                                           cfg.priorities).to(torch.uint8)
        push, px_shed = _deliver(
            cfg, torch.cat(e_dst).to(torch.int32).contiguous(), push_cols,
            torch.cat(e_valid).contiguous(), n, cfg.push_inbox, cls=push_cls,
            need_receipts=False, capped=True)
        if px_shed is not None:
            # Edges shed by a full cross-shard bucket left the sender's
            # NIC and died in the exchange: the sender's backpressure
            # count, segment by segment.
            sh = px_shed.to(torch.int64)
            off = 0
            if cfg.forward_fanout > 0:
                acc["xshard_shed"] += sh[:n * f * c].reshape(
                    n, f * c).sum(dim=1)
                off = n * f * c
            if fm.flood_enabled:
                acc["xshard_shed"] = acc["xshard_shed"].index_add(
                    0, fsrc, sh[off:off + fl * ff].reshape(fl, ff).sum(dim=1))
        ph_gt, ph_member, ph_meta, ph_payload, ph_aux = push.inbox[:5]
        if fm.flood_enabled:
            # Junk never decodes, so it loads no community.
            ph_junk = push.inbox[-1]
            arrivals = arrivals | (push.inbox_valid & ~ph_junk).any(dim=1)
        else:
            arrivals = arrivals | push.inbox_valid.any(dim=1)
        ph_ok = push.inbox_valid & act[:, None]
        if ov.enabled:
            # Under the overload plane an inbox overflow is an admission
            # decision: the receiver's priority-shed count, which feeds
            # no health sentinel.
            acc["msgs_shed_priority"] += push.n_dropped
        else:
            acc["msgs_dropped"] += push.n_dropped
        if cfg.forward_fanout > 0:
            acc["msgs_forwarded"] += push_valid.sum(dim=(1, 2))
            bup = bup + push_sent.sum(dim=(1, 2)) * RECORD_BYTES
        bdown = bdown + ph_ok.sum(dim=1) * RECORD_BYTES
        q_sz = ph_ok.shape[1]
        if fm.flood_enabled or kn.corrupt_on:
            # The intake's hash re-check: junk always fails it, a real
            # record with corrupt_rate; either is dropped and counted.
            bad = torch.zeros_like(ph_ok)
            if fm.flood_enabled:
                bad = bad | (ph_ok & ph_junk)
            if kn.corrupt_on:
                cu = rng.rand_uniform(
                    seed, rnd, idx[:, None], rng.P_CORRUPT,
                    torch.arange(q_sz, device=dev)[None, :] + _FAULT_PUSH)
                bad = bad | (ph_ok & (cu < _f32(kn.corrupt_rate, dev)))
            acc["msgs_corrupt_dropped"] += bad.sum(dim=1)
            ph_ok = ph_ok & ~bad
        if kn.dup_on:
            # A clean delivered push arrives twice (the copy joins the
            # batch's tail).
            du = rng.rand_uniform(
                seed, rnd, idx[:, None], rng.P_DUP,
                torch.arange(q_sz, device=dev)[None, :] + _FAULT_PUSH)
            ph_dup_ok = ph_ok & (du < _f32(kn.dup_rate, dev))
            bdown = bdown + ph_dup_ok.sum(dim=1) * RECORD_BYTES
    else:
        p0 = zeros((n, 0), torch.uint32, dev)
        ph_gt = ph_member = ph_payload = ph_aux = p0
        ph_meta = torch.zeros((n, 0), dtype=torch.uint8, device=dev)
        ph_ok = torch.zeros((n, 0), dtype=torch.bool, device=dev)
        ph_dup_ok = ph_ok

    req_lost = _lost(kn, ge_bad, seed, rnd, idx, _LOSS_REQUEST, 0)
    bup = bup + (act & (target != NO_PEER)) * req_bytes
    send_ok = act & (target != NO_PEER) & ~req_lost
    if fm.partitions:
        # A severed walk edge never delivers: the whole exchange dies
        # with the request.
        send_ok = send_ok & ~flt.partition_blocked(idx, target,
                                                   fm.partitions)
    to_tracker = (target >= 0) & (target < t)
    # Requests carry the sender's clock as of round start.
    gt_at_send = narrow(global_time)

    # Under staggering the request is always the 2-column quiet layout:
    # the serve reads the requester's resident digest instead.
    wire_sync = sync_on and not stagger
    if wire_sync:
        req_cols = [idx_u32, narrow(sl.time_low), narrow(sl.time_high),
                    narrow(sl.modulo), narrow(sl.offset), gt_at_send,
                    my_bloom]
    else:
        req_cols = [idx_u32, gt_at_send]
    req, _ = _deliver(cfg, target, req_cols, send_ok & ~to_tracker, n,
                      cfg.request_inbox)
    if wire_sync:
        (rq_src, rq_tlow, rq_thigh, rq_mod, rq_off, rq_gt,
         rq_bloom) = req.inbox
    else:
        rq_src, rq_gt = req.inbox
    arrivals = arrivals | req.inbox_valid.any(dim=1)
    rq_ok = req.inbox_valid & act[:, None]                   # [N, R]
    rq_src_i = torch.where(rq_ok, bits(rq_src), NO_PEER)
    acc["requests_dropped"] += req.n_dropped
    n_rq = rq_ok.sum(dim=1)
    bdown = bdown + _req_bytes_in(req_bytes, rq_ok, rq_src_i)
    bup = bup + n_rq * INTRO_RESPONSE_BYTES

    # ---- phase 2: request processing at the responder ------------------
    # on_introduction_request: stumble the requester, pick a third peer,
    # send introduction-response + puncture-request, serve the slice.
    r = cfg.request_inbox
    tab = cand.upsert_many(
        tab, upd_peer=rq_src_i,
        upd_kind=torch.full((n, r), cand.KIND_STUMBLE, dtype=torch.int32,
                            device=dev),
        upd_valid=rq_ok, now=now, self_idx=idx, n_trackers=t)
    global_time = _fold_gt(global_time, wide(rq_gt), rq_ok, rng_range)

    # ---- phase 2t: the tracker fast path -------------------------------
    if t > 0:
        rt = cfg.tracker_inbox
        k = cfg.k_candidates
        tidx = torch.arange(t, dtype=torch.int64, device=dev)
        treq = inbox.deliver(target, [idx_u32, gt_at_send],
                             send_ok & to_tracker, t, rt)
        tq_src, tq_gt = treq.inbox                           # [T, Rt]
        tq_ok = treq.inbox_valid & act[:t][:, None]
        tq_src_i = torch.where(tq_ok, bits(tq_src), NO_PEER)
        # Recent-contact ring in the tracker's candidate rows: up to K
        # stumbles per round land in rotating unique slots, a returning
        # requester's stale entry cleared first.
        kr = min(rt, k)
        slot = ((rnd * rt + torch.arange(kr, device=dev)) & MASK) % k
        slot_b = slot[None, :].expand(t, kr)
        ring_ok = tq_ok[:, :kr]
        ring_src = tq_src_i[:, :kr]
        stale = ((tab.peer[:t][:, :, None] == ring_src[:, None, :])
                 & ring_ok[:, None, :]).any(dim=-1)           # [T, K]
        never = _f32(NEVER, dev)

        def ring(full, vals, clear):
            full = full.clone()
            rows = full[:t]
            rows.copy_(torch.where(stale, clear, rows))
            cur = torch.gather(rows, 1, slot_b)
            rows.scatter_(1, slot_b, torch.where(ring_ok, vals, cur))
            return full

        tab = cand.CandTable(
            peer=ring(tab.peer, ring_src, NO_PEER),
            last_walk=ring(tab.last_walk, never.expand(t, kr), never),
            last_stumble=ring(tab.last_stumble, now.expand(t, kr), never),
            last_intro=ring(tab.last_intro, never.expand(t, kr), never))
        ttab = cand.CandTable(*(col[:t] for col in tab))
        intro_ring = cand.sample_introductions(
            ttab, now, cfg, seed, rnd, tidx, exclude=tq_src_i,
            salt_base=_TRACKER_INTRO_SALT)                   # [T, Rt]
        # Introduce requester s to another requester of this round's
        # inbox; fall back to the ring pick when that slot is empty.
        s_ix = torch.arange(rt, dtype=torch.int64, device=dev)[None, :]
        jj = ((s_ix + 1 + rng.rand_u32(seed, rnd, tidx[:, None], rng.P_INTRO,
                                       s_ix + _TRACKER_INTRO_SALT + (1 << 18))
               % max(rt - 1, 1)) % rt)
        intro_inbox = torch.gather(tq_src_i, 1, jj)
        intro_inbox = torch.where(intro_inbox == tq_src_i, NO_PEER,
                                  intro_inbox)
        intro_t = torch.where(intro_inbox != NO_PEER, intro_inbox,
                              intro_ring)
        global_time = torch.cat([
            _fold_gt(global_time[:t], wide(tq_gt), tq_ok, rng_range),
            global_time[t:]])
        acc["requests_dropped"][:t] += treq.n_dropped
        n_tq = tq_ok.sum(dim=1)
        bdown[:t] += _req_bytes_in(req_bytes, tq_ok, tq_src_i)
        bup[:t] += (n_tq * INTRO_RESPONSE_BYTES
                    + (tq_ok & (intro_t != NO_PEER)).sum(dim=1)
                    * PUNCTURE_REQUEST_BYTES)
    else:
        rt = 0

    intro = cand.sample_introductions(tab, now, cfg, seed, rnd, idx,
                                      exclude=rq_src_i)      # [N, R]
    bup = bup + (rq_ok & (intro != NO_PEER)).sum(dim=1) \
        * PUNCTURE_REQUEST_BYTES

    # Introduction responses are picked up by receipt (edge_slot), so
    # only the puncture-request hop needs a second delivery:
    # responder -> introduced peer, naming the requester.
    salt_r = torch.arange(r, device=dev)[None, :]
    pr_lost = _lost(kn, ge_bad, seed, rnd, idx[:, None], _LOSS_PUNCTURE_REQ, salt_r)
    pr_ok_send = rq_ok & (intro != NO_PEER) & ~pr_lost
    if fm.partitions:
        pr_ok_send = pr_ok_send & ~flt.partition_blocked(
            idx[:, None].expand(intro.shape), intro, fm.partitions)
    pr_dst = [intro.reshape(-1)]
    pr_target = [rq_src_i.reshape(-1)]
    pr_valid = [pr_ok_send.reshape(-1)]
    if t > 0:
        salt_rt = torch.arange(rt, device=dev)[None, :] + _TRACKER_SALT
        tpr_lost = _lost(kn, ge_bad, seed, rnd, tidx[:, None], _LOSS_PUNCTURE_REQ,
                         salt_rt)
        tpr_ok_send = tq_ok & (intro_t != NO_PEER) & ~tpr_lost
        if fm.partitions:
            tpr_ok_send = tpr_ok_send & ~flt.partition_blocked(
                tidx[:, None].expand(intro_t.shape), intro_t, fm.partitions)
        pr_dst.append(intro_t.reshape(-1))
        pr_target.append(tq_src_i.reshape(-1))
        pr_valid.append(tpr_ok_send.reshape(-1))
    punc_req, _ = _deliver(
        cfg, torch.cat(pr_dst).to(torch.int32),
        [torch.cat(pr_target).to(torch.int32).view(torch.uint32)],
        torch.cat(pr_valid), n, cfg.request_inbox, need_receipts=False)
    (pq_target,) = punc_req.inbox                             # [N, P]
    arrivals = arrivals | punc_req.inbox_valid.any(dim=1)
    pq_ok = punc_req.inbox_valid & act[:, None]
    acc["punctures"] += pq_ok.sum(dim=1)
    acc["requests_dropped"] += punc_req.n_dropped
    n_pq = pq_ok.sum(dim=1)
    bdown = bdown + n_pq * PUNCTURE_REQUEST_BYTES
    bup = bup + n_pq * PUNCTURE_BYTES

    # ---- phase 4: puncture hop (C -> requester) ------------------------
    p = cfg.request_inbox
    salt_p = torch.arange(p, device=dev)[None, :]
    pu_lost = _lost(kn, ge_bad, seed, rnd, idx[:, None], _LOSS_PUNCTURE, salt_p)
    pu_ok_send = pq_ok & ~pu_lost
    if fm.partitions:
        pu_ok_send = pu_ok_send & ~flt.partition_blocked(
            idx[:, None].expand(pq_target.shape), bits(pq_target),
            fm.partitions)
    punc, _ = _deliver(
        cfg, bits(pq_target).reshape(-1),
        [_bcast_edges(idx_u32[:, None], n, 1, p)],
        pu_ok_send.reshape(-1), n, cfg.request_inbox, need_receipts=False)
    (pu_from,) = punc.inbox
    arrivals = arrivals | punc.inbox_valid.any(dim=1)
    pu_ok = punc.inbox_valid & act[:, None]
    acc["requests_dropped"] += punc.n_dropped
    bdown = bdown + pu_ok.sum(dim=1) * PUNCTURE_BYTES

    # ---- phase 3: response processing at the requester -----------------
    # on_introduction_response: mark the responder walked, the introduced
    # peer introduced; a request without a response this round is a
    # failed walk and its stale candidate is dropped.
    tgt = target.to(torch.int64).clamp(min=0)
    slot_n = req.edge_slot.to(torch.int64).clamp(min=0)
    got_n = (req.edge_slot >= 0) & rq_ok[tgt, slot_n]
    intro_n = intro[tgt, slot_n]
    if t > 0:
        slot_t = treq.edge_slot.to(torch.int64).clamp(min=0)
        tgt_t = tgt.clamp(max=t - 1)
        got_t = (treq.edge_slot >= 0) & tq_ok[tgt_t, slot_t]
        got_raw = torch.where(to_tracker, got_t, got_n)
        intro_pick = torch.where(to_tracker, intro_t[tgt_t, slot_t], intro_n)
    else:
        got_raw, intro_pick = got_n, intro_n
    resp_lost = _lost(kn, ge_bad, seed, rnd, idx, _LOSS_RESPONSE, 0)
    got_resp = got_raw & ~resp_lost & act
    bdown = bdown + got_resp * INTRO_RESPONSE_BYTES
    walked = torch.where(got_resp, target, NO_PEER)
    introduced = torch.where(got_resp, intro_pick, NO_PEER)
    rs_gt = global_time[tgt][:, None]                         # responder clock
    rs_ok = got_resp[:, None]
    upd_peer = torch.cat(
        [walked[:, None].to(torch.int32), introduced[:, None].to(torch.int32),
         torch.where(pu_ok, bits(pu_from), NO_PEER)], dim=1)
    upd_kind = torch.cat(
        [torch.full((n, 1), cand.KIND_WALK, dtype=torch.int32, device=dev),
         torch.full((n, 1), cand.KIND_INTRO, dtype=torch.int32, device=dev),
         torch.full((n, p), cand.KIND_STUMBLE, dtype=torch.int32,
                    device=dev)], dim=1)
    tab = cand.upsert_many(tab, upd_peer, upd_kind,
                           upd_valid=upd_peer != NO_PEER, now=now,
                           self_idx=idx, n_trackers=t)
    global_time = _fold_gt(global_time, rs_gt, rs_ok, rng_range)
    walked_ok = act & (target != NO_PEER)
    failed = walked_ok & ~got_resp
    tab = cand.remove(tab, target, failed)
    acc["walk_success"] += walked_ok & got_resp
    acc["walk_fail"] += failed

    # ---- phase 2b/5: sync responder ------------------------------------
    # Per request slot the responder fills an outbox of up to
    # `response_budget` records the requester's bloom lacks, in store
    # order; the requester fetches its outbox row by receipt.
    if sync_on and stagger:
        # Digest-serve: computed per requester of the active cohort's
        # block.  A request holds responder slot edge_slot iff delivery
        # kept it, and rq_ok there equals act at the responder, so
        # gathering the responder's ring at each requester's walk target
        # and serving once per requester visits exactly the (requester,
        # slot) pairs of the per-slot loop.  The probe runs against the
        # requester's resident digest at the cohort's epoch salt.
        b = cfg.response_budget
        blk = n // coh
        idx_blk = torch.arange(blk, dtype=torch.int64, device=dev) * coh \
            + a_coh
        tgt_blk = tgt[idx_blk]                          # responders
        edge_ok = (req.edge_slot >= 0)[idx_blk]
        stv = _response_order(st.StoreCols(
            *(unbits(bits(c)[tgt_blk], c.dtype) for c in stc)), cfg)
        rec_h2 = narrow(record_hash(stv.member, stv.gt, stv.meta,
                                    stv.payload))
        sl_blk = st.claim_slice_largest(st.cohort_take(stc.gt, a_coh, coh),
                                        cfg.bloom_capacity)
        in_sl = st.slice_mask(stv.gt, sl_blk)                # [blk, M]
        present = bloom.bloom_query(st.cohort_take(dig, a_coh, coh), rec_h2,
                                    cfg.bloom_bits, cfg.bloom_hashes,
                                    salt=_u32(ep_a, dev))
        missing = in_sl & ~present & (edge_ok & act[tgt_blk])[:, None]
        rank = torch.cumsum(missing.to(torch.int32), dim=1) - 1
        slot = torch.where(missing & (rank < b), rank, b)
        obox = st.rank_compact_many(
            [(stv.gt, EMPTY_U32), (stv.member, EMPTY_U32),
             (stv.meta, EMPTY_META), (stv.payload, EMPTY_U32),
             (stv.aux, 0), (missing, False)], slot, b)
        # Into the full [N, b] pickup layout, zeros off the block.
        sy_gt, sy_member, sy_meta, sy_payload, sy_aux, sy_cand = (
            st.cohort_set(zeros((n, b), col.dtype, dev), col, a_coh, coh)
            for col in obox)
        sync_lost = _lost(kn, ge_bad, seed, rnd, idx[:, None], _LOSS_SYNC,
                          torch.arange(b, device=dev)[None, :])
        sy_ok = sy_cand & act[:, None] & ~sync_lost
        # Served records leave the responder pre-loss.
        bup = bup.index_add(0, tgt_blk, obox[5].sum(dim=1) * RECORD_BYTES)
        bdown = bdown + sy_ok.sum(dim=1) * RECORD_BYTES
    elif sync_on:
        b = cfg.response_budget
        # The responder serves from its ordered view (priority DESC, gt
        # ASC / DESC per meta; the store itself when nothing is declared).
        # The diet's claim read the digest, so the ring is hashed here and
        # queried with the epoch salt the requesters' digests carry.
        stv = _response_order(stc, cfg)
        if diet or cfg.needs_response_order:
            rec_h = narrow(record_hash(stv.member, stv.gt, stv.meta,
                                       stv.payload))
        q_salt = ep if diet else salt
        servable = None
        if tline:
            servable = ~killed[:, None] | (stv.meta == META_DESTROY)
        outs = []
        for s in range(r):
            sl_s = st.SyncSlice(time_low=rq_tlow[:, s], time_high=rq_thigh[:, s],
                                modulo=rq_mod[:, s], offset=rq_off[:, s])
            in_sl = st.slice_mask(stv.gt, sl_s)
            if tline:
                in_sl = in_sl & servable
            present = bloom.bloom_query(rq_bloom[:, s], rec_h,
                                        cfg.bloom_bits, cfg.bloom_hashes,
                                        salt=q_salt)
            if tline:
                # A hard-killed responder sends the destroy record
                # whatever the requester's Bloom filter says.
                present = present & ~killed[:, None]
            missing = in_sl & ~present & rq_ok[:, s:s + 1]
            rank = torch.cumsum(missing.to(torch.int32), dim=1) - 1
            slot = torch.where(missing & (rank < b), rank, b)
            outs.append(st.rank_compact_many(
                [(stv.gt, EMPTY_U32), (stv.member, EMPTY_U32),
                 (stv.meta, EMPTY_META), (stv.payload, EMPTY_U32),
                 (stv.aux, 0), (missing, False)], slot, b))
        obox = [torch.stack([bits(o[i]) for o in outs], dim=1)
                for i in range(6)]                            # [N, R, b]
        sy_gt, sy_member, sy_meta, sy_payload, sy_aux = (
            unbits(col[tgt, slot_n], dt) for col, dt in zip(
                obox[:5], (stc.gt.dtype, stc.member.dtype, stc.meta.dtype,
                           stc.payload.dtype, stc.aux.dtype)))
        obox_ok = obox[5]
        sync_lost = _lost(kn, ge_bad, seed, rnd, idx[:, None], _LOSS_SYNC,
                          torch.arange(b, device=dev)[None, :])
        sy_ok = (obox_ok[tgt, slot_n] & (req.edge_slot >= 0)[:, None]
                 & act[:, None] & ~sync_lost)
        bup = bup + obox_ok.sum(dim=(1, 2)) * RECORD_BYTES
        bdown = bdown + sy_ok.sum(dim=1) * RECORD_BYTES
    else:
        s0 = zeros((n, 0), torch.uint32, dev)
        sy_gt = sy_member = sy_payload = sy_aux = s0
        sy_meta = torch.zeros((n, 0), dtype=torch.uint8, device=dev)
        sy_ok = torch.zeros((n, 0), dtype=torch.bool, device=dev)
    sy_dup_ok = sy_ok
    if sync_on and (kn.corrupt_on or kn.dup_on):
        b_ix = torch.arange(cfg.response_budget, device=dev)[None, :]
        if kn.corrupt_on:
            # An in-transit bit flip: the record crossed the socket but
            # fails the intake's hash re-check.
            cu = rng.rand_uniform(seed, rnd, idx[:, None], rng.P_CORRUPT,
                                  b_ix + _FAULT_SYNC)
            sy_bad = sy_ok & (cu < _f32(kn.corrupt_rate, dev))
            acc["msgs_corrupt_dropped"] += sy_bad.sum(dim=1)
            sy_ok = sy_ok & ~sy_bad
        if kn.dup_on:
            du = rng.rand_uniform(seed, rnd, idx[:, None], rng.P_DUP,
                                  b_ix + _FAULT_SYNC)
            sy_dup_ok = sy_ok & (du < _f32(kn.dup_rate, dev))
            bdown = bdown + sy_dup_ok.sum(dim=1) * RECORD_BYTES

    # ---- phase 5: combined intake (sync pull + push) -> store ----------
    # One batch per round, sync records first, then pushed records, in
    # delivery order, then (duplication) the duplicated copies of both.
    # The batch's aux column is u32 (a u16 store aux is zero-extended, as
    # the JAX package's concatenation promotes it).
    n_seg = 4 if kn.dup_on else 2

    def cat(a, b_):
        return unbits(torch.cat([bits(a), bits(b_)] * (n_seg // 2), dim=1),
                      a.dtype)
    in_gt, in_member, in_meta, in_payload = (
        cat(a, b_) for a, b_ in ((sy_gt, ph_gt), (sy_member, ph_member),
                                 (sy_meta, ph_meta),
                                 (sy_payload, ph_payload)))
    in_aux = cat(cast(sy_aux, torch.uint32), cast(ph_aux, torch.uint32))
    in_ok = torch.cat([sy_ok, ph_ok]
                      + ([sy_dup_ok, ph_dup_ok] if kn.dup_on else []), dim=1)
    bb = in_gt.shape[1]
    fb = cfg.forward_buffer
    if bb > 0:
        # Clock-jump defense before the store accepts anything.
        in_ok = in_ok & (wide(in_gt) <= ((global_time[:, None] + rng_range)
                                         & MASK))
        if tline:
            # A hard-killed peer takes in nothing at all.
            in_ok = in_ok & ~killed[:, None]
        if mal_on:
            # Double-sign conviction: an arrival matching a stored
            # record's (member, gt) but differing in content convicts its
            # author; then this batch's (and every later) record by a
            # convicted member is rejected.
            pre_mal = mal
            conflict = in_ok & intake.conflict(stc, in_member, in_gt, in_meta,
                                               in_payload, in_aux)
            mf = tl.fold_set(mal, in_member, conflict)
            mal = mf.table
            acc["conflicts"] += mf.n_inserted
            acc["msgs_dropped"] += mf.n_dropped
            mem_b = bits(in_member)[:, :, None]
            if gossip:
                # A gossiped claim (dispersy-malicious-proof) convicts the
                # member it names, unless its claimant is blacklisted
                # after the eyewitness fold.
                black0 = (bits(mal)[:, None, :] == mem_b).any(-1)
                claims = in_ok & ~black0 & (in_meta == META_MALICIOUS)
                cf = tl.fold_set(mal, in_payload, claims)
                mal = cf.table
                acc["convictions_rx"] += cf.n_inserted
                acc["msgs_dropped"] += cf.n_dropped
                # The eyewitness's proof names the batch's first conflict
                # by a member not blacklisted before this batch; it is
                # authored after the store merge (below).
                was_black = (bits(pre_mal)[:, None, :] == mem_b).any(-1)
                gospick = conflict & ~was_black
                gossip_now = gospick.any(1)
                gj = gospick.to(torch.int8).argmax(1, keepdim=True)
                g_member = unbits(torch.gather(bits(in_member), 1, gj),
                                  torch.uint32)                  # [N, 1]
                g_gt = unbits(torch.gather(bits(in_gt), 1, gj), torch.uint32)
            is_black = (bits(mal)[:, None, :] == mem_b).any(-1)
            acc["msgs_rejected"] += (in_ok & is_black).sum(dim=1)
            in_ok = in_ok & ~is_black
        # Freshness: not already stored on UNIQUE(member, global_time) and
        # not a duplicate of an earlier record in this batch.  Under the
        # diet "stored" is a query of the epoch digest, so quiet rounds
        # read no ring bytes; a Bloom false positive drops a fresh record
        # as a duplicate, exactly as in the JAX package.
        if diet:
            in_h = narrow(record_hash(in_member, in_gt, in_meta, in_payload))
            in_store = bloom.bloom_query(dig, in_h, cfg.bloom_bits,
                                         cfg.bloom_hashes, salt=ep)
            dup_in_batch = intake.dup_earlier(in_member, in_gt, in_ok)
        else:
            in_store, dup_in_batch = intake.intake_checks(
                stc.gt, stc.member, in_member, in_gt, in_ok)
        batch = st.StoreCols(gt=in_gt, member=in_member, meta=in_meta,
                             payload=in_payload, aux=in_aux,
                             flags=torch.zeros(in_gt.shape, dtype=torch.uint8,
                                               device=dev))
        if tline:
            founder_col = _founder_col(cfg, dev)
            chk = _timeline_intake(auth, stc, batch, cfg, in_ok, in_store,
                                   dup_in_batch, founder_col[:, None])
            auth, accept = chk.auth, chk.accept
            batch = batch._replace(flags=chk.flags)
            acc["msgs_dropped"] += chk.fold_lost
        else:
            accept = in_ok
        if cfg.identity_required:
            accept = _identity_gate(cfg, stc, batch, accept)
        if cfg.seq_meta_mask:
            accept = accept & _seq_chain_ok(cfg, stc, batch, in_store,
                                            accept)
        if gated:
            acc["msgs_rejected"] += (in_ok & ~accept).sum(dim=1)
        fresh = accept & ~in_store & ~dup_in_batch           # [N, B]
        bucket = torch.where(in_meta.to(torch.int64) < cfg.n_meta,
                             in_meta.to(torch.int64), cfg.n_meta)
        acc["accepted_by_meta"] += (
            (bucket[:, :, None] == torch.arange(cfg.n_meta + 1,
                                                device=dev)[None, None, :])
            & fresh[:, :, None]).sum(dim=1)
        if diet:
            # Fresh records append to the staging buffer; duplicates and
            # staging overflow count as dropped.  msgs_stored counts at
            # compaction, when records enter the ring.
            stg = st.store_stage(sta, batch, new_mask=fresh)
            sta = stg.staging
            acc["msgs_dropped"] += ((accept & ~fresh).sum(dim=1)
                                    + stg.n_dropped)
            if stagger or not compact_now:
                # OR the landed arrivals into the digest so the next claim
                # and freshness test cover them (a cohorts=1 compaction
                # rebuilds it instead; under staggering the active
                # block's rows are rebuilt below).
                dig = bloom.digest_update(dig, in_h, stg.landed,
                                          cfg.bloom_bits, cfg.bloom_hashes,
                                          salt=ep)
        else:
            ins = st.store_insert(stc, batch, new_mask=accept,
                                  history=cfg.history)
            stc = ins.store
            acc["msgs_stored"] += ins.n_inserted
            acc["msgs_dropped"] += (ins.n_dropped.to(torch.int64)
                                    + ins.n_evicted)
        global_time = _fold_gt(global_time, wide(in_gt), accept, rng_range)
        if tline:
            # This batch's accepted undos mark their targets in the
            # post-insert store (an undo and its target landing together
            # still mark); control records are never marked.
            hit = intake.undo_hits_store(stc, in_payload, in_aux,
                                         accept & chk.is_undo)
            hit = hit & (stc.meta < 32)
            stc = stc._replace(flags=torch.where(
                hit, stc.flags | FLAG_UNDONE, stc.flags))
        if gossip:
            # The eyewitness authors its dispersy-malicious-proof record
            # now, after the merge and the clock fold, as a create would:
            # one record a round (payload the convicted member, aux the
            # conflicting global time).
            g_gt_new = (global_time + 1) & MASK
            proof = st.StoreCols(
                gt=narrow(g_gt_new)[:, None], member=idx_u32[:, None],
                meta=torch.full((n, 1), META_MALICIOUS, dtype=torch.uint8,
                                device=dev),
                payload=g_member, aux=g_gt,
                flags=torch.zeros((n, 1), dtype=torch.uint8, device=dev))
            gins = st.store_insert(stc, proof, gossip_now[:, None],
                                   history=cfg.history)
            stc = gins.store
            global_time = torch.where(gossip_now, g_gt_new, global_time)
            acc["msgs_stored"] += gins.n_inserted
            acc["msgs_dropped"] += (gins.n_dropped.to(torch.int64)
                                    + gins.n_evicted)
            acc["accepted_by_meta"][:, cfg.n_meta] += gossip_now
        # Next round's forward batch = F fresh records, aux at the store's
        # width: the first F in batch order, or under a timeline or mixed
        # priorities the F highest-priority ones (ties by batch order).
        if cfg.needs_priority_forward:
            pos = torch.arange(bb, device=dev)
            okey = torch.where(
                fresh, (255 - _priority_vec(cfg, in_meta)) * 4096 + pos,
                EMPTY_U32)
            # The keys of fresh records are distinct: a record's rank
            # among them is its place in the sorted order.
            order = torch.sort(okey, dim=1, stable=True).indices
            rank = torch.empty_like(order).scatter_(
                1, order, pos.expand(n, bb).contiguous())
        else:
            rank = torch.cumsum(fresh.to(torch.int32), dim=1) - 1
        fslot = torch.where(fresh & (rank < fb), rank, fb)
        fwd = tuple(st.rank_compact_many(
            [(col, st.empty_of(col.dtype))
             for col in (in_gt, in_member, in_meta, in_payload,
                         cast(in_aux, state.fwd_aux.dtype))],
            fslot, fb))
        if gossip and fb > 0:
            # The proof takes a forward slot as a create does: the first
            # free one, else the newest relayed entry's.
            put = st.count_valid(fwd[0]).to(torch.int64).clamp(max=fb - 1)
            fwd = tuple(_put_slot(cur, put, gossip_now, val)
                        for cur, val in zip(fwd, proof[:5]))
        if tline:
            # The retro re-walk runs when a fresh revoke folded, or a
            # table eviction displaced a row, anywhere this round (the
            # JAX package's lax.cond; one host read here).
            if bool(chk.retro_trigger.item()):
                auth, stc, n_unw, n_ret = _retro_pass(auth, stc, cfg,
                                                      founder_col)
                acc["auth_unwound"] += n_unw
                acc["msgs_retro"] += n_ret
    else:
        fwd = tuple(
            unbits(st.fill_bits((n, fb), st.empty_of(dt), dt, dev), dt)
            for dt in (torch.uint32, torch.uint32, torch.uint8,
                       torch.uint32, state.fwd_aux.dtype))

    if compact_now and stagger:
        # ---- staggered compaction: the active cohort's block merges its
        # staging into the ring (store_insert semantics), its staging
        # clears, its digest is rebuilt under the cohort's next epoch
        # salt, and its epoch leaf bumps.  The blocks are contiguous
        # copies for the kernels (the slice's cost on the TPU too).  The
        # ring is the caller's and is copied; a non-empty batch made the
        # staging and the digest this round, and they are written in place.
        blk = n // coh
        sta_blk = st.cohort_take_cols(sta, a_coh, coh)
        ins = st.store_insert(st.cohort_take_cols(stc, a_coh, coh), sta_blk,
                              sta_blk.valid, history=cfg.history)
        stc = st.cohort_put_cols(stc, ins.store, a_coh, coh)
        put = st.cohort_set if bb > 0 else st.cohort_put
        sta = st.StoreCols(*(
            put(c, e, a_coh, coh) for c, e in zip(
                sta, st.empty_records((blk, cfg.store.staging),
                                      sta.aux.dtype, dev))))
        st.cohort_take(acc["msgs_stored"], a_coh, coh).add_(ins.n_inserted)
        st.cohort_take(acc["msgs_dropped"], a_coh, coh).add_(
            ins.n_dropped.to(torch.int64) + ins.n_evicted)
        dig = put(dig, _digest_rebuild(ins.store, cfg, ep_a + 1, dev),
                  a_coh, coh)
        epoch = narrow(wide(epoch) + (wide(state.cohort) == a_coh))
    elif compact_now:
        # ---- cohorts=1 compaction: the staging buffer (this round's
        # arrivals included) merges into the ring, clears, and the digest
        # is rebuilt from the new ring under the next epoch's salt.
        ins = st.store_insert(stc, sta, sta.valid, history=cfg.history)
        stc = ins.store
        sta = st.empty_records(sta.gt.shape, sta.aux.dtype, dev)
        acc["msgs_stored"] += ins.n_inserted
        acc["msgs_dropped"] += ins.n_dropped.to(torch.int64) + ins.n_evicted
        dig = _digest_rebuild(stc, cfg, sdiet.epoch_of(cfg, rnd_h) + 1, dev)

    # ---- wrap up --------------------------------------------------------
    if mal_on:
        # Convicted members leave the candidate table: the walker visits
        # no provably malicious peer.
        bad = (tab.peer != NO_PEER) & (
            tab.peer[:, :, None] == bits(mal)[:, None, :]).any(-1)
        tab = _blank_tab(tab, bad)
    if cfg.auto_load:
        # Any community packet that reached an unloaded peer loads its
        # instance for the next round.
        loaded = loaded | (arrivals & alive)
    if fm.health_checks:
        # The health sentinels latch into `health`: a byte counter that
        # wrapped, a broken ring or staging prefix, this round's drops at
        # the limit (the overload and cross-shard sheds are not drops),
        # a claimed Bloom filter 7/8 full.
        old_up = wide(state.stats.bytes_up)
        old_down = wide(state.stats.bytes_down)
        wrapped = ((((old_up + bup) & MASK) < old_up)
                   | (((old_down + bdown) & MASK) < old_down))
        broken = flt.store_invariant_violated(stc.gt, stc.member)
        if diet and cfg.store.staging >= 2:
            hole = bits(sta.gt) == -1
            broken = broken | (hole[:, :-1] & ~hole[:, 1:]).any(dim=1)
        drop_delta = (acc["requests_dropped"] + acc["msgs_dropped"]) & MASK
        hb = (torch.where(wrapped, HEALTH_COUNTER_WRAP, 0)
              | torch.where(broken, HEALTH_STORE_INVARIANT, 0)
              | torch.where(drop_delta >= fm.health_drop_limit,
                            HEALTH_INBOX_DROP, 0))
        if cfg.sync_enabled:
            fill = flt.popcount_u32(dig if diet else my_bloom).sum(dim=1)
            hb = hb | torch.where(fill * 8 >= cfg.bloom_bits * 7,
                                  HEALTH_BLOOM_SAT, 0)
        health_pre = wide(health)
        health = health_pre | hb
    if rc.enabled:
        (tab, stc, sta, dig, fwd, auth, mal, global_time, session, health,
         backoff, repair_round, quar_until) = _recovery_pass(
            cfg, acc, seed, rnd, idx, health_pre, hb, tab, stc, sta, dig,
            fwd, auth, mal, global_time, session, backoff, repair_round,
            quar_until)
    acc["bytes_up"] += bup
    acc["bytes_down"] += bdown
    diet_leaves = {} if not diet else {
        "sta_gt": sta.gt, "sta_member": sta.member, "sta_meta": sta.meta,
        "sta_payload": sta.payload, "sta_aux": sta.aux,
        "sta_flags": sta.flags, "digest": dig, "epoch": epoch}
    return state.replace(
        loaded=loaded, session=narrow(session),
        global_time=narrow(global_time),
        health=narrow(wide(health)), ge_bad=ge_bad, backoff=backoff,
        quar_until=quar_until, repair_round=repair_round, bucket=bucket_new,
        cand_peer=tab.peer.to(torch.int32),
        cand_last_walk=_cand_quant(tab.last_walk, cfg),
        cand_last_stumble=_cand_quant(tab.last_stumble, cfg),
        cand_last_intro=_cand_quant(tab.last_intro, cfg),
        store_gt=stc.gt, store_member=stc.member, store_meta=stc.meta,
        store_payload=stc.payload, store_aux=stc.aux, store_flags=stc.flags,
        **diet_leaves,
        fwd_gt=fwd[0], fwd_member=fwd[1], fwd_meta=fwd[2],
        fwd_payload=fwd[3], fwd_aux=fwd[4],
        auth_member=auth.member, auth_mask=auth.mask, auth_gt=auth.gt,
        auth_rev=auth.rev, auth_issuer=auth.issuer, mal_member=mal,
        stats=_stats_out(state, acc),
        time=now + _f32(cfg.walk_interval, dev),
        round_index=narrow(rnd + 1),
    )


def _recovery_pass(cfg: CommunityConfig, acc: dict, seed, rnd, idx,
                   prev: torch.Tensor, hb: torch.Tensor, tab, stc, sta, dig,
                   fwd, auth, mal, global_time, session, backoff,
                   repair_round, quar_until):
    """The recovery plane's staged repair of the latched sentinels.  Bits
    latched in an earlier round (``prev``) are acted on and cleared;
    this round's (``hb``) stay visible.  A soft repair re-sorts a broken
    ring and flushes the candidate table of a peer flagged for drops
    (bumping its walk backoff); a re-latch within
    ``requarantine_window`` rounds of the last repair escalates to a
    quarantined wiped-disk rebirth, which neighbours honour by ejecting
    the peer from their tables.  The store-wide repairs run only when
    some peer needs one (the JAX package's ``lax.cond``; one host read
    here, which also skips whichever of the two has no peer).  Returns
    the updated leaves."""
    rc = cfg.recovery
    n, dev = cfg.n_peers, idx.device
    rpost = (rnd + 1) & MASK
    prev_on = prev != 0
    no = torch.zeros(n, dtype=torch.bool, device=dev)
    rr = wide(repair_round)
    esc = (prev_on & (rr > 0) & (((rpost - rr) & MASK)
                                 <= rc.requarantine_window)
           if rc.quarantine_rounds > 0 else no)
    rep = prev_on & ~esc if rc.soft_repair else no
    bump = no
    rep_store = (rep & ((prev & HEALTH_STORE_INVARIANT) != 0)
                 if rc.soft_repair else no)
    # One host read for both store-wide steps; a step whose mask is empty
    # anywhere is an identity and is skipped.
    any_rep, any_esc = torch.stack([rep_store.any(), esc.any()]).tolist()
    if any_rep:
        stc = rcv.store_repair(stc, rep_store)
    if any_esc:
        em = esc[:, None]
        stc = _wipe_store_cols(em, stc)
        if cfg.store_diet:
            # The staging buffer and the digest are the store's write
            # buffer and claim view: they wipe with the ring.
            sta = _wipe_store_cols(em, sta)
            dig = _fill(em, dig, 0)
    if rc.soft_repair:
        rep_inbox = rep & ((prev & HEALTH_INBOX_DROP) != 0)
        tab = _blank_tab(tab, rep_inbox[:, None])
        if rc.backoff_limit > 0:
            bump = rep_inbox & (backoff < rc.backoff_limit)
            backoff = backoff + bump.to(torch.uint8)
        rr = torch.where(rep, rpost, rr)
    quar = wide(quar_until)
    if rc.quarantine_rounds > 0:
        tab, stc, fwd, auth, mal, global_time, session = _rebirth_wipe(
            esc, tab, stc, fwd, auth, mal, global_time, session,
            wipe_store=False)
        backoff = torch.where(esc, 0, backoff).to(torch.uint8)
        rr = torch.where(esc, 0, rr)
        quar = torch.where(esc, (rpost + rc.quarantine_rounds) & MASK, quar)
    cleared = torch.where(rep, prev, 0) | torch.where(esc, prev | hb, 0)
    health = torch.where(esc, 0, torch.where(rep, hb, prev | hb))
    if rc.backoff_limit > 0:
        # Backoff decays on clean rounds, one draw per peer.
        ud = rng.rand_uniform(seed, rnd, idx, rng.P_RECOVERY)
        dec = (~(prev_on | (hb != 0)) & (backoff > 0)
               & (ud < _f32(rc.backoff_decay, dev)))
        backoff = backoff - dec.to(torch.uint8)
    if rc.quarantine_rounds > 0:
        safe = tab.peer.to(torch.int64).clamp(0, n - 1)
        qbad = (tab.peer != NO_PEER) & rcv.quarantine_active(rpost,
                                                             quar)[safe]
        tab = _blank_tab(tab, qbad)
    acc["recov_soft"] += rep
    acc["recov_backoff"] += bump
    acc["recov_quarantine"] += esc
    acc["recov_cleared"] += torch.stack(
        [(cleared >> b) & 1 for b in range(NUM_HEALTH_BITS)], dim=1)
    return (tab, stc, sta, dig, fwd, auth, mal, global_time, session, health,
            backoff, narrow(rr), narrow(quar))


def _identity_gate(cfg: CommunityConfig, stc: st.StoreCols,
                   batch: st.StoreCols, accept) -> torch.Tensor:
    """``accept`` (bool[N, B]) through the unknown-member gate: a user
    record needs its author's dispersy-identity record in the receiver's
    store; control records are exempt."""
    have_id = intake.identity_stored(stc, batch.member)
    return accept & ((batch.meta >= cfg.n_meta) | have_id)


def _seq_chain_ok(cfg: CommunityConfig, stc: st.StoreCols,
                  batch: st.StoreCols, in_store, accept) -> torch.Tensor:
    """bool[N, B]: the sequence-chain test of the batch.  A record of a
    sequenced meta that is not already stored passes only if its sequence
    number (``aux``) is one above the highest its (member, meta) has so
    far -- the store's (``seq_stored_max``), raised by the earlier
    entries of this batch that passed and were accepted -- so a chain is
    taken strictly in order, and a gap waits for the Bloom pull to
    re-offer the missing link.  A loop over the batch, as the JAX
    package's ``lax.fori_loop``."""
    meta = batch.meta.to(torch.int64)
    is_seq = ((((cfg.seq_meta_mask >> meta.clamp(max=31)) & 1) == 1)
              & (meta < cfg.n_meta))
    check = is_seq & ~in_store
    best = wide(intake.seq_stored_max(stc, batch.member, batch.meta))
    aux = wide(batch.aux)
    group = (wide(batch.member) << 8) | meta       # one key per (member, meta)
    ok = []
    for j in range(aux.shape[1]):
        aux_j = aux[:, j]
        chain = aux_j == ((best[:, j] + 1) & MASK)
        ok.append(~check[:, j] | chain)
        took = accept[:, j] & check[:, j] & chain
        grp = (group == group[:, j:j + 1]) & took[:, None]
        best = torch.where(grp, torch.maximum(best, aux_j[:, None]), best)
    return torch.stack(ok, dim=1)


def _put_slot(cur: torch.Tensor, put: torch.Tensor, mask: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """``cur`` [N, F] with ``val`` (a column of N values, any unsigned
    width) written at column ``put`` (int64 [N]) on the masked rows."""
    rows = torch.arange(cur.shape[0], device=cur.device)
    cb = bits(cur).clone()
    old = cb[rows, put]
    cb[rows, put] = torch.where(mask, bits(cast(val.reshape(-1), cur.dtype)),
                                old)
    return unbits(cb, cur.dtype)


def _digest_rebuild(stc: st.StoreCols, cfg: CommunityConfig, epoch: int,
                    dev) -> torch.Tensor:
    """The digest of a freshly compacted ring: its claimed slice under
    the salt of ``epoch`` (a u32, wrapping)."""
    sl = st.claim_slice_largest(stc.gt, cfg.bloom_capacity)
    rec_h = narrow(record_hash(stc.member, stc.gt, stc.meta, stc.payload))
    return bloom.bloom_build(rec_h, st.slice_mask(stc.gt, sl),
                             cfg.bloom_bits, cfg.bloom_hashes,
                             salt=_u32(epoch, dev))


def create_messages(state: PeerState, cfg: CommunityConfig,
                    author_mask: torch.Tensor, meta: int,
                    payload: torch.Tensor,
                    aux: torch.Tensor | None = None) -> PeerState:
    """Application send: each masked (and loaded) peer authors one record,
    claims global_time + 1, stores it locally and puts it in its forward
    buffer (displacing the newest relayed entry when the buffer is full).
    On a sequenced meta the author stamps ``aux`` with its next sequence
    number (one above the highest its own store holds), whatever the
    caller passed.

    Control metas (authorize, revoke, undo-own, undo-other,
    dynamic-settings, destroy) need ``timeline_enabled``.  Under a
    timeline the author side of the permission check runs first: each
    control meta's authority rule, and a permit in the author's own table
    for a protected (or currently LinearResolution dynamic) meta; a
    hard-killed peer authors nothing.  An accepted authorize / revoke
    folds into the author's own table at once (with the retro re-walk on
    a revoke or an eviction), and an undo marks its target in the
    author's own store.
    """
    check_slice(cfg)
    control = meta in (META_AUTHORIZE, META_REVOKE, META_UNDO_OWN,
                       META_UNDO_OTHER, META_DYNAMIC, META_DESTROY)
    if control and not cfg.timeline_enabled:
        raise ValueError(
            f"meta {meta:#x} is a permission control message; it needs "
            "timeline_enabled=True (declare a Linear/DynamicResolution "
            "meta or set the flag)")
    n = cfg.n_peers
    dev = state.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    idx_u32 = narrow(idx)
    aux = (torch.zeros(n, dtype=torch.int64, device=dev) if aux is None
           else wide(torch.as_tensor(aux, device=dev)).reshape(n))
    payload = wide(torch.as_tensor(payload, device=dev)).reshape(n)
    author_mask = torch.as_tensor(author_mask, device=dev) & state.loaded
    gt_new = wide(state.global_time) + 1
    auth = _auth(state)
    stats = {}
    if meta < cfg.n_meta and (cfg.seq_meta_mask >> meta) & 1:
        # The author stamps the next sequence number of (itself, meta):
        # one above the highest its own store holds.
        own = ((wide(state.store_member) == idx[:, None])
               & (state.store_meta == meta)
               & (wide(state.store_gt) != EMPTY_U32))
        aux = (torch.where(own, wide(state.store_aux), 0).amax(1) + 1) & MASK
    if cfg.timeline_enabled:
        author_mask = author_mask & _author_allowed(
            state, cfg, meta, narrow(payload), narrow(aux), narrow(gt_new))
        author_mask = author_mask & ~killed_mask(state.store_meta)
    new = st.StoreCols(
        gt=narrow(gt_new)[:, None], member=idx_u32[:, None],
        meta=torch.full((n, 1), meta, dtype=torch.uint8, device=dev),
        payload=narrow(payload)[:, None], aux=narrow(aux)[:, None],
        flags=torch.zeros((n, 1), dtype=torch.uint8, device=dev))
    ins = st.store_insert(_store(state), new, author_mask[:, None],
                          history=cfg.history)
    stc = ins.store
    diet_leaves = {}
    if cfg.store_diet:
        # The record goes straight into the ring, and the digest learns
        # its probe bits under the salt of the round that claims next:
        # the author's own cohort's epoch under staggering.
        salt = (state.epoch if cfg.store_stagger else narrow(
            wide(state.round_index) // cfg.store.compact_every))
        new_h = narrow(record_hash(new.member, new.gt, new.meta,
                                   new.payload))
        diet_leaves["digest"] = bloom.digest_update(
            state.digest, new_h, author_mask[:, None], cfg.bloom_bits,
            cfg.bloom_hashes, salt=salt)
    if cfg.timeline_enabled and meta in (META_AUTHORIZE, META_REVOKE):
        # The author's own table learns its grant / revoke now; a revoke
        # (its gt may sit below rows the table already holds) or an
        # eviction re-walks the table and the store (one host read).
        fr = tl.fold(auth, target=new.payload,
                     mask=narrow(aux & user_perm_mask(cfg.n_meta))[:, None],
                     gt=new.gt,
                     is_revoke=torch.full((n, 1), meta == META_REVOKE,
                                          device=dev),
                     valid=author_mask[:, None], issuer=new.member)
        auth = fr.table
        stats["msgs_dropped"] = (fr.n_dropped + fr.n_evicted).to(torch.int64)
        trigger = (fr.n_evicted > 0).any()
        if meta == META_REVOKE:
            trigger = trigger | author_mask.any()
        if bool(trigger.item()):
            auth, stc, n_unw, n_ret = _retro_pass(auth, stc, cfg,
                                                  _founder_col(cfg, dev))
            stats["auth_unwound"] = n_unw.to(torch.int64)
            stats["msgs_retro"] = n_ret.to(torch.int64)
    if cfg.timeline_enabled and meta in (META_UNDO_OWN, META_UNDO_OTHER):
        # Mark the target row in the author's own store at once.
        hit = (author_mask[:, None]
               & (wide(stc.member) == payload[:, None])
               & (wide(stc.gt) == aux[:, None]) & (stc.meta < 32))
        stc = stc._replace(flags=torch.where(hit, stc.flags | FLAG_UNDONE,
                                             stc.flags))
    fb = cfg.forward_buffer
    fwd = [state.fwd_gt, state.fwd_member, state.fwd_meta,
           state.fwd_payload, state.fwd_aux]
    if fb > 0:
        put = st.count_valid(state.fwd_gt).to(torch.int64).clamp(max=fb - 1)
        fwd = [_put_slot(cur, put, author_mask, col) for cur, col in zip(
            fwd, (new.gt, new.member, new.meta, new.payload, new.aux))]
    abm = wide(state.stats.accepted_by_meta)
    abm[:, min(meta, cfg.n_meta)] += author_mask.to(torch.int64)
    stats["msgs_stored"] = ins.n_inserted.to(torch.int64)
    return state.replace(
        store_gt=stc.gt, store_member=stc.member, store_meta=stc.meta,
        store_payload=stc.payload, store_aux=stc.aux, store_flags=stc.flags,
        **diet_leaves,
        fwd_gt=fwd[0], fwd_member=fwd[1], fwd_meta=fwd[2],
        fwd_payload=fwd[3], fwd_aux=fwd[4],
        auth_member=auth.member, auth_mask=auth.mask, auth_gt=auth.gt,
        auth_rev=auth.rev, auth_issuer=auth.issuer,
        global_time=narrow(torch.where(author_mask, gt_new,
                                       wide(state.global_time))),
        stats=state.stats.replace(
            accepted_by_meta=narrow(abm),
            **{k: narrow(wide(getattr(state.stats, k)) + v)
               for k, v in stats.items()}))


def _author_allowed(state: PeerState, cfg: CommunityConfig, meta: int,
                    payload, aux, gt_new) -> torch.Tensor:
    """bool[N]: the author side of the permission check (u32 [N]
    ``payload``, ``aux`` and claimed ``gt_new``).  Authorize / revoke: the
    founder, or the AUTHORIZE / REVOKE bit for every meta of the mask;
    undo-other: the founder, or the UNDO bit on the target's meta in the
    author's own store; a flip: the founder, or the AUTHORIZE bit on the
    flipped meta; destroy: the founder; undo-own: the author itself; a
    dynamic meta: public at ``gt_new``, or a permit; a protected meta: a
    permit."""
    n, dev = cfg.n_peers, state.device
    auth = _auth(state)
    me = narrow(torch.arange(n, dtype=torch.int64, device=dev))[:, None]
    fcol = _founder_col(cfg, dev)
    is_founder = bits(me[:, 0]) == bits(fcol)
    q_gt = gt_new[:, None]
    if meta in (META_AUTHORIZE, META_REVOKE):
        mask = narrow(wide(aux) & user_perm_mask(cfg.n_meta))[:, None]
        deleg = tl.check_grant(
            auth, me, mask, q_gt, cfg.n_meta,
            perm=PERM_REVOKE if meta == META_REVOKE else PERM_AUTHORIZE)
        return is_founder | deleg[:, 0]
    if meta == META_UNDO_OTHER:
        tmeta = intake.stored_meta_of(_store(state), payload[:, None],
                                      aux[:, None])
        return is_founder | tl.check(auth, me, tmeta, q_gt, fcol[:, None],
                                     perm=PERM_UNDO)[:, 0]
    if meta == META_DYNAMIC:
        return is_founder | tl.check(auth, me, payload[:, None], q_gt,
                                     fcol[:, None], perm=PERM_AUTHORIZE)[:, 0]
    if meta == META_DESTROY:
        return is_founder
    if meta == META_UNDO_OWN:
        return bits(payload) == bits(me[:, 0])
    meta_q = _u32(meta, dev).expand(n, 1)
    if meta < cfg.n_meta and (cfg.dynamic_meta_mask >> meta) & 1:
        permit = tl.check(auth, me, meta_q, q_gt, fcol[:, None])[:, 0]
        return ~_author_linear(state, cfg, meta, gt_new) | permit
    if meta < 32 and (cfg.protected_meta_mask >> meta) & 1:
        return tl.check(auth, me, meta_q, q_gt, fcol[:, None])[:, 0]
    return torch.ones(n, dtype=torch.bool, device=dev)


def seed_overlay(state: PeerState, cfg: CommunityConfig,
                 degree: int) -> PeerState:
    """Pre-seed every peer's candidate table with ``degree`` random walked
    member neighbours, stamped immediately eligible (a duplicate draw
    leaves its slot empty)."""
    n, t = cfg.n_peers, cfg.n_trackers
    if not 0 <= degree <= cfg.k_candidates:
        raise ValueError(f"degree {degree} must be in [0, k_candidates="
                         f"{cfg.k_candidates}]")
    if n - t <= 1:
        raise ValueError("need at least two non-tracker peers to seed an "
                         "overlay")
    if cfg.communities:
        raise NotImplementedError("communities are off the ported slice")
    dev = state.device
    seed = rng.fold_seed(wide(state.key))
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    j = torch.arange(degree, device=dev)[None, :]
    base, span = t, max(n - t, 1)
    nbr = base + rng.rand_u32(seed, 0xE1, idx[:, None], rng.P_GOSSIP,
                              j) % span
    nbr = torch.where(nbr == idx[:, None], base + (nbr - base + 1) % span,
                      nbr)
    earlier = (torch.arange(degree, device=dev)[None, :]
               < torch.arange(degree, device=dev)[:, None])   # [i, j]: j < i
    dup = (nbr[:, :, None] == torch.where(earlier, nbr[:, None, :],
                                          NO_PEER)).any(dim=-1)
    nbr = torch.where(dup, NO_PEER, nbr).to(torch.int32)
    eligible_at = _f32(0.0, dev) - _f32(cfg.eligibility_delay, dev)
    pad = cfg.k_candidates - degree
    never = _f32(NEVER, dev)

    def never_k():
        return torch.full((n, cfg.k_candidates), NEVER, dtype=torch.float32,
                          device=dev)
    # Under cand_bits=16 the negative pre-epoch stamp saturates to the
    # oldest live stamp, as in the JAX package.
    return state.replace(
        cand_peer=torch.cat([nbr, torch.full((n, pad), NO_PEER,
                                             dtype=torch.int32, device=dev)],
                            dim=1),
        cand_last_walk=_cand_quant(torch.cat(
            [torch.where(nbr == NO_PEER, never, eligible_at),
             never.expand(n, pad)], dim=1), cfg),
        cand_last_stumble=_cand_quant(never_k(), cfg),
        cand_last_intro=_cand_quant(never_k(), cfg))


def coverage(state: PeerState, member: int, gt: int, meta: int,
             payload: int) -> torch.Tensor:
    """f32: fraction of alive non-tracker peers whose store holds the
    record (the convergence metric).  The store is the ring and, under
    the byte diet, the staging buffer too."""
    def holds(g, m, t, p):
        return ((wide(g) == gt) & (wide(m) == member)
                & (t.to(torch.int64) == meta)
                & (wide(p) == payload)).any(dim=1)
    has = holds(state.store_gt, state.store_member, state.store_meta,
                state.store_payload)
    if state.sta_gt.shape[1]:
        has = has | holds(state.sta_gt, state.sta_member, state.sta_meta,
                          state.sta_payload)
    syncing = state.alive & ~state.is_tracker
    num = (has & syncing).sum().to(torch.float32)
    den = syncing.sum().clamp(min=1).to(torch.float32)
    return num / den

