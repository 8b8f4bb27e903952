"""The round engine: one walker interval for every peer (port of
``dispersy_tpu/engine.py``).

``step(state, cfg)`` advances all peers one round, phase by phase in the
JAX package's order (its phase markers are kept below): churn, walker
send with the Bloom claim, push forwarding, request delivery, request
processing and the tracker fast path, puncture, response processing, the
signature exchange, the sync responder, the delay pen's four request
channels, combined intake through the store merge, the forward buffer and
the pen's rebuild, wrap-up.  Every random choice is a counter hash
(:mod:`ops.rng`), so the port equals ``dispersy_tpu.engine.step`` on
every leaf.

Every field of ``CommunityConfig`` runs.  Several communities
(``cfg.communities``) share the row axis as contiguous blocks -- the
trackers first, block by block, then each block's members -- and each
row walks, bootstraps, seeds its overlay, takes countersigners and
answers to a founder (the block's first member row) inside its own block
(:func:`_layout_cols`).  The permission engine: the Timeline (authorize
/ revoke with delegation chains, DynamicResolution flips, undo-own and
undo-other, destroy, and the retroactive re-walk after a revoke) on the
legacy ring, LastSync keep-last-k, and per-meta priorities and DESC
sync; the hardened intake: double-sign conviction with malicious-proof
gossip (a bounded blacklist, the eyewitness's own proof record,
convicted members ejected from the candidate table), the identity gate
and sequence-numbered metas taken strictly in order; the delay pen: a
record refused only for a missing permit, a sequence gap, an unknown
author or (an undo-other) a missing target parks, and asks its deliverer
for the proof, the missing range, the target or the identity
(:func:`_pen_channel`), whose replies join the round's intake;
double-signed metas (``create_signature_request``, the countersign
exchange, both signers' permits and identities) and direct metas
(received and counted, never stored or forwarded); the community
lifecycle (:func:`unload_members`, :func:`load_members`, ``auto_load``);
the chaos planes: the fault model (the Gilbert–Elliott channel,
partitions, duplication, corruption, flooders, the health sentinels),
the recovery pass, overload's token buckets and priority admission, and
the parallel plane (the shard-local ragged exchange with its capped push
buckets, :func:`_deliver`); the telemetry plane (the packed per-round
row, its device ring, the histograms and the flight recorder) and the
dissemination-tracing plane (per tracked record and peer, the first
arrival, its channel and the duplicates; coverage latches);
symmetric-NAT members (``p_symmetric``).  The store is the
legacy ring (merged every round) or the byte-diet store (``store.staging
> 0``, :mod:`storediet`): arrivals land in a staging buffer, and with the
sync exchange the Bloom claim is a persistent digest salted with an
epoch, and the sync exchange and compaction run on sync rounds only --
for one cohort of peers at a time under ``store.cohorts > 1``; without
it there is no digest, freshness is an exact test against ring and
staging, and the ring still merges on the cadence's sync rounds.  The
JAX package chooses a round's phase with a ``lax.cond`` on the round
counter; here :func:`step` reads the round index to the host once per
round instead.  The Timeline's retro
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
from torch.profiler import record_function

from dispersy_tpu_torch import storediet as sdiet
from dispersy_tpu_torch import telemetry as tlm
from dispersy_tpu_torch import traceplane as trp
from dispersy_tpu_torch.config import (CONTROL_PRIORITY, EMPTY_META,
                                       EMPTY_U32, IDENTITY_PRIORITY,
                                       INTRO_REQUEST_BASE_BYTES,
                                       INTRO_RESPONSE_BYTES, META_AUTHORIZE,
                                       META_DESTROY, META_DYNAMIC,
                                       META_IDENTITY, META_MALICIOUS,
                                       META_REVOKE,
                                       META_UNDO_OTHER, META_UNDO_OWN,
                                       MISSING_IDENTITY_BYTES,
                                       MISSING_MSG_BYTES, MISSING_PROOF_BYTES,
                                       MISSING_SEQ_BYTES, NO_PEER,
                                       PERM_AUTHORIZE, PERM_PERMIT,
                                       PERM_REVOKE, PERM_UNDO, PUNCTURE_BYTES,
                                       PUNCTURE_REQUEST_BYTES, RECORD_BYTES,
                                       SIGNATURE_REQUEST_BYTES,
                                       SIGNATURE_RESPONSE_BYTES,
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
from dispersy_tpu_torch.ops import telemetry as tele
from dispersy_tpu_torch.ops import timeline as tl
from dispersy_tpu_torch.ops import trace as trc
from dispersy_tpu_torch.ops.hashing import record_hash
from dispersy_tpu_torch.planes import NUM_HEALTH_BITS
from dispersy_tpu_torch.state import (FLAG_UNDONE, NEVER, PeerState,
                                      wipe_instance_memory)
from dispersy_tpu_torch.u32 import (MASK, bits, cast, narrow, narrow16,
                                    unbits, wide, zeros)

# Loss-draw salt blocks (engine.py): one disjoint block per packet kind.
_LOSS_REQUEST = 0 << 16
_LOSS_RESPONSE = 1 << 16
_LOSS_PUNCTURE_REQ = 2 << 16
_LOSS_PUNCTURE = 3 << 16
_LOSS_SYNC = 4 << 16
_LOSS_FORWARD = 5 << 16
_LOSS_SIGREQ = 6 << 16
_LOSS_SIGRESP = 7 << 16
_LOSS_PROOF_REQ = 8 << 16
_LOSS_PROOF_RESP = 9 << 16
_LOSS_SEQ_REQ = 10 << 16
_LOSS_SEQ_RESP = 11 << 16
_LOSS_MSG_REQ = 12 << 16
_LOSS_MSG_RESP = 13 << 16
_LOSS_ID_REQ = 14 << 16
_LOSS_ID_RESP = 15 << 16
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


class _RoundCtx(NamedTuple):
    """What a pen channel reads of the round: the config, the fault
    knobs and channel states, the counter stream, the participants, the
    hard-killed mask (None without a timeline) and the counters."""
    cfg: CommunityConfig
    kn: _EffFaults
    ge_bad: torch.Tensor
    seed: torch.Tensor
    rnd: torch.Tensor
    idx: torch.Tensor
    act: torch.Tensor
    killed: torch.Tensor | None
    acc: dict


class _Seg(NamedTuple):
    """One segment of the round's intake batch: its record columns and
    validity [N, W], each entry's deliverer (int32, None without the
    pen) and the segment's lineage channel."""
    gt: torch.Tensor
    member: torch.Tensor
    meta: torch.Tensor
    payload: torch.Tensor
    aux: torch.Tensor
    ok: torch.Tensor
    src: torch.Tensor | None
    chan: int


class _Replies(NamedTuple):
    """One pen channel's replies as intake columns [N, D * budget]."""
    cols: tuple          # (gt, member, meta, payload, aux) in store dtypes
    ok: torch.Tensor     # bool: a reply arrived
    src: torch.Tensor    # int32: the serving peer
    bup: torch.Tensor    # int64 [N] bytes each peer sent on the channel
    bdown: torch.Tensor  # int64 [N] bytes each peer received
    arrived: torch.Tensor  # bool [N] a request reached the peer


def _pen_channel(rt: _RoundCtx, stc: st.StoreCols, dl_src, want, req_cols,
                 serve, budget: int, from_end: bool, salt_req: int,
                 salt_resp: int, req_bytes: int, name: str) -> _Replies:
    """One request/serve/receipt round trip of the delay pen, shared by
    the proof, sequence, message and identity channels.  Each pen slot
    where ``want`` holds sends ``req_cols`` (u32 or u8 [N, D]) to its
    deliverer ``dl_src``; a server takes up to ``proof_inbox`` requests,
    and for request slot ``s`` serves the up-to-``budget`` store rows of
    ``serve(inbox_cols, s)`` (bool [N, M]) in store order, or from the
    ring's end with ``from_end`` -- one K4 compaction of the six columns
    a slot.  The requester picks its reply up by receipt.  Counts
    ``{name}_requests`` at the server and ``{name}_records`` at the
    requester."""
    cfg, acc, idx, act = rt.cfg, rt.acc, rt.idx, rt.act
    n, dd = dl_src.shape
    dev = dl_src.device
    lost = _lost(rt.kn, rt.ge_bad, rt.seed, rt.rnd, idx[:, None], salt_req,
                 torch.arange(dd, device=dev)[None, :])
    bup = want.sum(dim=1) * req_bytes
    send = want & ~lost
    if cfg.faults.partitions:
        send = send & ~flt.partition_blocked(
            idx[:, None].expand(n, dd), dl_src, cfg.faults.partitions)
    rq, _ = _deliver(cfg, dl_src.reshape(-1),
                     [c.reshape(-1) for c in req_cols], send.reshape(-1), n,
                     cfg.proof_inbox)
    q_ok = rq.inbox_valid & act[:, None]
    if rt.killed is not None:
        q_ok = q_ok & ~rt.killed[:, None]
    acc[f"{name}_requests"] = q_ok.sum(dim=1)
    acc["requests_dropped"] += rq.n_dropped
    bdown = q_ok.sum(dim=1) * req_bytes
    cols = [(stc.gt, EMPTY_U32), (stc.member, EMPTY_U32),
            (stc.meta, EMPTY_META), (stc.payload, EMPTY_U32), (stc.aux, 0)]
    outs = []
    for s in range(cfg.proof_inbox):
        m_s = serve(rq.inbox, s) & q_ok[:, s:s + 1]            # [N, M]
        mi = m_s.to(torch.int32)
        if from_end:
            rank = torch.cumsum(mi.flip(1), dim=1).flip(1) - 1
        else:
            rank = torch.cumsum(mi, dim=1) - 1
        slot = torch.where(m_s & (rank < budget), rank, budget)
        outs.append(st.rank_compact_many(cols + [(m_s, False)], slot,
                                         budget))
    box = [torch.stack([bits(o[i]) for o in outs], dim=1)
           for i in range(6)]                                   # [N, Pi, b]
    bup = bup + box[5].sum(dim=(1, 2)) * RECORD_BYTES
    # Pen slot (i, d)'s reply sits at edge_slot[i * D + d] of server
    # dl_src[i, d]'s outbox (indices clamped before the gather).
    src_flat = dl_src.reshape(-1).to(torch.int64).clamp(min=0)
    eslot = rq.edge_slot.to(torch.int64).clamp(min=0)
    got = ((rq.edge_slot >= 0) & q_ok[src_flat, eslot]).reshape(n, dd)

    def pick(col):
        return col[src_flat, eslot].reshape(n, dd * budget)
    rcols = tuple(unbits(pick(b), c.dtype) for b, (c, _) in zip(box, cols))
    resp_lost = _lost(rt.kn, rt.ge_bad, rt.seed, rt.rnd, idx[:, None],
                      salt_resp,
                      torch.arange(dd * budget, device=dev)[None, :])
    ok = (pick(box[5]) & got.repeat_interleave(budget, dim=1)
          & act[:, None] & ~resp_lost)
    acc[f"{name}_records"] = ok.sum(dim=1)
    bdown = bdown + ok.sum(dim=1) * RECORD_BYTES
    return _Replies(rcols, ok, dl_src.repeat_interleave(budget, dim=1), bup,
                    bdown, rq.inbox_valid.any(dim=1))


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


_DLY_FILLS = (EMPTY_U32, EMPTY_U32, EMPTY_META, EMPTY_U32, 0, 0, NO_PEER)


def _rebirth_wipe(mask, tab, stc, fwd, dly, auth, sig, mal, global_time,
                  session, wipe_store: bool = True):
    """The wiped-disk rebirth of the masked peers, shared by churn and the
    quarantine escalation: empty candidate table, store (unless the
    caller wiped it already), forward buffer, delay pen, auth table,
    signature cache and convictions; the clock back to 1 and the session
    bumped."""
    m1 = mask[:, None]
    tab = _blank_tab(tab, m1)
    if wipe_store:
        stc = _wipe_store_cols(m1, stc)
    fwd = tuple(_fill(m1, c, st.empty_of(c.dtype)) for c in fwd)
    # The pen and the signature cache live in the process's memory.
    dly = tuple(_fill(m1, c, f) for c, f in zip(dly, _DLY_FILLS))
    if sig[0].shape[0]:
        sig = (torch.where(mask, NO_PEER, sig[0]),) + tuple(
            _fill(mask, c, 0) for c in sig[1:])
    # The auth table is folded from the (wiped) store: it wipes too.
    auth = tl.AuthTable(
        member=_fill(m1, auth.member, EMPTY_U32),
        mask=_fill(m1, auth.mask, 0), gt=_fill(m1, auth.gt, 0),
        rev=auth.rev & ~m1, issuer=_fill(m1, auth.issuer, EMPTY_U32))
    # Convictions live in the process's memory: they die with it.
    mal = _fill(m1, mal, EMPTY_U32)
    global_time = torch.where(mask, 1, global_time)
    session = session + mask.to(torch.int64)
    return tab, stc, fwd, dly, auth, sig, mal, global_time, session


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
    """u32[N]: the founder each row's community answers to: with several
    communities each block's first member row, else ``cfg.founder``."""
    if cfg.communities:
        return narrow(_layout_cols(cfg, dev)[2].to(torch.int64))
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
    parkable: torch.Tensor | None  # bool[N, B] may park (None: no pen)
    fold_lost: torch.Tensor       # int64[N] rows dropped or evicted
    retro_trigger: torch.Tensor   # bool 0-dim: a fresh revoke or eviction


def _timeline_intake(auth: tl.AuthTable, stc: st.StoreCols,
                     batch: st.StoreCols, cfg: CommunityConfig, in_ok,
                     in_store, dup_in_batch, founder,
                     is_dbl=None) -> _Checked:
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
    at its gt, replayed from the stored and this batch's flips) a permit,
    for a double-signed record (``is_dbl``) both signers' permits.  With
    the pen, ``parkable`` marks the entries that may wait in it.
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
    deleg_ok = is_grant & ~ctrl_ok0 & tl.check_grant_rev(
        auth, member, grant_mask, gt, is_rev, cfg.n_meta)
    fr2 = tl.fold(auth, target=payload, mask=grant_mask, gt=gt,
                  is_revoke=is_rev, valid=fresh0 & deleg_ok, issuer=member)
    auth = fr2.table
    # The undo, flip and permit checks share one table walk.
    undo_tmeta = intake.stored_meta_of(stc, payload, aux)
    undo_held, flip_held, permitted = tl.check_many(
        auth, member, ((undo_tmeta, PERM_UNDO), (payload, PERM_AUTHORIZE),
                       (meta, PERM_PERMIT)), gt, founder)
    undo_ok = is_undo_other & undo_held
    flip_grant_ok = is_flip & flip_held
    ctrl_ok = ctrl_ok0 | deleg_ok | undo_ok | flip_grant_ok
    best = None
    if cfg.dynamic_meta_mask:
        flip_ok = fresh0 & is_flip & (ctrl_ok0 | flip_grant_ok)
        best = narrow(torch.maximum(
            wide(intake.flip_best(stc, meta, gt)),
            wide(intake.flip_best_batch(flip_ok, payload, gt, aux, meta,
                                        gt))))
    protected = _protected_now(meta, cfg, best)
    if cfg.double_meta_mask & (cfg.protected_meta_mask
                               | cfg.dynamic_meta_mask):
        # The countersigner (aux) needs the permit too.
        permitted = permitted & torch.where(
            is_dbl, tl.check(auth, aux, meta, gt, founder), True)
    accept = in_ok & torch.where(is_ctrl, ctrl_ok,
                                 torch.where(protected, permitted, True))
    parkable = None
    if cfg.delay_enabled:
        # A user record may park; of the control records only a refused
        # undo-other, under msg_requests (its target may be in flight).
        parkable = ~is_ctrl
        if cfg.msg_requests:
            parkable = parkable | (is_undo_other & in_ok & ~accept)
    # Arrivals whose undo is already stored come in pre-undone.
    pre_undone = (meta < 32) & intake.undo_marked(stc, member, gt)
    flags = torch.where(pre_undone, FLAG_UNDONE, 0).to(torch.uint8)
    evicted = fr.n_evicted + fr2.n_evicted
    lost = (fr.n_dropped + fr2.n_dropped + evicted).to(torch.int64)
    trigger = ((fresh0 & is_rev & (ctrl_ok0 | deleg_ok)).any()
               | (evicted > 0).any())
    return _Checked(auth, accept, flags, is_undo, parkable, lost, trigger)


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
    is_rev = stc.meta == META_REVOKE
    # Authorize and revoke records are disjoint: one walk, the perm by meta.
    kill = (((stc.meta == META_AUTHORIZE) | is_rev)
            & ~(by_founder | tl.check_grant_rev(auth, stc.member, user_aux,
                                                stc.gt, is_rev, cfg.n_meta)))
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
    if cfg.double_meta_mask & (cfg.protected_meta_mask
                               | cfg.dynamic_meta_mask):
        m = stc.meta.to(torch.int64)
        is_dbl = ((((cfg.double_meta_mask >> m.clamp(max=31)) & 1) == 1)
                  & (m < cfg.n_meta))
        permitted = permitted & torch.where(
            is_dbl, tl.check(auth, stc.aux, stc.meta, stc.gt, fcol), True)
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


def _layout_cols(cfg: CommunityConfig, dev, idx=None):
    """Per-row (boot_base, boot_count, mem_base, mem_count) int32 columns
    of the rows ``idx`` (int64, default every row).  One community: the
    global tracker and member ranges.  Several: each row's own block,
    found by ``searchsorted(..., right=True)`` over the block boundaries
    (trackers first, block by block, then each block's members), as
    ``CommunityConfig.layout()`` lays them out."""
    n, t = cfg.n_peers, cfg.n_trackers
    if not cfg.communities:
        def full(v):
            return torch.full((n,) if idx is None else idx.shape, v,
                              dtype=torch.int32, device=dev)
        return full(0), full(t), full(t), full(n - t)
    if idx is None:
        idx = torch.arange(n, dtype=torch.int64, device=dev)
    t_c = [tc for _, tc in cfg.communities]
    m_c = [mc for mc, _ in cfg.communities]
    t_cum, m_cum = [0], [t]
    for a, b in zip(t_c, m_c):
        t_cum.append(t_cum[-1] + a)
        m_cum.append(m_cum[-1] + b)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)
    rows = idx.to(torch.int32)
    comm = torch.where(
        rows < t, torch.searchsorted(i32(t_cum[1:]), rows, right=True),
        torch.searchsorted(i32(m_cum[1:]), rows, right=True))
    return (i32(t_cum[:-1])[comm], i32(t_c)[comm], i32(m_cum[:-1])[comm],
            i32(m_c)[comm])


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


def counter_matrix(stats, n: int) -> torch.Tensor:
    """u32[N, len(U64_COUNTERS)]: every snapshot counter as a column, in
    ``telemetry.U64_COUNTERS`` order; a compiled-out (zero-width) leaf
    reads as a zero column."""
    return narrow(torch.stack(
        [wide(c) if c.shape[0] == n else torch.zeros(
            n, dtype=torch.int64, device=c.device)
         for c in (getattr(stats, nm) for nm in tlm.U64_COUNTERS)], dim=1))


def _telemetry_row(cfg: CommunityConfig, *, rnd, new_time, members, stats,
                   stc, health, store_cnt, cand_cnt, hists, bucket=None,
                   trace_cov=None, trace_latch=None) -> torch.Tensor:
    """The packed per-round telemetry row, u32[row_width], laid out by
    ``telemetry.row_schema``: counter totals as exact u64 (lo, hi) pairs,
    occupancy numerators, per-bit health counts, the trace, overload and
    recovery words with their planes, histogram buckets.  Reduced on the
    state's device with no host read: every u32 counter column in one
    matrix and two reductions, every field a view of a few results."""
    n, dev = cfg.n_peers, members.device
    n64 = torch.int64
    # The counters as the rows of one [C, N] matrix of int32 bit views,
    # in the order of `names`; a compiled-out (zero-width) leaf totals 0.
    names, rows = [], []

    def add(prefix_names, leaf):
        if leaf.shape[0] == n:
            names.extend(prefix_names)
            rows.append(leaf.view(torch.int32).reshape(n, -1).t())
    for nm in tlm.U64_COUNTERS:
        add([nm], getattr(stats, nm))
    add([f"accepted_by_meta_{i}" for i in range(cfg.n_meta + 1)],
        stats.accepted_by_meta)
    if cfg.trace.enabled:
        add([f"trace_delivered_{nm}" for nm in trp.CHANNEL_NAMES],
            stats.trace_delivered)
        add([f"trace_dup_{nm}" for nm in trp.CHANNEL_NAMES], stats.trace_dup)
    if cfg.overload.enabled:
        for nm in ("msgs_shed_rate", "msgs_shed_priority"):
            add([nm], getattr(stats, nm))
    if cfg.recovery.enabled:
        for nm in ("recov_soft", "recov_backoff", "recov_quarantine"):
            add([nm], getattr(stats, nm))
        add([f"recov_cleared_{nm}" for nm in tlm.HEALTH_NAMES],
            stats.recov_cleared)
    tot = tele.row_totals_u64(torch.cat(rows, dim=0))
    # Scalar numerators, each < 2^32, beside them.
    h = wide(health)
    hb = torch.arange(len(tlm.HEALTH_NAMES), device=dev)
    bit_cnt = ((h[:, None] >> hb[None, :]) & 1).sum(dim=0)
    small = torch.cat([torch.stack([
        (rnd + 1) & MASK, new_time.view(torch.int32).to(n64) & MASK,
        members.sum(), killed_mask(stc.meta).sum(),
        store_cnt.sum(), torch.where(members, cand_cnt, 0).sum(),
        ((bit_cnt > 0).to(n64) << hb).sum(), (h != 0).sum()]), bit_cnt])
    pairs = torch.stack([tot & MASK, tot >> 32], dim=1)    # [C, 2]
    vals = {nm: pairs[i] for i, nm in enumerate(names)}
    zero2 = torch.zeros(2, dtype=n64, device=dev)
    for nm in tlm.U64_COUNTERS:
        vals.setdefault(nm, zero2)
    for i, nm in enumerate(("round", "sim_time", "alive_members", "killed")):
        vals[nm] = small[i:i + 1]
    live = torch.stack([small[4] & MASK, small[4] >> 32, small[5] & MASK,
                        small[5] >> 32])
    vals["store_live"], vals["cand_live"] = live[:2], live[2:]
    vals["health_or"], vals["health_flagged"] = small[6:7], small[7:8]
    for b, nm in enumerate(tlm.HEALTH_NAMES):
        vals[f"health_{nm}"] = small[8 + b:9 + b]
    if cfg.trace.enabled:
        t = cfg.trace.tracked_slots
        cov, lat = wide(trace_cov), wide(trace_latch)
        for k in range(t):
            vals[f"trace_cov_{k}"] = cov[k:k + 1]
            for i, pct in enumerate(trp.LATCH_PCTS):
                vals[f"trace_r{pct}_{k}"] = lat[k, i:i + 1]
        # The redundancy ratio in float32, operation for operation as
        # traceplane.redundancy_f32 (channel by channel, lo + hi * 2^32).
        words = torch.stack([torch.stack([vals[f"trace_{kind}_{nm}"]
                                          for nm in trp.CHANNEL_NAMES])
                             for kind in ("delivered", "dup")]).to(
                                 torch.float32)           # [2, 4, (lo, hi)]
        per = words[..., 0] + words[..., 1] * 4294967296.0
        # Summed channel by channel in order (0 + x is x).
        tot_f = per[:, 0]
        for c in range(1, trp.NUM_CHANNELS):
            tot_f = tot_f + per[:, c]
        useful_f, dup_f = tot_f[0], tot_f[1]
        ratio = torch.where(useful_f > 0, (useful_f + dup_f) / useful_f,
                            torch.zeros_like(useful_f))
        vals["trace_redundancy"] = wide(ratio.view(torch.int32)).reshape(1)
    if cfg.overload.enabled:
        vals["bucket_exhausted"] = (bucket == 0).sum().reshape(1)
    if cfg.telemetry.histograms:
        hb_n = cfg.telemetry.hist_buckets
        for name, kind, cap in tlm.hist_specs(cfg):
            val, mask = hists[name]
            vals[f"hist_{name}"] = wide(
                tele.hist_linear(val, mask, cap, hb_n) if kind == "linear"
                else tele.hist_log2(val, mask, hb_n))
    return narrow(torch.cat([vals[nm] for nm, _ in tlm.row_schema(cfg)]))


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
    if not cfg.store_diet:
        return _step_impl(state, cfg, "sync", None)
    rnd = _round_host(state)
    return _step_impl(state, cfg, phase or sdiet.phase_of(cfg, rnd), rnd)


def multi_step(state: PeerState, cfg: CommunityConfig, k: int) -> PeerState:
    """Advance ``k`` rounds along the cadence (one host read in all)."""
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
    # The tracing plane: lineage columns (int64 carriers for the u32
    # ones) and the per-channel useful / duplicate deliveries.
    trace_on = cfg.trace.enabled
    tr_first, tr_chan = wide(state.trace_first), state.trace_chan
    tr_dups, tr_latch = wide(state.trace_dups), state.trace_latch
    if trace_on:
        for name in ("trace_delivered", "trace_dup"):
            acc[name] = torch.zeros((n, trp.NUM_CHANNELS),
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
    # The digest exists only with the sync exchange.
    dig = state.digest if diet and cfg.sync_enabled else None
    epoch = state.epoch
    fwd = (state.fwd_gt, state.fwd_member, state.fwd_meta,
           state.fwd_payload, state.fwd_aux)
    # The delay pen (zero-width without it) and the one-slot signature
    # cache (zero-length without double-signed metas).
    dly = (state.dly_gt, state.dly_member, state.dly_meta,
           state.dly_payload, state.dly_aux, state.dly_since, state.dly_src)
    sig = (state.sig_target, state.sig_meta, state.sig_payload,
           state.sig_gt, state.sig_since)
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
        (tab, stc, fwd, dly, auth, sig, mal, global_time,
         session) = _rebirth_wipe(reborn, tab, stc, fwd, dly, auth, sig,
                                  mal, global_time, session)
        if diet:
            sta = _wipe_store_cols(m1, sta)
        if dig is not None:
            dig = _fill(m1, dig, 0)
        if trace_on:
            # Lineage is the disk's arrival history: it wipes too.
            tr_first = torch.where(m1, 0, tr_first)
            tr_chan = torch.where(m1, 0, tr_chan)
            tr_dups = torch.where(m1, 0, tr_dups)
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
    nat_sym = sym_of = None
    if cfg.p_symmetric > 0.0:
        # Symmetric-NAT members: a property of the identity's router,
        # drawn once from the round-0 stream (so it survives churn);
        # trackers are public.
        nat_sym = ((rng.rand_uniform(seed, torch.zeros_like(rnd), idx,
                                     rng.P_NAT)
                    < _f32(cfg.p_symmetric, dev)) & (idx >= t))

        def sym_of(peer):
            """The NAT type of each entry of a peer-index array (NO_PEER
            reads as public)."""
            p_ = peer.to(torch.int64)
            return nat_sym[p_.clamp(0, n - 1)] & (p_ >= 0)
    # Hard-kill state: a peer whose (post-churn) store holds the founder's
    # destroy record walks, authors and takes in nothing, and serves and
    # pushes only the destroy record.
    killed = killed_mask(stc.meta) if tline else None

    # ---- phase 1: walker send ------------------------------------------
    # dispersy_get_walk_candidate + create_introduction_request; trackers
    # never walk.
    boot_base, boot_count, mem_base, mem_count = _layout_cols(cfg, dev)
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
        e_dst, e_valid, e_junk, e_src = [], [], [], []
        ph_src = None
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
            if cfg.delay_enabled:
                # The pen keeps each record's deliverer (the target of
                # its missing-proof request): pushes carry their sender.
                e_src.append(narrow(idx[:, None].expand(n, f * c).reshape(
                    -1)))
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
            if cfg.delay_enabled:
                e_src.append(narrow(fsrc[:, None].expand(fl, ff).reshape(
                    -1)))
            e_junk.append(torch.ones(fl * ff, dtype=torch.bool, device=dev))
            # The flooder's NIC sends every blast, pre-loss.
            bup = bup.index_add(0, fsrc, alive_f * (ff * RECORD_BYTES))
        push_cols = [unbits(torch.cat([bits(x) for x in cl]), cl[0].dtype)
                     for cl in e_cols]
        if cfg.delay_enabled:
            push_cols.append(unbits(torch.cat([bits(x) for x in e_src]),
                                    torch.uint32))
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
        if cfg.delay_enabled:
            ph_src = torch.where(ph_ok, bits(push.inbox[5]), NO_PEER)
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
        ph_src = torch.zeros((n, 0), dtype=torch.int32, device=dev)

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
            salt_base=_TRACKER_INTRO_SALT,
            req_sym=None if nat_sym is None else sym_of(tq_src_i),
            slot_sym=None if nat_sym is None else sym_of(ttab.peer))
        # Introduce requester s to another requester of this round's
        # inbox; fall back to the ring pick when that slot is empty.
        s_ix = torch.arange(rt, dtype=torch.int64, device=dev)[None, :]
        jj = ((s_ix + 1 + rng.rand_u32(seed, rnd, tidx[:, None], rng.P_INTRO,
                                       s_ix + _TRACKER_INTRO_SALT + (1 << 18))
               % max(rt - 1, 1)) % rt)
        intro_inbox = torch.gather(tq_src_i, 1, jj)
        intro_inbox = torch.where(intro_inbox == tq_src_i, NO_PEER,
                                  intro_inbox)
        if nat_sym is not None:
            # Never pair two symmetric-NAT requesters (the filtered ring
            # pick stands in).
            intro_inbox = torch.where(
                sym_of(tq_src_i) & sym_of(intro_inbox), NO_PEER,
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

    intro = cand.sample_introductions(
        tab, now, cfg, seed, rnd, idx, exclude=rq_src_i,
        req_sym=None if nat_sym is None else sym_of(rq_src_i),
        slot_sym=None if nat_sym is None else sym_of(tab.peer))  # [N, R]
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
    if nat_sym is not None:
        # Two symmetric NATs cannot hole-punch: the puncture never lands.
        pu_ok_send = pu_ok_send & ~(nat_sym[:, None]
                                    & sym_of(bits(pq_target)))
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
    walk_streak = state.walk_streak
    if cfg.telemetry.histograms:
        # Consecutive successful walks: +1 on a success, reset on a
        # failure, kept on a round without a walk (stats-like: it
        # survives churn).
        walk_streak = narrow(torch.where(
            walked_ok & got_resp, wide(walk_streak) + 1,
            torch.where(failed, 0, wide(walk_streak))))

    # ---- phase 3s: the signature request and response -----------------
    # A drafted double-signed record rides to its counterparty once, in
    # the round it was drafted; the counterparty agrees (the countersign
    # draw, and for a meta LinearResolution at the draft's gt both
    # signers' permits in its own table) and the countersigned record
    # rides back by receipt into this round's intake.  The cache frees on
    # completion and expires after ``sig_timeout_rounds``.
    sg_target, sg_meta, sg_payload, sg_gt, sg_since = sig
    if cfg.double_meta_mask:
        s_sz = cfg.sig_inbox
        sending = act & (sg_target != NO_PEER) & (wide(sg_since) == rnd)
        if tline:
            sending = sending & ~killed
        srq_lost = _lost(kn, ge_bad, seed, rnd, idx, _LOSS_SIGREQ, 0)
        bup = bup + sending * SIGNATURE_REQUEST_BYTES
        sig_send_ok = sending & ~srq_lost
        if fm.partitions:
            sig_send_ok = sig_send_ok & ~flt.partition_blocked(
                idx, sg_target, fm.partitions)
        sreq, _ = _deliver(
            cfg, torch.where(sending, sg_target, NO_PEER).to(torch.int32),
            [idx_u32, sg_meta, sg_payload, sg_gt], sig_send_ok, n, s_sz)
        sq_src, sq_meta, sq_payload, sq_gt = sreq.inbox        # [N, S]
        arrivals = arrivals | sreq.inbox_valid.any(dim=1)
        # Trackers and hard-killed peers never countersign.
        sq_ok = sreq.inbox_valid & act[:, None] & ~state.is_tracker[:, None]
        if tline:
            sq_ok = sq_ok & ~killed[:, None]
        if cfg.countersign_rate >= 1.0:
            agree = torch.ones((n, s_sz), dtype=torch.bool, device=dev)
        elif cfg.countersign_rate <= 0.0:
            agree = torch.zeros((n, s_sz), dtype=torch.bool, device=dev)
        else:
            agree = rng.rand_uniform(
                seed, rnd, idx[:, None], rng.P_SIGN,
                torch.arange(s_sz, device=dev)[None, :]) < _f32(
                    cfg.countersign_rate, dev)
        if tline and ((cfg.protected_meta_mask | cfg.dynamic_meta_mask)
                      & cfg.double_meta_mask):
            founder_b = _founder_col(cfg, dev)[:, None]
            qm = wide(sq_meta)
            shq = qm.clamp(max=31)
            prot_q = (((cfg.protected_meta_mask >> shq) & 1) == 1) \
                & (qm < cfg.n_meta)
            if cfg.dynamic_meta_mask & cfg.double_meta_mask:
                dyn_q = (((cfg.dynamic_meta_mask >> shq) & 1) == 1) \
                    & (qm < cfg.n_meta)
                best_q = wide(intake.flip_best(stc, sq_meta, sq_gt))
                prot_q = torch.where(
                    dyn_q, torch.where(best_q > 0, (best_q & 1) == 1,
                                       prot_q), prot_q)
            perm_q = (tl.check(auth, sq_src, sq_meta, sq_gt, founder_b)
                      & tl.check(auth, idx_u32[:, None], sq_meta, sq_gt,
                                 founder_b))
            agree = agree & torch.where(prot_q, perm_q, True)
        countersign = sq_ok & agree
        n_sq = sq_ok.sum(dim=1)
        n_cs = countersign.sum(dim=1)
        bdown = bdown + n_sq * SIGNATURE_REQUEST_BYTES
        bup = bup + n_cs * SIGNATURE_RESPONSE_BYTES
        # The response is picked up by receipt at the author.
        tgt_a = torch.where(sending, sg_target, 0).to(torch.int64).clamp(
            min=0)
        slot_a = sreq.edge_slot.to(torch.int64).clamp(min=0)
        got_sig = (sreq.edge_slot >= 0) & countersign[tgt_a, slot_a]
        srs_lost = _lost(kn, ge_bad, seed, rnd, idx, _LOSS_SIGRESP, 0)
        completed = sending & got_sig & ~srs_lost
        bdown = bdown + completed * SIGNATURE_RESPONSE_BYTES
        expired = (alive & (sg_target != NO_PEER) & ~completed
                   & (((rnd - wide(sg_since)) & MASK)
                      >= cfg.sig_timeout_rounds))
        clear = completed | expired
        sig = (torch.where(clear, NO_PEER, sg_target),) + tuple(
            _fill(clear, c, 0) for c in (sg_meta, sg_payload, sg_gt,
                                         sg_since))
        acc["sig_signed"] = n_cs
        acc["sig_done"] = completed.to(torch.int64)
        acc["sig_expired"] = expired.to(torch.int64)
        acc["requests_dropped"] += sreq.n_dropped
        # The completed record, one intake column (the cache's u32 meta
        # narrows to the record's u8 column; the countersigner in aux).
        db_gt = _fill(~completed, sg_gt, EMPTY_U32)[:, None]
        db_member = idx_u32[:, None]
        db_meta = cast(sg_meta, torch.uint8)[:, None]
        db_payload = sg_payload[:, None]
        db_aux = narrow(torch.where(sg_target == NO_PEER, 0,
                                    sg_target.to(torch.int64)))[:, None]
        db_ok = completed[:, None]
        db_src = torch.where(db_ok, sg_target[:, None], NO_PEER)
    else:
        d0 = zeros((n, 0), torch.uint32, dev)
        db_gt = db_member = db_payload = db_aux = d0
        db_meta = torch.zeros((n, 0), dtype=torch.uint8, device=dev)
        db_ok = torch.zeros((n, 0), dtype=torch.bool, device=dev)
        db_src = torch.zeros((n, 0), dtype=torch.int32, device=dev)

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

    # ---- phases 4p, 4s, 4m, 4i: the pen's four request channels -------
    # Each parked record asks its deliverer for what it waits on -- the
    # proof (grants naming its author), the missing sequence range, the
    # undo-other's target, or its author's identity -- and the replies
    # ride back by receipt into this round's intake (:func:`_pen_channel`).
    dl_gt, dl_member, dl_meta, dl_payload, dl_aux, dl_since, dl_src = dly
    dl_ok = (bits(dl_gt) != -1) & act[:, None]
    pen_live = dl_ok & (dl_src != NO_PEER)
    rt = _RoundCtx(cfg, kn, ge_bad, seed, rnd, idx, act,
                   killed if tline else None, acc)
    replies = []                      # one _Replies per channel
    if cfg.proof_requests:
        # The proof_budget newest stored grants and revokes naming the
        # author, ranked from the ring's end.
        is_proof_row = ((stc.meta == META_AUTHORIZE)
                        | (stc.meta == META_REVOKE))
        ch = _pen_channel(
            rt, stc, dl_src, pen_live, [dl_member],
            lambda q, s: is_proof_row & (bits(stc.payload)
                                         == bits(q[0][:, s:s + 1])),
            cfg.proof_budget, True, _LOSS_PROOF_REQ, _LOSS_PROOF_RESP,
            MISSING_PROOF_BYTES, "proof")
        replies.append(ch)
    if cfg.seq_requests:
        # The range [stored max + 1, gap - 1] of a parked sequenced
        # record, served ascending so a whole reply chains in one batch.
        dm = dl_meta.to(torch.int64)
        dl_is_seq = ((((cfg.seq_meta_mask >> dm.clamp(max=31)) & 1) == 1)
                     & (dm < cfg.n_meta))
        sq_low = (wide(intake.seq_stored_max(stc, dl_member, dl_meta))
                  + 1) & MASK
        sq_high = (wide(dl_aux) - 1) & MASK
        live_rows = bits(stc.gt) != -1
        s_aux = wide(stc.aux)

        def seq_serve(q, s):
            return (live_rows & (bits(stc.member) == bits(q[0][:, s:s + 1]))
                    & (stc.meta == q[1][:, s:s + 1])
                    & (s_aux >= wide(q[2][:, s:s + 1]))
                    & (s_aux <= wide(q[3][:, s:s + 1])))
        ch = _pen_channel(
            rt, stc, dl_src, pen_live & dl_is_seq & (sq_low <= sq_high),
            [dl_member, dl_meta, narrow(sq_low), narrow(sq_high)],
            seq_serve, cfg.proof_budget, False, _LOSS_SEQ_REQ,
            _LOSS_SEQ_RESP, MISSING_SEQ_BYTES, "seq")
        replies.append(ch)
    if cfg.msg_requests:
        # The stored user record an undo-other names, by (member, gt).
        user_rows = (bits(stc.gt) != -1) & (stc.meta < 32)
        ch = _pen_channel(
            rt, stc, dl_src, pen_live & (dl_meta == META_UNDO_OTHER),
            [dl_payload, dl_aux],
            lambda q, s: (user_rows
                          & (bits(stc.member) == bits(q[0][:, s:s + 1]))
                          & (bits(stc.gt) == bits(q[1][:, s:s + 1]))),
            1, False, _LOSS_MSG_REQ, _LOSS_MSG_RESP, MISSING_MSG_BYTES,
            "mm")
        replies.append(ch)
    if cfg.identity_requests:
        # The author's dispersy-identity record.
        id_rows = stc.meta == META_IDENTITY
        ch = _pen_channel(
            rt, stc, dl_src,
            pen_live & (dl_meta < cfg.n_meta)
            & ~intake.identity_stored(stc, dl_member),
            [dl_member],
            lambda q, s: id_rows & (bits(stc.member)
                                    == bits(q[0][:, s:s + 1])),
            1, False, _LOSS_ID_REQ, _LOSS_ID_RESP, MISSING_IDENTITY_BYTES,
            "id")
        replies.append(ch)
    for ch in replies:
        bup, bdown = bup + ch.bup, bdown + ch.bdown
        arrivals = arrivals | ch.arrived

    # ---- phase 5: combined intake -> store ------------------------------
    # One batch per round, in this order: the pen's waiting records, sync
    # pulls, pushes, this round's double-signed completions, the proof,
    # sequence, message and identity replies, then (duplication) the
    # duplicated sync pulls and pushes.  The batch's aux column is u32 (a
    # u16 store aux is zero-extended, as the JAX package's concatenation
    # promotes it).  Each segment carries its lineage channel (sync or
    # push, 0 for the rest) and, with the pen, each entry its delivery
    # round and its deliverer.
    sy_src = torch.where(sy_ok, target[:, None], NO_PEER) if \
        cfg.delay_enabled else None
    sync_seg = _Seg(sy_gt, sy_member, sy_meta, sy_payload, sy_aux, sy_ok,
                    sy_src, trp.CH_WALK_SYNC)
    push_seg = _Seg(ph_gt, ph_member, ph_meta, ph_payload, ph_aux, ph_ok,
                    ph_src, trp.CH_PUSH)
    segs = ([_Seg(dl_gt, dl_member, dl_meta, dl_payload, dl_aux, dl_ok,
                  dl_src, 0), sync_seg, push_seg,
             _Seg(db_gt, db_member, db_meta, db_payload, db_aux, db_ok,
                  db_src, 0)]
            + [_Seg(*ch.cols, ch.ok, ch.src, 0) for ch in replies])
    if kn.dup_on:
        segs += [sync_seg._replace(ok=sy_dup_ok),
                 push_seg._replace(ok=ph_dup_ok)]

    def cat(field, dt):
        return unbits(torch.cat([bits(cast(getattr(sg, field), dt))
                                 for sg in segs], dim=1), dt)
    in_gt, in_member, in_payload = (cat(f, torch.uint32)
                                    for f in ("gt", "member", "payload"))
    in_meta, in_aux = cat("meta", torch.uint8), cat("aux", torch.uint32)
    in_ok = torch.cat([sg.ok for sg in segs], dim=1)
    if cfg.delay_enabled:
        # Pen entries keep their parking round and deliverer; everything
        # else arrived now.
        in_since = narrow(torch.cat([wide(dl_since), rnd.expand(
            n, in_ok.shape[1] - dl_since.shape[1])], dim=1))
        in_src = torch.cat([sg.src for sg in segs], dim=1)
    bb = in_gt.shape[1]
    fb = cfg.forward_buffer
    if bb > 0:
        # Clock-jump defense before the store accepts anything.
        in_ok = in_ok & (wide(in_gt) <= ((global_time[:, None] + rng_range)
                                         & MASK))
        if tline:
            # A hard-killed peer takes in nothing at all.
            in_ok = in_ok & ~killed[:, None]
        is_dbl = None
        if cfg.double_meta_mask:
            # The structural signature check of a double-signed record
            # (completed here or synced): its countersigner in aux is
            # another member of the receiver's community.
            im = in_meta.to(torch.int64)
            is_dbl = ((((cfg.double_meta_mask >> im.clamp(max=31)) & 1) == 1)
                      & (im < cfg.n_meta))
            a_w = wide(in_aux)
            dbl_ok = ((bits(in_aux) != bits(in_member))
                      & (a_w >= mem_base[:, None])
                      & (a_w < (mem_base + mem_count)[:, None]))
            in_ok = in_ok & torch.where(is_dbl, dbl_ok, True)
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
        if dig is not None:
            in_h = narrow(record_hash(in_member, in_gt, in_meta, in_payload))
            in_store = bloom.bloom_query(dig, in_h, cfg.bloom_bits,
                                         cfg.bloom_hashes, salt=ep)
            dup_in_batch = intake.dup_earlier(in_member, in_gt, in_ok)
        elif diet:
            # The diet without sync has no digest: the exact test against
            # the ring and the staging buffer (unsorted, in arrival order).
            in_ring, dup_in_batch = intake.intake_checks(
                stc.gt, stc.member, in_member, in_gt, in_ok)
            in_sta, _ = intake.intake_checks(sta.gt, sta.member, in_member,
                                             in_gt, in_ok)
            in_store = in_ring | in_sta
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
                                   dup_in_batch, founder_col[:, None],
                                   is_dbl)
            auth, accept = chk.auth, chk.accept
            batch = batch._replace(flags=chk.flags)
            acc["msgs_dropped"] += chk.fold_lost
        else:
            accept = in_ok
        if cfg.identity_required:
            accept = _identity_gate(cfg, stc, batch, accept)
            if is_dbl is not None:
                # A double-signed record needs its countersigner's
                # identity too.
                accept = accept & torch.where(
                    is_dbl, intake.identity_stored(stc, in_aux), True)
        accept, pen_slot, n_rej = _chain_and_park(
            cfg, stc, batch, in_ok, in_store, dup_in_batch, accept,
            chk.parkable if cfg.delay_enabled else None,
            in_since if cfg.delay_enabled else None, rnd)
        if gated:
            acc["msgs_rejected"] += n_rej
        accept_store = accept
        if cfg.direct_meta_mask:
            # A direct record is counted on receipt, never stored and
            # never forwarded.
            im = in_meta.to(torch.int64)
            is_direct = ((((cfg.direct_meta_mask >> im.clamp(max=31)) & 1)
                          == 1) & (im < cfg.n_meta))
            got_direct = accept & is_direct
            acc["msgs_direct"] = got_direct.sum(dim=1)
            accept_store = accept & ~is_direct
        fresh = accept_store & ~in_store & ~dup_in_batch     # [N, B]
        # The per-meta counts: fresh stored records and direct receipts.
        counted = fresh | got_direct if cfg.direct_meta_mask else fresh
        bucket = torch.where(in_meta.to(torch.int64) < cfg.n_meta,
                             in_meta.to(torch.int64), cfg.n_meta)
        acc["accepted_by_meta"] += (
            (bucket[:, :, None] == torch.arange(cfg.n_meta + 1,
                                                device=dev)[None, None, :])
            & counted[:, :, None]).sum(dim=1)
        if diet:
            # Fresh records append to the staging buffer; duplicates and
            # staging overflow count as dropped.  msgs_stored counts at
            # compaction, when records enter the ring.
            stg = st.store_stage(sta, batch, new_mask=fresh)
            sta = stg.staging
            acc["msgs_dropped"] += ((accept_store & ~fresh).sum(dim=1)
                                    + stg.n_dropped)
            if dig is not None and (stagger or not compact_now):
                # OR the landed arrivals into the digest so the next claim
                # and freshness test cover them (a cohorts=1 compaction
                # rebuilds it instead; under staggering the active
                # block's rows are rebuilt below).
                dig = bloom.digest_update(dig, in_h, stg.landed,
                                          cfg.bloom_bits, cfg.bloom_hashes,
                                          salt=ep)
        else:
            ins = st.store_insert(stc, batch, new_mask=accept_store,
                                  history=cfg.history)
            stc = ins.store
            acc["msgs_stored"] += ins.n_inserted
            acc["msgs_dropped"] += (ins.n_dropped.to(torch.int64)
                                    + ins.n_evicted)
        global_time = _fold_gt(global_time, wide(in_gt), accept, rng_range)
        if trace_on:
            with record_function("trace_lineage"):
                # The lineage fold of every slot.  The channel is static
                # per batch segment (sync pulls, pushes, then their
                # duplicates); an arrival lands where it took a staging
                # slot under the diet and where it was accepted fresh on
                # the legacy ring.
                landed = stg.landed if diet else fresh
                chan_code = torch.cat([
                    torch.full((sg.gt.shape[1],), sg.chan, dtype=torch.uint8,
                               device=dev) for sg in segs])
                match = ((bits(in_member)[:, None, :]
                          == bits(state.trace_member)[None, :, None])
                         & (bits(in_gt)[:, None, :]
                            == bits(state.trace_gt)[None, :, None]))
                tr_first, tr_chan, tr_dups, ubc, dbc = trc.slot_lineage(
                    tr_first, tr_chan, tr_dups, match, landed, accept_store,
                    chan_code, rnd + 1)
                acc["trace_delivered"] += ubc
                acc["trace_dup"] += dbc
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
        if cfg.delay_enabled:
            # The pen rebuilt from this batch's parked records: waiting
            # entries keep their parking round, new ones stamp this one.
            dly = tuple(st.rank_compact_many(
                [(in_gt, EMPTY_U32), (in_member, EMPTY_U32),
                 (in_meta, EMPTY_META), (in_payload, EMPTY_U32),
                 (in_aux, 0), (in_since, 0),
                 (in_src.view(torch.uint32), EMPTY_U32)],
                pen_slot, cfg.delay_inbox))
            dly = dly[:6] + (dly[6].view(torch.int32),)
            acc["msgs_delayed"] = ((pen_slot < cfg.delay_inbox)
                                   & (wide(in_since) == rnd)).sum(dim=1)
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
        if dig is not None:
            dig = _digest_rebuild(stc, cfg, sdiet.epoch_of(cfg, rnd_h) + 1,
                                  dev)

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
            fill = flt.popcount_rows(dig if diet else my_bloom)
            hb = hb | torch.where(fill * 8 >= cfg.bloom_bits * 7,
                                  HEALTH_BLOOM_SAT, 0)
        health_pre = wide(health)
        health = health_pre | hb
    if rc.enabled:
        (tab, stc, sta, dig, fwd, dly, auth, sig, mal, global_time, session,
         health, backoff, repair_round, quar_until, esc) = _recovery_pass(
            cfg, acc, seed, rnd, idx, health_pre, hb, tab, stc, sta, dig,
            fwd, dly, auth, sig, mal, global_time, session, backoff,
            repair_round, quar_until)
        if trace_on:
            # A quarantine is a wiped-disk rebirth: lineage wipes too.
            em = esc[:, None]
            tr_first = torch.where(em, 0, tr_first)
            tr_chan = torch.where(em, 0, tr_chan)
            tr_dups = torch.where(em, 0, tr_dups)
    acc["bytes_up"] += bup
    acc["bytes_down"] += bdown
    stats = _stats_out(state, acc)
    new_time = now + _f32(cfg.walk_interval, dev)
    members = alive & ~state.is_tracker
    tr_cov = None
    if trace_on:
        with record_function("trace_coverage"):
            # Coverage and its latches, after the recovery wipes and before
            # the row packs them.
            tr_cov = trc.coverage_counts(tr_first, members)
            tr_latch = trc.latch_update(
                tr_latch, tr_cov, bits(state.trace_member) != -1,
                members.sum(), narrow(rnd + 1))
    tele_row, tele_ring = state.tele_row, state.tele_ring
    fr_ring, fr_pos = state.fr_ring, state.fr_pos
    if cfg.telemetry.enabled:
        with record_function("telemetry_row"):
            tc = cfg.telemetry
            store_cnt = st.count_valid(stc.gt).to(torch.int64)
            if diet:
                # The logical store is ring and staging.
                store_cnt = store_cnt + st.count_valid(sta.gt)
            cand_cnt = (tab.peer != NO_PEER).sum(dim=1)
            # This round's dropped packets and records (u32, wrapping).
            drop_delta = (acc["requests_dropped"] + acc["msgs_dropped"]) & MASK
            hists = None
            if tc.histograms:
                ones = torch.ones(n, dtype=torch.bool, device=dev)
                if cfg.sync_enabled:
                    bloom_cnt = flt.popcount_rows(dig if diet else my_bloom)
                    bloom_mask = ones
                else:
                    bloom_cnt, bloom_mask = z64, ~ones
                hists = {"store_fill": (store_cnt, ones),
                         "cand_fill": (cand_cnt, members),
                         "req_inbox": (n_rq, ~state.is_tracker),
                         "round_drops": (drop_delta, ones),
                         "bloom_fill": (bloom_cnt, bloom_mask),
                         "walk_streak": (walk_streak, members)}
            tele_row = _telemetry_row(
                cfg, rnd=rnd, new_time=new_time, members=members, stats=stats,
                stc=stc, health=health, store_cnt=store_cnt, cand_cnt=cand_cnt,
                hists=hists, bucket=bucket_new, trace_cov=tr_cov,
                trace_latch=tr_latch)
            if tc.history:
                # Round r + 1's row lands at slot r % history.
                tele_ring = tele_ring.clone()
                tele_ring.view(torch.int32).index_copy_(
                    0, (rnd % tc.history).reshape(1),
                    tele_row.view(torch.int32)[None])
            if tc.flight_recorder:
                # The first flight_per_round peers whose sentinel newly
                # latched this round, in index order.
                newly = hb & ~health_pre
                is_new = newly != 0
                fpr = tc.flight_per_round
                frank = torch.cumsum(is_new.to(torch.int64), dim=0) - 1
                frslot = torch.where(is_new & (frank < fpr), frank, fpr)
                cols = (idx, (rnd + 1).expand(n), newly, wide(health),
                        wide(stats.requests_dropped), wide(stats.msgs_dropped),
                        drop_delta, store_cnt)
                recs = torch.stack([
                    wide(st.rank_compact(narrow(c)[None], frslot[None], fpr,
                                         EMPTY_U32 if i == 0 else 0)[0])
                    for i, c in enumerate(cols)], dim=1)
                fr_ring, fr_pos = tele.flight_append(
                    state.fr_ring, state.fr_pos, recs, recs[:, 0] != EMPTY_U32)
    diet_leaves = {} if not diet else {
        "sta_gt": sta.gt, "sta_member": sta.member, "sta_meta": sta.meta,
        "sta_payload": sta.payload, "sta_aux": sta.aux,
        "sta_flags": sta.flags, "epoch": epoch,
        **({} if dig is None else {"digest": dig})}
    trace_leaves = {} if not trace_on else {
        "trace_first": narrow(tr_first), "trace_chan": tr_chan,
        "trace_dups": narrow(tr_dups), "trace_latch": tr_latch}
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
        dly_gt=dly[0], dly_member=dly[1], dly_meta=dly[2],
        dly_payload=dly[3], dly_aux=dly[4], dly_since=dly[5],
        dly_src=dly[6], sig_target=sig[0], sig_meta=sig[1],
        sig_payload=sig[2], sig_gt=sig[3], sig_since=sig[4],
        walk_streak=walk_streak, tele_row=tele_row, tele_ring=tele_ring,
        fr_ring=fr_ring, fr_pos=fr_pos, **trace_leaves,
        stats=stats, time=new_time, round_index=narrow(rnd + 1),
    )


def _recovery_pass(cfg: CommunityConfig, acc: dict, seed, rnd, idx,
                   prev: torch.Tensor, hb: torch.Tensor, tab, stc, sta, dig,
                   fwd, dly, auth, sig, mal, global_time, session, backoff,
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
    the updated leaves and the escalation mask."""
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
        if dig is not None:
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
        (tab, stc, fwd, dly, auth, sig, mal, global_time,
         session) = _rebirth_wipe(esc, tab, stc, fwd, dly, auth, sig, mal,
                                  global_time, session, wipe_store=False)
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
    return (tab, stc, sta, dig, fwd, dly, auth, sig, mal, global_time,
            session, health, backoff, narrow(rr), narrow(quar), esc)


def _chain_and_park(cfg: CommunityConfig, stc: st.StoreCols,
                    batch: st.StoreCols, in_ok, in_store, dup_in_batch,
                    accept, parkable, in_since, rnd):
    """The sequence chain and the pen's parking test over the [N, B]
    batch: returns ``(accept, pen_slot, n_rejected)``, ``accept`` through
    the chain, ``pen_slot`` each entry's pen slot (``delay_inbox`` for
    none; None without the pen) and the int64 [N] count of entries
    refused and not parked (None where no gate refuses).  With the pen, a ``parkable`` entry
    that failed only the earlier gates, or with ``seq_requests`` only
    the chain, that is not stored, not a duplicate of an earlier entry
    and within its waiting time (from ``in_since``) parks, first fit;
    overflow rejects."""
    seq_ok = (_seq_chain_ok(cfg, stc, batch, in_store, accept)
              if cfg.seq_meta_mask else None)
    pen_slot, refused = None, None
    if cfg.delay_enabled:
        waiting = ~accept
        if cfg.seq_requests:
            waiting = waiting | (accept & ~seq_ok)
        waiting = (waiting & in_ok & parkable & ~in_store & ~dup_in_batch
                   & (((rnd - wide(in_since)) & MASK)
                      < cfg.delay_timeout_rounds))
        drank = torch.cumsum(waiting.to(torch.int32), dim=1) - 1
        parked = waiting & (drank < cfg.delay_inbox)
        pen_slot = torch.where(parked, drank, cfg.delay_inbox)
        refused = ~parked
    if seq_ok is not None:
        accept = accept & seq_ok
    if not (cfg.timeline_enabled or cfg.seq_meta_mask
            or cfg.identity_required):
        return accept, pen_slot, None
    rejected = in_ok & ~accept
    if refused is not None:
        rejected = rejected & refused
    return accept, pen_slot, rejected.sum(dim=1)


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

    A double-signed meta is refused (only :func:`create_signature_request`
    makes one); a direct meta's record is pushed and stored nowhere.
    """
    control = meta in (META_AUTHORIZE, META_REVOKE, META_UNDO_OWN,
                       META_UNDO_OTHER, META_DYNAMIC, META_DESTROY)
    if control and not cfg.timeline_enabled:
        raise ValueError(
            f"meta {meta:#x} is a permission control message; it needs "
            "timeline_enabled=True (declare a Linear/DynamicResolution "
            "meta or set the flag)")
    if meta < cfg.n_meta and (cfg.double_meta_mask >> meta) & 1:
        raise ValueError(
            f"meta {meta} is DoubleMemberAuthentication -- use "
            "create_signature_request, which obtains the counterparty's "
            "signature instead of forging it")
    is_direct = meta < cfg.n_meta and (cfg.direct_meta_mask >> meta) & 1
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
    store_mask = torch.zeros_like(author_mask) if is_direct else author_mask
    ins = st.store_insert(_store(state), new, store_mask[:, None],
                          history=cfg.history)
    stc = ins.store
    leaves = {}
    if cfg.store_diet and cfg.sync_enabled:
        # The record goes straight into the ring, and the digest learns
        # its probe bits under the salt of the round that claims next:
        # the author's own cohort's epoch under staggering.
        salt = (state.epoch if cfg.store_stagger else narrow(
            wide(state.round_index) // cfg.store.compact_every))
        new_h = narrow(record_hash(new.member, new.gt, new.meta,
                                   new.payload))
        leaves["digest"] = bloom.digest_update(
            state.digest, new_h, store_mask[:, None], cfg.bloom_bits,
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
    stat_leaves = {"accepted_by_meta": narrow(abm)}
    if cfg.trace.enabled:
        # An authored record with an already-registered tracked key
        # stamps the author's lineage on the create channel (a
        # capacity-dropped insert counts: lineage is arrival history).
        first, chan = wide(state.trace_first), state.trace_chan.clone()
        rpost = wide(state.round_index) + 1
        newly_any = torch.zeros(n, dtype=torch.bool, device=dev)
        for k in range(cfg.trace.tracked_slots):
            m_k = (store_mask & (idx == wide(state.trace_member[k]))
                   & ((gt_new & MASK) == wide(state.trace_gt[k]))
                   & (first[:, k] == 0))
            first[:, k] = torch.where(m_k, rpost, first[:, k])
            chan[:, k] = torch.where(m_k, trp.CH_CREATE, chan[:, k])
            newly_any = newly_any | m_k
        leaves.update(trace_first=narrow(first), trace_chan=chan)
        tdel = wide(state.stats.trace_delivered)
        tdel[:, trp.CH_CREATE - 1] += newly_any.to(torch.int64)
        stat_leaves["trace_delivered"] = narrow(tdel)
    return state.replace(
        store_gt=stc.gt, store_member=stc.member, store_meta=stc.meta,
        store_payload=stc.payload, store_aux=stc.aux, store_flags=stc.flags,
        **leaves,
        fwd_gt=fwd[0], fwd_member=fwd[1], fwd_meta=fwd[2],
        fwd_payload=fwd[3], fwd_aux=fwd[4],
        auth_member=auth.member, auth_mask=auth.mask, auth_gt=auth.gt,
        auth_rev=auth.rev, auth_issuer=auth.issuer,
        global_time=narrow(torch.where(author_mask, gt_new,
                                       wide(state.global_time))),
        stats=state.stats.replace(
            **stat_leaves,
            **{k: narrow(wide(getattr(state.stats, k)) + v)
               for k, v in stats.items()}))


def create_signature_request(state: PeerState, cfg: CommunityConfig,
                             author_mask: torch.Tensor, meta: int,
                             counterparty: torch.Tensor,
                             payload: torch.Tensor) -> PeerState:
    """Draft a double-signed record and open its signature request: each
    masked peer claims global_time + 1 for the draft and fills its
    one-slot signature cache; the request rides in the next :func:`step`
    and completes or expires there.  The draft is stored nowhere.

    ``counterparty`` (int [N]) is each author's second signer.  A request
    is refused (no side effect) when the author is dead, unloaded, a
    tracker or hard-killed, already has one in flight, names itself, a
    tracker or a peer outside the author's community, or -- for a meta
    LinearResolution at the draft's gt -- lacks the permit in its own
    table.  Raises ``ValueError`` for a meta that is not double-signed.
    """
    if not (meta < cfg.n_meta and (cfg.double_meta_mask >> meta) & 1):
        raise ValueError(f"meta {meta} is not double-signed "
                         f"(double_meta_mask={cfg.double_meta_mask:#x})")
    n = cfg.n_peers
    dev = state.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    cp = torch.as_tensor(counterparty, device=dev).to(torch.int64).reshape(n)
    payload = wide(torch.as_tensor(payload, device=dev)).reshape(n)
    gt_new = wide(state.global_time) + 1
    _, _, mem_base, mem_count = _layout_cols(cfg, dev)
    ok = (torch.as_tensor(author_mask, device=dev).to(torch.bool)
          & state.alive & state.loaded & ~state.is_tracker
          & (state.sig_target == NO_PEER) & (cp != idx) & (cp >= mem_base)
          & (cp < mem_base + mem_count))
    if cfg.timeline_enabled:
        ok = ok & ~killed_mask(state.store_meta)
        if ((cfg.protected_meta_mask | cfg.dynamic_meta_mask) >> meta) & 1:
            permit = tl.check(_auth(state), narrow(idx)[:, None],
                              _u32(meta, dev).expand(n, 1),
                              narrow(gt_new)[:, None],
                              _founder_col(cfg, dev)[:, None])[:, 0]
            ok = ok & (~_author_linear(state, cfg, meta, narrow(gt_new))
                       | permit)
    return state.replace(
        sig_target=torch.where(ok, cp.to(torch.int32), state.sig_target),
        sig_meta=_fill(ok, state.sig_meta, meta),
        sig_payload=narrow(torch.where(ok, payload, wide(state.sig_payload))),
        sig_gt=narrow(torch.where(ok, gt_new, wide(state.sig_gt))),
        sig_since=narrow(torch.where(ok, wide(state.round_index),
                                     wide(state.sig_since))),
        global_time=narrow(torch.where(ok, gt_new,
                                       wide(state.global_time))))


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


def overlay_draw(key: torch.Tensor, cfg: CommunityConfig, rows: torch.Tensor,
                 degree: int) -> torch.Tensor:
    """int32 [len(rows), degree]: the neighbours :func:`seed_overlay`
    gives the peers ``rows`` (int64) under the state key ``key`` (int64
    carrier pair), each drawn inside its row's own member block,
    ``NO_PEER`` where a draw repeats an earlier one."""
    dev = rows.device
    seed = rng.fold_seed(key)
    j = torch.arange(degree, device=dev)[None, :]
    _, _, mem_base, mem_count = _layout_cols(cfg, dev, rows)
    base = mem_base.to(torch.int64)[:, None]
    span = mem_count.to(torch.int64).clamp(min=1)[:, None]
    nbr = base + rng.rand_u32(seed, 0xE1, rows[:, None], rng.P_GOSSIP,
                              j) % span
    nbr = torch.where(nbr == rows[:, None], base + (nbr - base + 1) % span,
                      nbr)
    earlier = (torch.arange(degree, device=dev)[None, :]
               < torch.arange(degree, device=dev)[:, None])   # [i, j]: j < i
    dup = (nbr[:, :, None] == torch.where(earlier, nbr[:, None, :],
                                          NO_PEER)).any(dim=-1)
    return torch.where(dup, NO_PEER, nbr).to(torch.int32)


def seed_overlay(state: PeerState, cfg: CommunityConfig,
                 degree: int) -> PeerState:
    """Pre-seed every peer's candidate table with ``degree`` random walked
    member neighbours of its own community, stamped immediately eligible
    (a duplicate draw leaves its slot empty)."""
    n, t = cfg.n_peers, cfg.n_trackers
    if not 0 <= degree <= cfg.k_candidates:
        raise ValueError(f"degree {degree} must be in [0, k_candidates="
                         f"{cfg.k_candidates}]")
    if n - t <= 1:
        raise ValueError("need at least two non-tracker peers to seed an "
                         "overlay")
    if cfg.communities and not all(m > 1 for m, _ in cfg.communities):
        raise ValueError("every community needs at least two members to "
                         "seed an overlay")
    dev = state.device
    nbr = overlay_draw(wide(state.key), cfg,
                       torch.arange(n, dtype=torch.int64, device=dev), degree)
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


def _holds_record(state: PeerState, member: int, gt: int, meta: int,
                  payload: int) -> torch.Tensor:
    """bool[N]: whose store -- the ring and, under the byte diet, the
    staging buffer -- holds the record."""
    def holds(g, m, t, p):
        return ((wide(g) == gt) & (wide(m) == member)
                & (t.to(torch.int64) == meta)
                & (wide(p) == payload)).any(dim=1)
    has = holds(state.store_gt, state.store_member, state.store_meta,
                state.store_payload)
    if state.sta_gt.shape[1]:
        has = has | holds(state.sta_gt, state.sta_member, state.sta_meta,
                          state.sta_payload)
    return has


def coverage(state: PeerState, member: int, gt: int, meta: int,
             payload: int) -> torch.Tensor:
    """f32: fraction of alive non-tracker peers whose store holds the
    record (the convergence metric)."""
    syncing = state.alive & ~state.is_tracker
    num = (_holds_record(state, member, gt, meta, payload)
           & syncing).sum().to(torch.float32)
    den = syncing.sum().clamp(min=1).to(torch.float32)
    return num / den


def coverage_by_community(state: PeerState, cfg: CommunityConfig,
                          member: int, gt: int, meta: int,
                          payload: int) -> torch.Tensor:
    """f32 [C]: per community, the fraction of its alive members holding
    the record (:func:`coverage` block by block; a record authored in
    one block lives in no other)."""
    dev = state.device
    comm = torch.from_numpy(cfg.layout()[0]).to(dev)
    syncing = state.alive & ~state.is_tracker
    has = _holds_record(state, member, gt, meta, payload) & syncing
    out = []
    for c in range(cfg.n_communities):
        in_c = comm == c
        out.append((has & in_c).sum().to(torch.float32)
                   / (syncing & in_c).sum().clamp(min=1).to(torch.float32))
    return torch.stack(out)


def unload_members(state: PeerState, cfg: CommunityConfig,
                   mask) -> PeerState:
    """Unload the community instance on the masked peers: ``loaded`` off
    and the instance memory (:data:`state.INSTANCE_MEMORY_FIELDS`: the
    candidate table, the forward buffer, the blacklist, the delay pen,
    the signature cache) wiped, while the store persists.  Tracker rows
    are left out of the mask.  A peer loads again by an arriving
    community packet under ``cfg.auto_load``, by :func:`load_members`,
    or by churn rebirth."""
    n, dev = cfg.n_peers, state.device
    mj = (torch.as_tensor(mask, device=dev).to(torch.bool).reshape(n)
          & (torch.arange(n, device=dev) >= cfg.n_trackers))
    state = wipe_instance_memory(state, mj)
    return state.replace(loaded=state.loaded & ~mj)


def load_members(state: PeerState, mask) -> PeerState:
    """Load the community instance on the masked peers again; they walk
    anew from the trackers (candidates are not kept)."""
    m = torch.as_tensor(mask, device=state.device).to(torch.bool)
    return state.replace(loaded=m.reshape(state.loaded.shape) | state.loaded)


def track_record(state: PeerState, cfg: CommunityConfig, author: int,
                 gt: int) -> tuple:
    """Register record ``(author, gt)`` for dissemination tracing: the
    first free tracked slot takes its key, and every peer already
    holding the record in its logical store (ring and staging) gets its
    lineage stamped on the create channel -- at the intended call time,
    right after the create, that is the author.  Idempotent: a key
    already tracked returns its slot untouched.  Returns ``(state,
    slot)``; raises when the plane is off or every slot is taken (slots
    are never freed).  Runs on the state's device (the slot keys are
    read to the host)."""
    if not cfg.trace.enabled:
        raise ValueError("track_record needs cfg.trace.enabled (the "
                         "dissemination-tracing plane)")
    author, gt = author & MASK, gt & MASK
    keys_m = wide(state.trace_member).tolist()
    keys_g = wide(state.trace_gt).tolist()
    for k, (m, g) in enumerate(zip(keys_m, keys_g)):
        if m == author and g == gt:
            return state, k
    free = [k for k, m in enumerate(keys_m) if m == EMPTY_U32]
    if not free:
        raise ValueError(
            f"all {cfg.trace.tracked_slots} tracked slots are taken "
            "(trace.tracked_slots); slots are never freed")
    slot = free[0]
    col = torch.arange(cfg.trace.tracked_slots,
                       device=state.device) == slot
    holds = ((wide(state.store_member) == author)
             & (wide(state.store_gt) == gt)).any(dim=1)
    if state.sta_gt.shape[1]:
        holds = holds | ((wide(state.sta_member) == author)
                         & (wide(state.sta_gt) == gt)).any(dim=1)
    first = wide(state.trace_first)
    newly = holds[:, None] & col[None, :] & (first == 0)
    tdel = wide(state.stats.trace_delivered)
    tdel[:, trp.CH_CREATE - 1] += newly.any(dim=1).to(torch.int64)
    return state.replace(
        trace_member=narrow(torch.where(col, author,
                                        wide(state.trace_member))),
        trace_gt=narrow(torch.where(col, gt, wide(state.trace_gt))),
        trace_first=narrow(torch.where(
            newly, wide(state.round_index) + 1, first)),
        trace_chan=torch.where(newly, trp.CH_CREATE, state.trace_chan),
        stats=state.stats.replace(trace_delivered=narrow(tdel))), slot
