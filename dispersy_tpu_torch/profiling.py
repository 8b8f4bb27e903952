"""The bench shape (port of ``bench_config`` in ``dispersy_tpu/profiling.py``),
the permissioned, the hardened and the soak communities, the chaos round
and the observed round (telemetry and tracing) at that shape, the
schedules that drive them, and the card's profile of a main path.

Only the config builder is ported: the JAX module's cost-analysis
helpers price XLA executables and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple

import numpy as np

from dispersy_tpu_torch.config import (DEFAULT_PRIORITY, EMPTY_U32,
                                       META_AUTHORIZE, META_DESTROY,
                                       META_DYNAMIC, META_IDENTITY,
                                       META_REVOKE, META_UNDO_OTHER,
                                       META_UNDO_OWN, CommunityConfig,
                                       perm_bit)
from dispersy_tpu_torch.planes import (FaultModel, OverloadConfig,
                                       ParallelConfig, RecoveryConfig,
                                       StoreConfig, TelemetryConfig,
                                       TraceConfig)


def bench_config(n_peers: int, platform: str = "tpu") -> CommunityConfig:
    """``bench.py``'s worker config at ``n_peers`` — the same values as the
    JAX package's ``profiling.bench_config``.

    ``platform="tpu"`` is the 1M-peer shape (M=48 store slots,
    bloom_capacity=48 -> 480 filter bits = 15 words), ``"cpu"`` the 64k
    rung (M=64).  Both carry the byte-diet store (staging 8, a compaction
    window of 12 rounds staggered over 4 cohorts, u16 aux and candidate
    stamps); :func:`slice_config` is the same shape on the legacy ring.
    """
    diet = StoreConfig(staging=8, compact_every=12, aux_bits=16,
                       cohorts=4, cand_bits=16)
    if platform == "cpu":
        return CommunityConfig(
            n_peers=n_peers, n_trackers=max(2, min(4, n_peers // 1024)),
            k_candidates=16, msg_capacity=64, bloom_capacity=64,
            request_inbox=4,
            tracker_inbox=max(64, min(256, n_peers // 64)),
            response_budget=8, churn_rate=0.0, store=diet)
    return CommunityConfig(
        n_peers=n_peers, n_trackers=max(2, min(8, n_peers // 1024)),
        k_candidates=16, msg_capacity=48, bloom_capacity=48,
        request_inbox=4, tracker_inbox=max(64, min(1024, n_peers // 64)),
        response_budget=8, churn_rate=0.0, store=diet)


def slice_config(n_peers: int) -> CommunityConfig:
    """The port's full-width slice: the 1M bench shape on the legacy ring
    (``store=StoreConfig()``), every other plane at its defaults."""
    return bench_config(n_peers, "tpu").replace(store=StoreConfig())


def permissioned_config(n_peers: int) -> CommunityConfig:
    """The forum community of ``examples/forum.py`` at the slice's widths:
    what ``dispersy_tpu/community.py`` compiles from its three
    declarations -- a public full-sync post (meta 0), a pin that starts
    LinearResolution and can be flipped public (meta 1, dynamic), and a
    LastSync(1) profile (meta 2) -- with ``k_authorized=8`` as there.
    The Timeline needs the legacy ring (the config refuses it with
    ``store.staging > 0``)."""
    return slice_config(n_peers).replace(
        n_meta=3, timeline_enabled=True, protected_meta_mask=0b010,
        dynamic_meta_mask=0b010, last_sync_history=(0, 0, 1),
        meta_priority=(DEFAULT_PRIORITY,) * 3, k_authorized=8)


# Metas of the permissioned community.
POST, PIN, PROFILE = 0, 1, 2
# A moderator's grant on the pin: permit | authorize | undo.
MOD_GRANT = (perm_bit(PIN, "permit") | perm_bit(PIN, "authorize")
             | perm_bit(PIN, "undo"))
PIN_PERMIT = perm_bit(PIN, "permit")
# The rounds of the schedule: each create runs before ``step`` of its
# round.  The revoke falls in the first 8 rounds, so a 3 + 5 round run
# at full width reaches it.
R_DELEGATE, R_REVOKE, R_DELEGATE_PIN = 4, 6, 7
R_FLIP, R_UNDO, R_PUBLIC_PIN, R_DESTROY = 12, 14, 16, 18
BURST = 6           # profile updates the revoked moderator makes first


class Create(NamedTuple):
    """One ``create_messages`` call of a schedule, made before ``step``
    of ``round``.  ``aux`` None (undo-other only) means: the global time
    of the pin that the payload member authored, read from its own store
    when the call is made (:func:`pin_gt`)."""
    round: int
    meta: int
    authors: np.ndarray      # bool[N]
    payload: np.ndarray      # uint32[N]
    aux: np.ndarray | None   # uint32[N]


def one_record_schedule(n_peers: int) -> list:
    """The legacy and diet rounds' creates: one record (meta 1, payload
    its author's id) by every 64th peer before round 0."""
    idx = np.arange(n_peers, dtype=np.uint32)
    return [Create(0, 1, idx % 64 == 0, idx, np.zeros_like(idx))]


class Track(NamedTuple):
    """``engine.track_record(author, gt)`` before round ``round``'s step
    (after its creates)."""
    round: int
    author: int
    gt: int


def observed_config(n_peers: int) -> CommunityConfig:
    """The observed round: :func:`bench_config` with the telemetry plane
    (the packed row, a 64-round device ring, the histograms) and the
    dissemination-tracing plane (4 tracked slots) -- the JAX package's
    cost-ledger ``trace`` cell (``dispersy_tpu/costmodel.py:103-114``)."""
    return bench_config(n_peers).replace(
        telemetry=TelemetryConfig(enabled=True, history=64,
                                  histograms=True),
        trace=TraceConfig(enabled=True))


def observed_schedule(n_peers: int) -> list:
    """:func:`one_record_schedule` with the records of peers 64, 128, 192
    and 256 (global time 2) tracked right after their creates."""
    return one_record_schedule(n_peers) + [Track(0, a, 2)
                                           for a in (64, 128, 192, 256)]


def syncless_config(n_peers: int) -> CommunityConfig:
    """The byte-diet round without the sync exchange: :func:`bench_config`
    with ``sync_enabled=False`` and one cohort (the JAX package refuses
    cohorts > 1 without sync): no digest, freshness the exact test
    against ring and staging, records spread by push alone."""
    cfg = bench_config(n_peers)
    return cfg.replace(sync_enabled=False,
                       store=dataclasses.replace(cfg.store, cohorts=1))


def permissioned_roles(n_peers: int) -> dict:
    """The founder, the four moderators and their four delegates (peer
    ids), spread over the member range."""
    cfg = permissioned_config(n_peers)
    f, t = cfg.founder, cfg.n_trackers
    stride = (n_peers - t) // 4
    mods = f + 1 + stride * np.arange(4)
    return {"founder": f, "mods": mods, "delegates": mods + 2}


def permissioned_schedule(n_peers: int, destroy: bool = True) -> list:
    """The permissioned round's creates, in call order.

    Before round 0 the founder authorizes four moderators on the pin
    (one call each), every 64th peer posts on meta 0 and writes its
    profile twice (LastSync keep-last-1 evicts the first).  Authority
    spreads only by sync, so the later steps wait for it: the
    moderators delegate the pin's permit to one member each and pin
    (round 4, where the grant has reached them; the delegates pin too,
    before they can hold theirs: a no-op); moderator 0 bumps its clock with
    ``BURST`` profile updates, delegates and pins once more, and the
    founder revokes it (round 6: the retro pass runs at the founder);
    the delegates pin (rounds 7 and 8); the founder flips the pin public
    (round 12); moderator 3 undoes its delegate's pin (round 14, once
    the pin has reached it); every 8th peer pins (round 16: a no-op
    where the flip has not arrived); with ``destroy`` the founder
    destroys the community (round 18)."""
    n = n_peers
    roles = permissioned_roles(n)
    f, mods, dels = roles["founder"], roles["mods"], roles["delegates"]
    idx = np.arange(n, dtype=np.uint32)
    zero = np.zeros(n, np.uint32)

    def who(*ids):
        m = np.zeros(n, bool)
        m[list(ids)] = True
        return m

    def at(ids, vals):
        out = zero.copy()
        out[ids] = vals
        return out
    every64 = np.arange(n) % 64 == 0
    out = [Create(0, META_AUTHORIZE, who(f), at([f], m), at([f], MOD_GRANT))
           for m in mods]
    out += [Create(0, POST, every64, idx, zero),
            Create(0, PROFILE, every64, idx + 1, zero),
            Create(0, PROFILE, every64, idx + 2, zero),
            Create(R_DELEGATE, META_AUTHORIZE, who(*mods), at(mods, dels),
                   at(mods, PIN_PERMIT)),
            Create(R_DELEGATE, PIN, who(*mods), idx + 100, zero),
            Create(R_DELEGATE, PIN, who(*dels), idx + 200, zero)]
    out += [Create(R_REVOKE, PROFILE, who(mods[0]), idx + 400 + i, zero)
            for i in range(BURST)]
    out += [Create(R_REVOKE, META_AUTHORIZE, who(mods[0]),
                   at([mods[0]], mods[0] + 4), at([mods[0]], PIN_PERMIT)),
            Create(R_REVOKE, PIN, who(mods[0]), idx + 500, zero),
            Create(R_REVOKE, META_REVOKE, who(f), at([f], mods[0]),
                   at([f], MOD_GRANT)),
            Create(R_DELEGATE_PIN, PIN, who(*dels), idx + 300, zero),
            Create(R_DELEGATE_PIN + 1, PIN, who(*dels), idx + 700, zero),
            Create(R_UNDO, META_UNDO_OTHER, who(mods[3]),
                   at([mods[3]], dels[3]), None),
            Create(R_FLIP, META_DYNAMIC, who(f), at([f], PIN), zero),
            Create(R_PUBLIC_PIN, PIN, np.arange(n) % 8 == 5, idx + 600,
                   zero)]
    if destroy:
        out.append(Create(R_DESTROY, META_DESTROY, who(f), zero, zero))
    return out


def hardened_config(n_peers: int) -> CommunityConfig:
    """The hardened community at the slice's widths: what
    ``dispersy_tpu/community.py`` compiles from the ``full-sync-text``
    (meta 0) and ``sequence-text`` (meta 1, sequence numbers on) metas of
    Dispersy's test community, with the identity gate (a user record
    needs its author's dispersy-identity record stored) and double-sign
    conviction with malicious-proof gossip (8 blacklist slots) on, on
    the legacy ring."""
    return slice_config(n_peers).replace(
        n_meta=2, seq_meta_mask=0b10, last_sync_history=(0, 0),
        meta_priority=(DEFAULT_PRIORITY,) * 2,
        identity_enabled=True, identity_required=True,
        malicious_enabled=True, k_malicious=8, malicious_gossip=True)


def chaos_config(n_peers: int, shards: int = 8,
                 budget: int = 4096) -> CommunityConfig:
    """The chaos round: :func:`bench_config` with the planes that the
    JAX package's cost ledger stacks for its cumulative ``overload``
    cell (``dispersy_tpu/costmodel.py:115-127``) -- 10% i.i.d. loss, the
    Gilbert–Elliott channel, 2% duplication and 2% corruption, two
    flooders blasting 4 junk packets a round, the health sentinels, the
    recovery plane and overload's token buckets with priority admission
    -- on the ragged cross-shard exchange of the ``mesh8`` cell
    (``costmodel.py:78``): ``shards`` peer-axis shards, each
    (source shard, destination shard) push bucket capped at ``budget``
    edges a round.  ``shards=0`` is the same planes on the unsharded
    delivery.

    The ``mesh8`` cell sets no ``ParallelConfig``: the default
    ``budget=4096`` is a value chosen so that the cap binds at 1M peers
    and the capped exchange runs, not a deployment's setting.  At 1M it
    sheds most push edges, and the trackers' inboxes overflow into
    quarantine, so this config is no benchmark cell until a source or a
    measured traffic mix fixes the budget and the trackers'
    ``health_drop_limit``."""
    faults = FaultModel(
        ge_p_bad=0.05, ge_p_good=0.3, ge_loss_good=0.01, ge_loss_bad=0.5,
        dup_rate=0.02, corrupt_rate=0.02, flood_senders=(3, 5),
        flood_fanout=4, health_checks=True)
    cfg = bench_config(n_peers).replace(
        packet_loss=0.1, faults=faults,
        recovery=RecoveryConfig(enabled=True),
        overload=OverloadConfig(enabled=True))
    if shards > 1:
        cfg = cfg.replace(parallel=ParallelConfig(
            shards=shards, cross_shard_budget=budget))
    return cfg


# Metas of the hardened community, and the rounds of its sequence chain.
TEXT, SEQ_TEXT = 0, 1
SEQ_ROUNDS = (0, 1, 2, 4, 6)
R_EQUIVOCATE = 4


class Plant(NamedTuple):
    """A record planted into each masked peer's own forward buffer before
    ``step`` of ``round``, in the manner of a hand-crafted packet: it is
    pushed in that round and stored nowhere by its author.  Member is the
    peer, aux 0."""
    round: int
    peers: np.ndarray        # bool[N]
    gt: np.ndarray           # uint32[N]
    meta: int
    payload: np.ndarray      # uint32[N]


def hardened_roles(n_peers: int) -> dict:
    """The authors (every 64th non-tracker peer) and the equivocators
    (every 4096th, at least 4 of the authors at small N), as bool[N]
    masks, and each author's ordinal ``j`` (-1 for the rest)."""
    t = hardened_config(n_peers).n_trackers
    idx = np.arange(n_peers)
    authors = (idx >= t) & ((idx - t) % 64 == 0)
    j = np.where(authors, (idx - t) // 64, -1)
    stride = max(1, min(64, int(authors.sum()) // 4))
    return {"authors": authors, "j": j,
            "equivocators": authors & (j % stride == 0)}


def post_gt(n_peers: int) -> np.ndarray:
    """uint32[N]: the global time of each author's round-0 post.  Every
    clock is 1 before round 0, whose creates run identity (a quarter of
    the authors), post, sequence record -- so the post claims 3 after a
    round-0 identity, else 2."""
    j = hardened_roles(n_peers)["j"]
    return np.where(j % 4 == 0, 3, 2).astype(np.uint32)


def hardened_schedule(n_peers: int, registry=None) -> list:
    """The hardened round's creates and plants, in call order.  The
    authors publish their identities (payload the mid32 of ``registry``,
    default ``crypto.MemberRegistry()``) over rounds 0-3, a quarter a
    round; each posts once on meta 0 in round 0 and writes its
    sequence-text chain (meta 1, payload its id + 1000 per link) in the
    rounds of ``SEQ_ROUNDS``; in round 4 each equivocator plants a second
    meta-0 record with its post's global time and another payload (its
    id + 2^31) into its own forward buffer."""
    from dispersy_tpu_torch.crypto import MemberRegistry
    n = n_peers
    roles = hardened_roles(n)
    authors, j = roles["authors"], roles["j"]
    idx = np.arange(n, dtype=np.uint32)
    zero = np.zeros(n, np.uint32)
    mid32 = zero.copy()
    mid32[authors] = (registry or MemberRegistry()).mid32_of(
        np.flatnonzero(authors))
    ids = [Create(r, META_IDENTITY, authors & (j % 4 == r), mid32, zero)
           for r in range(4)]
    seq = [Create(r, SEQ_TEXT, authors, idx + 1000 * (k + 1), zero)
           for k, r in enumerate(SEQ_ROUNDS)]
    out = [ids[0], Create(0, TEXT, authors, idx, zero), seq[0]]
    out += ids[1:] + seq[1:]
    out.append(Plant(R_EQUIVOCATE, roles["equivocators"], post_gt(n), TEXT,
                     idx + np.uint32(1 << 31)))
    return sorted(out, key=lambda c: c.round)


def soak_config(n_peers: int) -> CommunityConfig:
    """The soak community at the slice's widths: the protocol knobs of
    the JAX package's everything-on soak (``examples/soak_all_features
    .json``) -- eight metas; the Timeline with meta 1 protected and
    dynamic and 8 table slots; the delay pen (3 slots) with missing-proof
    requests; meta 3 double-signed; meta 4 sequenced with missing-
    sequence requests; double-sign conviction with gossip; a 30%
    symmetric-NAT share, 3% churn and 10% loss -- and the three knobs
    that file leaves off: missing-message requests, the identity gate
    with missing-identity requests, and meta 5 direct.  The file's
    ``auto_load`` and its unload / load events belong to the community
    rim and are left out (its ``auto_load`` is off, the default)."""
    return slice_config(n_peers).replace(
        n_meta=8, timeline_enabled=True, protected_meta_mask=0b10,
        dynamic_meta_mask=0b10, k_authorized=8, delay_inbox=3,
        proof_requests=True, double_meta_mask=1 << DOUBLE,
        seq_meta_mask=1 << SEQ, seq_requests=True, malicious_enabled=True,
        malicious_gossip=True, p_symmetric=0.3, churn_rate=0.03,
        packet_loss=0.1, msg_requests=True, identity_enabled=True,
        identity_required=True, identity_requests=True,
        direct_meta_mask=1 << DIRECT)


# Metas of the soak community: a public post, the protected dynamic
# meta, the double-signed, the sequenced and the direct one.
SOAK_POST, SOAK_PROTECTED, DOUBLE, SEQ, DIRECT = 0, 1, 3, 4, 5
# A grantee's grant: permit and authorize on meta 1 (the soak file's),
# and undo on meta 0 (so its undo-other of a post needs the grant).
SOAK_GRANT = (perm_bit(SOAK_PROTECTED, "permit")
              | perm_bit(SOAK_PROTECTED, "authorize")
              | perm_bit(SOAK_POST, "undo"))
SOAK_GRANT_ROUNDS = (0, 1, 2)
SOAK_ROUNDS = range(3, 11)          # the posting rounds


class SigRequest(NamedTuple):
    """One ``create_signature_request`` call before ``step`` of
    ``round``: each masked author drafts ``meta`` with its
    ``counterparty``."""
    round: int
    meta: int
    authors: np.ndarray        # bool[N]
    counterparty: np.ndarray   # int32[N]
    payload: np.ndarray        # uint32[N]


class Undo(NamedTuple):
    """An undo-other by each masked author of its own newest stored
    record of ``meta`` (aux read from its own store when the call is
    made, as :func:`pin_gt` does)."""
    round: int
    authors: np.ndarray        # bool[N]
    meta: int


def soak_roles(n_peers: int, seed: int = 0, degree: int = 8) -> dict:
    """The authors (every 64th non-tracker peer, as bool[N]) and the
    four grantees: the first four of the founder's neighbours that
    ``engine.seed_overlay(state, cfg, degree)`` gives under ``seed``, so
    that the founder's round-0 to 2 pushes of their grants can reach
    them directly."""
    import torch

    from dispersy_tpu_torch.engine import overlay_draw
    from dispersy_tpu_torch.state import seed_key
    cfg = soak_config(n_peers)
    f, t = cfg.founder, cfg.n_trackers
    nbr = overlay_draw(torch.tensor(seed_key(seed), dtype=torch.int64),
                       cfg, torch.tensor([f]), degree)[0].numpy()
    idx = np.arange(n_peers)
    return {"authors": (idx >= t) & ((idx - t) % 64 == 0),
            "grantees": nbr[nbr >= 0][:4]}


def soak_schedule(n_peers: int, seed: int = 0, degree: int = 8) -> list:
    """The soak community's events, compressed so that every channel
    fires within 3 warm-up and 8 timed rounds at any width.

    Round 0: the authors and grantees publish their identities.  Rounds
    0-2: the founder grants each grantee :data:`SOAK_GRANT` (one call a
    grantee a round).  Rounds 1-10: each author drafts a double-signed
    record with the next author as its counterparty (refused while one
    is in flight; lost ones expire two rounds later).  Rounds 3-10: the
    authors post (meta 0), write two sequenced records (a lost first
    link leaves a gap) and send a direct record; the grantees post on
    the protected meta (receivers without the grant park and ask for
    the proof) and, from round 4, undo their round-3 post (receivers
    without it park and ask for it).  A post reaching a peer without
    its author's identity parks and asks for it."""
    n = n_peers
    roles = soak_roles(n, seed, degree)
    authors, grantees = roles["authors"], roles["grantees"]
    cfg = soak_config(n)
    f = cfg.founder
    idx = np.arange(n, dtype=np.uint32)
    zero = np.zeros(n, np.uint32)
    g_mask = np.zeros(n, bool)
    g_mask[grantees] = True
    founder = np.zeros(n, bool)
    founder[f] = True
    ids = np.flatnonzero(authors)
    cp = np.full(n, -1, np.int32)
    cp[ids] = np.roll(ids, -1)
    out = [Create(0, META_IDENTITY, authors | g_mask, idx, zero)]
    for r in SOAK_GRANT_ROUNDS:
        for g in grantees:
            out.append(Create(r, META_AUTHORIZE, founder,
                              np.where(founder, g, 0).astype(np.uint32),
                              np.where(founder, SOAK_GRANT, 0).astype(
                                  np.uint32)))
    for r in range(1, 11):
        out.append(SigRequest(r, DOUBLE, authors, cp,
                              idx + np.uint32(1000 * r)))
    for r in SOAK_ROUNDS:
        pay = idx + np.uint32(100_000 * r)
        out += [Create(r, SOAK_POST, authors, pay, zero),
                Create(r, SEQ, authors, pay + 1, zero),
                Create(r, SEQ, authors, pay + 2, zero),
                Create(r, DIRECT, authors, pay + 3, zero),
                Create(r, SOAK_PROTECTED, g_mask, pay + 4, zero)]
        if r == SOAK_ROUNDS[0]:
            out.append(Create(r, SOAK_POST, g_mask, pay + 5, zero))
        else:
            out.append(Undo(r, g_mask, SOAK_POST))
    return sorted(out, key=lambda c: c.round)


FWD_COLS = ("gt", "member", "meta", "payload", "aux")
FWD_COLS = ("gt", "member", "meta", "payload", "aux")


def plant_fwd(fwd: dict, plant: Plant) -> dict:
    """The forward-buffer columns ``fwd`` (``FWD_COLS`` -> int64 [N, F]
    numpy arrays, of either package's state) with ``plant``'s record at
    each masked peer's first free slot, the last one when the buffer is
    full (the slot a create takes)."""
    ids = np.flatnonzero(plant.peers)
    out = {k: np.array(v, dtype=np.int64) for k, v in fwd.items()}
    f = out["gt"].shape[1]
    put = np.minimum((out["gt"][ids] != EMPTY_U32).sum(1), f - 1)
    for k, v in zip(FWD_COLS, (plant.gt[ids], ids, plant.meta,
                               plant.payload[ids], 0)):
        out[k][ids, put] = v
    return out


def run_creates(state, cfg: CommunityConfig, creates: list, rnd: int):
    """Make the creates, plants and tracks of round ``rnd`` on a port
    state, in order (an undo-other's aux read from the state's own store
    rows)."""
    import torch

    from dispersy_tpu_torch import engine
    from dispersy_tpu_torch.u32 import bits, cast, wide

    def rows(ids):
        # Indexed through the signed views (no u32 indexing on the card).
        ix = torch.as_tensor(ids, device=state.device)
        return tuple(wide(bits(getattr(state, k))[ix]).cpu().numpy()
                     for k in ("store_gt", "store_member", "store_meta"))
    for c in creates:
        if c.round != rnd:
            continue
        if isinstance(c, Track):
            state, _ = engine.track_record(state, cfg, c.author, c.gt)
            continue
        if isinstance(c, SigRequest):
            state = engine.create_signature_request(
                state, cfg, torch.from_numpy(c.authors).to(state.device),
                c.meta, torch.from_numpy(c.counterparty).to(state.device),
                torch.from_numpy(c.payload.astype(np.int64)).to(
                    state.device))
            continue
        if isinstance(c, Undo):
            c = Create(c.round, META_UNDO_OTHER, c.authors,
                       np.arange(len(c.authors), dtype=np.uint32),
                       pin_gt(np.arange(len(c.authors), dtype=np.uint32),
                              c.authors, rows, c.meta))
        if isinstance(c, Plant):
            cols = {k: getattr(state, f"fwd_{k}") for k in FWD_COLS}
            new = plant_fwd({k: wide(v).cpu().numpy()
                             for k, v in cols.items()}, c)
            state = state.replace(**{
                f"fwd_{k}": cast(torch.from_numpy(new[k]).to(state.device),
                                 cols[k].dtype) for k in FWD_COLS})
            continue
        aux = c.aux if c.aux is not None else pin_gt(c.payload, c.authors,
                                                     rows)
        state = engine.create_messages(
            state, cfg, torch.from_numpy(c.authors).to(state.device), c.meta,
            torch.from_numpy(c.payload.astype(np.int64)).to(state.device),
            torch.from_numpy(aux.astype(np.int64)).to(state.device))
    return state


def pin_gt(payload: np.ndarray, authors: np.ndarray, rows,
           meta: int = PIN) -> np.ndarray:
    """uint32[N] aux of an undo-other call: for each author, the highest
    global time of a record of ``meta`` (a pin by default) that its
    payload member holds in its own store, else 0.  ``rows(ids)``
    returns the numpy ``(store_gt, store_member, store_meta)`` rows of
    those peers."""
    out = np.zeros(payload.shape[0], np.uint32)
    ids = np.flatnonzero(authors)
    if not ids.size:
        return out
    tgt = payload[ids].astype(np.int64)
    g, m, t = (np.asarray(a).astype(np.int64) for a in rows(tgt))
    own = (m == tgt[:, None]) & (t == meta) & (g != EMPTY_U32)
    out[ids] = np.where(own, g, 0).max(axis=1)
    return out


# Every device function of the hand-written kernels (csrc/*.cu) is named
# with this prefix, which gives the profile's own-kernel share.
OWN_KERNEL_PREFIX = "dk_"
# The engine's profiler ranges around the telemetry and trace planes'
# work (``torch.profiler.record_function`` in ``engine._step_impl``).
ENGINE_SCOPES = ("trace_lineage", "trace_coverage", "telemetry_row")


def profile_rounds(n_peers: int = 1 << 20, warmup: int = 3, rounds: int = 3,
                   seed: int = 0, top: int = 15, diet: bool = False,
                   timeline: bool = False, hardened: bool = False,
                   chaos: bool = False, observed: bool = False,
                   soak: bool = False) -> dict:
    """Trace ``rounds`` rounds of a main path on the card with
    ``torch.profiler``: the legacy ring (:func:`slice_config`); with
    ``diet``, the byte-diet round of :func:`bench_config` (3 rounds after
    3 warm-up rounds are two quiet rounds and one sync round, one stride
    of the cohort cadence); with ``timeline``, the permissioned round of
    :func:`permissioned_config` driven by :func:`permissioned_schedule`
    (no destroy; the 3 traced rounds are rounds 3-5 of the schedule, the
    moderators' delegations included); with ``hardened``, the hardened
    round of :func:`hardened_config` driven by :func:`hardened_schedule`
    (the traced rounds 3-5 hold the round-4 equivocations and the
    convictions and gossip they start); with ``chaos``, the chaos round
    of :func:`chaos_config` (8 shards, budget 4096) driven by
    :func:`one_record_schedule`; with ``observed``, the observed round of
    :func:`observed_config` driven by :func:`observed_schedule` (the
    traced rounds as ``diet``'s); with ``soak``, the soak round of
    :func:`soak_config` driven by :func:`soak_schedule` (the traced
    rounds 3-5: posts, sequence gaps, undos, drafts, the pen's four
    channels).  Reports wall time; device busy time (the sum
    of the device-side events' times -- the round runs on one stream);
    the share of it in the hand-written kernels; the device time the
    profiler gives each of the engine's plane ranges
    (:data:`ENGINE_SCOPES`); and the ``top`` entries
    by device time, both as PyTorch ops (host-side events, each charged
    the device time of its own kernels) and as device kernels.  Needs a
    CUDA card; the run is driven as ``chip_smoke.py``'s main path is.
    ``python -m dispersy_tpu_torch.profiling [--diet | --timeline |
    --hardened | --chaos | --observed | --soak]`` prints it as one JSON
    line."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dispersy_tpu_torch import engine
    from dispersy_tpu_torch.state import init_state
    from dispersy_tpu_torch.storediet import phase_of

    if diet + timeline + hardened + chaos + observed + soak > 1:
        raise ValueError("pick one of diet, timeline, hardened, chaos, "
                         "observed and soak")
    if soak:
        cfg = soak_config(n_peers)
        creates = soak_schedule(n_peers, seed)
    elif observed:
        cfg = observed_config(n_peers)
        creates = observed_schedule(n_peers)
    elif chaos:
        cfg = chaos_config(n_peers)
        creates = one_record_schedule(n_peers)
    elif hardened:
        cfg = hardened_config(n_peers)
        creates = hardened_schedule(n_peers)
    elif timeline:
        cfg = permissioned_config(n_peers)
        creates = permissioned_schedule(n_peers, destroy=False)
    else:
        cfg = bench_config(n_peers) if diet else slice_config(n_peers)
        creates = one_record_schedule(n_peers)
    state = engine.seed_overlay(init_state(cfg, seed, device="cuda"), cfg, 8)

    def advance(state, rnd):
        state = run_creates(state, cfg, creates, rnd)
        return engine.step(state, cfg)
    for rnd in range(warmup):
        state = advance(state, rnd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for rnd in range(warmup, warmup + rounds):
            state = advance(state, rnd)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # The engine's ranges are not kernels (the profiler may put them on
    # the device timeline): they are reported apart.
    events = [e for e in prof.key_averages() if e.self_device_time_total
              and e.key not in ENGINE_SCOPES]
    device = [e for e in events if e.device_type != DeviceType.CPU]
    ops = [e for e in events if e.device_type == DeviceType.CPU]

    def ms(evs):
        return sum(e.self_device_time_total for e in evs) / 1e3 / rounds

    def own(e):
        name = e.key.removeprefix("(anonymous namespace)::")
        return (name.split("(")[0].split("::")[-1]
                .startswith(OWN_KERNEL_PREFIX))

    def table(evs):
        evs = sorted(evs, key=lambda e: e.self_device_time_total,
                     reverse=True)[:top]
        return [{"name": e.key[:100], "device_ms_per_round": ms([e]),
                 "calls_per_round": e.count / rounds} for e in evs]
    busy = ms(device)
    return {
        "n_peers": n_peers, "rounds": rounds, "diet": diet,
        "timeline": timeline, "hardened": hardened, "chaos": chaos,
        "observed": observed, "soak": soak,
        "phases": [phase_of(cfg, warmup + i) for i in range(rounds)],
        "wall_ms_per_round": wall_ms / rounds,
        "device_busy_ms_per_round": busy,
        "device_idle_share": 1.0 - busy * rounds / wall_ms,
        "own_kernel_ms_per_round": ms([e for e in device if own(e)]),
        "scope_device_ms_per_round": {
            e.key: e.device_time_total / 1e3 / rounds
            for e in prof.key_averages() if e.key in ENGINE_SCOPES},
        "device_events_per_round": sum(e.count for e in device) / rounds,
        "top_ops": table(ops), "top_kernels": table(device),
    }


# What K12's capped calls get in the 1M chaos round: the deliverable
# share of the push blast's edges, its shares over the tenths of an
# [8, El] row and over the 8 destination shards, and the admission
# classes' shares.  Read by :func:`ragged_shares` (5 timed rounds of
# chip_smoke.py's chaos main path: every one of the 64 buckets binds in
# every call, crossing groups of 1-5 edges) on an NVIDIA H100 80GB HBM3;
# :func:`push_blast_arrays` draws the timed push blasts with them.
RAGGED_SHARES = {
    "deliverable": 0.05004404383084371,
    "row_tenths": (0.2193732827145362, 0.20900866793435988,
                   0.20906361471697166, 0.2081971706535904,
                   0.054051118294070735, 0.020768613381415474,
                   0.02069111618513064, 0.02066602487977612,
                   0.0208130789858412, 0.017367312254307685),
    "dest_shards": (0.1353552055406684, 0.1237385663844477,
                    0.12369346555710162, 0.1234787602100174,
                    0.12371411030201356, 0.12311033091620426,
                    0.1232440453409416, 0.12366551574860545),
    "classes": {31: 3.1761146018375093e-07, 127: 0.9999898364332741,
                255: 9.845955265696279e-06}}


def push_blast_arrays(rs, cfg):
    """The chaos round's push blast at ``cfg``'s shape (the forward
    fan-out plus the flooders' junk) as numpy arrays ``(dst, valid,
    cls)`` carrying :data:`RAGGED_SHARES`: a valid edge is deliverable,
    drawn with the round's share in each tenth of its [8, El] row, to a
    destination shard with the round's shares and a uniform peer in it;
    each edge's class drawn with the round's shares."""
    n, fm = cfg.n_peers, cfg.faults
    e = (n * cfg.forward_buffer * cfg.forward_fanout
         + len(fm.flood_senders) * fm.flood_fanout)
    sh = RAGGED_SHARES
    s = len(sh["dest_shards"])
    el, nl = -(-e // s), n // s
    tenth = (np.arange(e) % el) * 10 // el
    p = sh["deliverable"] * 10 * np.asarray(sh["row_tenths"])
    valid = rs.random(e) < p[tenth]
    dst = (rs.choice(s, size=e, p=np.asarray(sh["dest_shards"])) * nl
           + rs.integers(0, nl, size=e)).astype(np.int32)
    cls = rs.choice(np.asarray(list(sh["classes"]), np.uint8), size=e,
                    p=np.asarray(list(sh["classes"].values())))
    return dst, valid, cls


def delivery_cases(n_peers: int = 1 << 20, seed: int = 0) -> dict:
    """K1's and K12's call shapes in the rounds at ``n_peers`` peers, on
    random inputs made with a numpy seed on the card (the chaos push
    blast with the round's shares, :func:`push_blast_arrays`, capped at
    the round's budget and at one that binds in no bucket): ``{name:
    (kernel, plain, yardstick)}``, three functions of no argument -- the
    kernel's wrapper, its plain version and one ``torch.sort`` of the
    packed (destination, class, position) key that orders the same
    edges."""
    import torch

    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import inbox

    rs = np.random.default_rng(seed)
    dev = torch.device("cuda")
    n = n_peers
    leg, chaos = slice_config(n), chaos_config(n)

    def u32(*shape, hi=1 << 32):
        a = rs.integers(0, hi, size=shape, dtype=np.uint64)
        return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(
            dev).view(torch.uint32)

    def u16(e):
        a = rs.integers(0, 1 << 16, size=e).astype(np.uint16)
        return torch.from_numpy(a.view(np.int16)).to(dev).view(torch.uint16)

    def u8(e, hi=256):
        return torch.from_numpy(rs.integers(0, hi, size=e).astype(
            np.uint8)).to(dev)

    def edges(e, n_dst, p, lo=-1):
        dst = torch.from_numpy(rs.integers(lo, n_dst + 1, size=e).astype(
            np.int32)).to(dev)
        return dst, torch.from_numpy(rs.random(e) < p).to(dev)

    def sort_key(dst, valid, n_dst, cls=None, shards=0):
        e = dst.shape[0]
        ok = valid & (dst >= 0) & (dst < n_dst)
        key = torch.where(ok, dst.long(), n_dst) * 256
        if cls is not None:
            key = key + cls.long()
        if not shards:
            return key * e + torch.arange(e, device=dev)
        el = -(-e // shards)
        pad = torch.full((shards * el - e,), n_dst * 256, dtype=torch.int64,
                         device=dev)
        key = torch.cat([key, pad])
        return (key * el + torch.arange(shards * el, device=dev) % el
                ).reshape(shards, el)

    def k1(dst, cols, valid, n_dst, q, cls=None):
        key = sort_key(dst, valid, n_dst, cls)
        return (lambda: kernels.deliver(dst, cols, valid, n_dst, q, cls),
                lambda: inbox.deliver_plain(dst, cols, valid, n_dst, q, cls),
                lambda: torch.sort(key))

    def k12(dst, cols, valid, q, budget, cls, receipts, shards=8):
        key = sort_key(dst, valid, n, cls, shards)
        return (lambda: kernels.deliver_ragged(dst, cols, valid, n, q, shards,
                                               budget, cls, receipts),
                lambda: inbox.deliver_ragged_plain(dst, cols, valid, n, q,
                                                   shards, budget, cls,
                                                   receipts),
                lambda: torch.sort(key, dim=1))

    e = n * leg.forward_buffer * leg.forward_fanout
    q, r = leg.push_inbox, leg.request_inbox
    idx = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    cases = {}
    dst, valid = edges(e, n, 0.9)
    cases["legacy_push"] = k1(dst, [u32(e), u32(e), u8(e, 8), u32(e),
                                    u32(e)], valid, n, q)
    cases["diet_push_u16"] = k1(dst, [u32(e), u32(e), u8(e, 8), u32(e),
                                      u16(e)], valid, n, q)
    dst, valid = edges(n, n, 0.9)
    cases["request_bloom"] = k1(dst, [idx] + [u32(n) for _ in range(5)]
                                + [u32(n, leg.bloom_words)], valid, n, r)
    cases["ragged_request"] = k12(dst, [idx, u32(n)], valid, r, 0, None,
                                  True)
    dst, valid = edges(n, leg.n_trackers, 0.08, lo=0)
    cases["tracker"] = k1(dst, [idx, u32(n)], valid, leg.n_trackers,
                          leg.tracker_inbox)
    dst, valid = edges(n * r, n, 0.7)
    cases["puncture"] = k1(dst, [u32(n * r, hi=n)], valid, n, r)
    cases["ragged_puncture"] = k12(dst, [u32(n * r, hi=n)], valid, r, 0,
                                   None, False)
    ep = n * r + leg.n_trackers * leg.tracker_inbox
    dst, valid = edges(ep, n, 0.7)
    cases["ragged_puncture_request"] = k12(dst, [u32(ep, hi=n)], valid, r,
                                           0, None, False)
    dst, valid, cls = (torch.from_numpy(a).to(dev)
                       for a in push_blast_arrays(rs, chaos))
    e = dst.shape[0]
    cols = [u32(e), u32(e), u8(e, 8), u32(e), u32(e),
            torch.from_numpy(rs.random(e) < 0.001).to(dev)]
    cases["cls_push"] = k1(dst, cols, valid, n, chaos.push_inbox, cls)
    budget = chaos.parallel.cross_shard_budget
    cases["ragged_push_cls"] = k12(dst, cols, valid, chaos.push_inbox,
                                   budget, cls, False)
    # A budget above every bucket's count, below El: it binds nowhere.
    free = int(ragged_bounds(dst, valid, cls, n, 8, budget)["count"].max())
    free += 1
    cases["ragged_push_cls_unbound"] = k12(dst, cols, valid,
                                           chaos.push_inbox, free, cls, False)
    return cases


def ragged_corner(rs, name: str, n: int, e: int, s: int):
    """One of K12's capped corners as numpy arrays ``(dst, valid, cls,
    budget)`` over ``n`` destinations, ``e`` edges and ``s`` shards (El =
    ceil(e / s); random destinations in [-1, n], half valid, random
    classes, then): ``"hot_crossing"`` four fifths of every row's edges
    to one destination d0 of shard s // 2 and a budget of El / 4, so its
    (row, d0) groups cross deep inside, over every class;
    ``"all_classes"`` a d0 group of 10 edges of each of the 256 classes
    in every row, crossing at its 1300th; ``"first_edge"`` the boundary
    of bucket (0, s // 2) is row 0's first edge (the only one to its
    destination); ``"last_edge"`` that of bucket (s - 1, s // 2) is the
    last row's last edge, the fourth of its (destination, class) group;
    ``"budget_1"`` a budget of one; ``"budget_el_minus_1"`` row 0 sends
    every edge to shard 0 and the budget El - 1 binds in that bucket
    alone; ``"some_buckets"`` shard 0 takes half the edges and the budget
    binds in its buckets only."""
    el, nl = -(-e // s), n // s
    dst = rs.integers(-1, n + 1, size=e).astype(np.int32)
    valid = rs.random(e) < 0.5
    cls = rs.integers(0, 256, size=e).astype(np.uint8)
    h0 = s // 2
    d0 = h0 * nl + nl // 2
    row = np.arange(e) // el

    def before(r):  # deliverable entries of bucket (r, h0) below d0
        ok = valid & (row == r) & (dst >= h0 * nl) & (dst < d0)
        return int(ok.sum())
    if name == "hot_crossing":
        hot = rs.random(e) < 0.8
        dst[hot], valid[hot] = d0, True
        budget = max(1, el // 4)
    elif name == "all_classes":
        dst[dst == d0] = -1
        for r in range(s):
            at = r * el + rs.choice(min(el, e - r * el), size=2560,
                                    replace=False)
            dst[at], valid[at] = d0, True
            cls[at] = rs.permutation(np.repeat(np.arange(256), 10))
        budget = before(0) + 1300
    elif name == "first_edge":
        dst[dst == d0] = -1
        dst[0], valid[0], cls[0] = d0, True, 0
        budget = before(0)
    elif name == "last_edge":
        r = s - 1
        dst[dst == d0] = -1
        at = np.sort(rs.choice(np.arange(r * el, e - 1), size=3,
                               replace=False))
        at = np.append(at, e - 1)
        dst[at], valid[at], cls[at] = d0, True, 7
        budget = before(r) + 3
    elif name == "budget_1":
        budget = 1
    elif name == "budget_el_minus_1":
        dst[:el] = rs.integers(0, nl, size=el)
        valid[:el] = True
        budget = el - 1
    elif name == "some_buckets":
        half = rs.random(e) < 0.5
        dst[half] = rs.integers(0, nl, size=int(half.sum()))
        budget = int(0.5 * 0.5 * el / s) + 1
    else:
        raise ValueError(f"no K12 corner {name}")
    return dst, valid, cls, budget


RAGGED_CORNERS = ("hot_crossing", "all_classes", "first_edge", "last_edge",
                  "budget_1", "budget_el_minus_1", "some_buckets")


def ragged_bounds(dst, valid, cls, n_peers: int, shards: int,
                  budget: int) -> dict:
    """Each (row, destination shard) bucket of a capped
    ``deliver_ragged`` call and, where its budget binds, the boundary
    entry K12's stages find (plain PyTorch, on the tensors' device):
    ``{"el", "b", "deliverable", "count": [S * S], "binding": [S * S]
    bool, "row", "d", "group", "m1", "c", "m2", "l"}``, the last seven
    one entry per binding bucket -- its row, the crossing destination d*,
    the size of the group (row, d*), m1 (its entries still kept), the
    class c*, m2 (the rank of the boundary edge among the group's class-c*
    edges) and the boundary edge's local position l* in its row."""
    import torch
    e, s = dst.shape[0], shards
    el, nl = -(-e // s), n_peers // s
    b = el if budget <= 0 else min(budget, el)
    ok = valid & (dst >= 0) & (dst < n_peers)
    idx = ok.nonzero().flatten()
    row, d = idx // el, dst[idx].long()
    c = (cls[idx].long() if cls is not None
         else torch.zeros_like(d))
    bucket = row * s + d // nl
    count = torch.bincount(bucket, minlength=s * s)
    # (bucket, destination, class) keys; a stable sort keeps edge order.
    key = (bucket * n_peers + d) * 256 + c
    ks, order = torch.sort(key, stable=True)
    start = torch.cumsum(count, 0) - count
    binding = count > b
    at = order[start[binding] + b]
    brow, bd, bc = row[at], d[at], c[at]
    bkey = (brow * s + bd // nl) * n_peers + bd
    group_lo = torch.searchsorted(ks, bkey * 256)
    group_hi = torch.searchsorted(ks, bkey * 256 + 256)
    cls_lo = torch.searchsorted(ks, bkey * 256 + bc)
    pos = start[binding] + b
    return {"el": el, "b": b, "e": e, "deliverable": int(idx.numel()),
            "count": count, "binding": binding, "row": brow, "d": bd,
            "group": group_hi - group_lo, "m1": pos - group_lo, "c": bc,
            "m2": pos - cls_lo, "l": idx[at] - brow * el}


def ragged_shares(n_peers: int = 1 << 20, warmup: int = 3, rounds: int = 5,
                  seed: int = 0, dev="cuda", budget: int = 4096) -> dict:
    """What K12's capped calls get in the timed rounds of the chaos round
    of :func:`chaos_config` (8 shards, ``budget``) driven by
    :func:`one_record_schedule`, as ``chip_smoke.py``'s chaos main path
    drives it (``warmup`` rounds, then ``rounds`` counted): per call the
    edges, the deliverable share, the buckets and the largest, and of
    the buckets whose budget binds (:func:`ragged_bounds`) the crossing
    groups' sizes, m1, m2, where the boundary edge lies in its row (l* /
    El) and the classes; of the deliverable edges the class shares, the
    shares in each tenth of a row and to each destination shard, and the
    largest (row, destination) groups.
    ``python -m dispersy_tpu_torch.profiling --ragged-shares`` prints it
    as one JSON line."""
    import torch

    from dispersy_tpu_torch import engine
    from dispersy_tpu_torch.ops import inbox
    from dispersy_tpu_torch.state import init_state

    cfg = chaos_config(n_peers, 8, budget)
    creates = one_record_schedule(n_peers)
    calls, counting = [], [False]
    saved = inbox.deliver_ragged

    def counted(dst, cols, valid, n, q, shards, budget=0, cls=None,
                need_receipts=True):
        el = -(-dst.shape[0] // shards)
        if counting[0] and 0 < budget < el:
            rb = ragged_bounds(dst, valid, cls, n, shards, budget)
            ok = valid & (dst >= 0) & (dst < n)
            at = ok.nonzero().flatten()
            group = torch.bincount((at // el) * n + dst[at].long())
            calls.append({k: (v.tolist() if isinstance(v, torch.Tensor)
                              else v) for k, v in rb.items()} | {
                "class_counts": None if cls is None else torch.bincount(
                    cls[at].long(), minlength=256).tolist(),
                "tenths": torch.bincount((at % el) * 10 // el,
                                         minlength=10).tolist(),
                "shard_counts": torch.bincount(
                    dst[at].long() // (n // shards),
                    minlength=shards).tolist(),
                "top_groups": torch.topk(group, 8).values.tolist(),
                "top_dests": (torch.topk(group, 8).indices % n).tolist()})
        return saved(dst, cols, valid, n, q, shards, budget, cls,
                     need_receipts)
    try:
        inbox.deliver_ragged = counted
        state = engine.seed_overlay(init_state(cfg, seed, device=dev),
                                    cfg, 8)
        for rnd in range(warmup + rounds):
            counting[0] = rnd >= warmup
            state = engine.step(run_creates(state, cfg, creates, rnd), cfg)
    finally:
        inbox.deliver_ragged = saved

    def spread(v):
        v = sorted(v)
        return ({"n": len(v), "min": v[0], "median": v[len(v) // 2],
                 "max": v[-1], "mean": sum(v) / len(v)} if v else {"n": 0})

    def shares(key):
        tot = [sum(x) for x in zip(*(c[key] for c in calls if c[key]))]
        return [v / sum(tot) for v in tot]
    cc = shares("class_counts")
    return {
        "n_peers": n_peers, "rounds": rounds, "capped_calls": len(calls),
        "edges": [c["e"] for c in calls], "el": [c["el"] for c in calls],
        "budget": [c["b"] for c in calls],
        "deliverable_share": [c["deliverable"] / c["e"] for c in calls],
        "bucket_count": spread([x for c in calls for x in c["count"]]),
        "binding_buckets": [sum(c["binding"]) for c in calls],
        "group": spread([x for c in calls for x in c["group"]]),
        "m1": spread([x for c in calls for x in c["m1"]]),
        "m2": spread([x for c in calls for x in c["m2"]]),
        "l_share": spread([x / c["el"] for c in calls for x in c["l"]]),
        "c_star": spread([x for c in calls for x in c["c"]]),
        "class_shares": {k: v for k, v in enumerate(cc) if v},
        "row_tenth_shares": shares("tenths"),
        "dest_shard_shares": shares("shard_counts"),
        "top_groups": [c["top_groups"] for c in calls],
        "top_dests": [c["top_dests"] for c in calls]}


SPIN_CYCLES_PER_S = 1.98e9  # the H100 SXM's highest SM clock (cycles of
                            # torch.cuda._sleep a second, at most)


def _flat(out) -> list:
    import torch
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


def _same(a, b) -> bool:
    """Bit-equal outputs (tensors or nested tuples of them)."""
    import torch
    a, b = _flat(a), _flat(b)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(a, b))


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``reps`` calls of ``fn``, each between its own pair of
    CUDA events, after 3 warm-up calls.  The timed calls queue behind a
    spin of the card (``torch.cuda._sleep``) as long as their enqueueing
    takes on the host (at most 50 ms), so that a call shorter than its
    wrapper's host work is timed by the device's work, not by the card
    idling between the events while the host prepares the launch."""
    import statistics
    import time

    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(min(1.5 * host_s * reps, 0.05) * SPIN_CYCLES_PER_S))
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def profile_delivery(n_peers: int = 1 << 20, reps: int = 20,
                     seed: int = 0) -> dict:
    """Each of :func:`delivery_cases` on the card: the kernel held bit
    for bit against its plain version once, then ``reps`` calls of the
    kernel and of its ``torch.sort`` yardstick timed with CUDA events
    (medians), and ``reps`` more kernel calls traced with
    ``torch.profiler``: the device time per call of each device function
    and memset of the call, and the device events per call (launches and
    memsets).  ``python -m dispersy_tpu_torch.profiling --delivery``
    prints it as one JSON line (``--delivery ROOT ...``: one for each
    checkout, :func:`profile_roots`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dispersy_tpu_torch import kernels

    kernels.build()
    out = {"n_peers": n_peers, "reps": reps, "card": card_name(),
           "device": torch.cuda.get_device_name(0),
           "kernels": str(Path(kernels.__file__).resolve().parent),
           "cases": {}}
    for name, (kernel, plain, yardstick) in delivery_cases(
            n_peers, seed).items():
        if not _same(kernel(), plain()):
            raise AssertionError(f"{name}: the kernel differs from its "
                                 "plain version")
        row = {"kernel_ms": cuda_ms(kernel, reps),
               "sort_ms": cuda_ms(yardstick, reps)}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                kernel()
            torch.cuda.synchronize()
        stages = {}
        events = 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CPU or not ev.self_device_time_total:
                continue
            key = ev.key.replace("(anonymous namespace)::", "")
            key = key.removeprefix("void ").split("(")[0].split("<")[0]
            key = key.split("::")[-1].strip()
            st = stages.setdefault(key, [0.0, 0])
            st[0] += ev.self_device_time_total / 1e3 / reps
            st[1] += ev.count / reps
            events += ev.count
        row["device_events_per_call"] = events / reps
        row["stages_ms"] = {k: v[0] for k, v in stages.items()}
        row["stage_calls"] = {k: v[1] for k, v in stages.items()}
        out["cases"][name] = row
    return out


class Draw:
    """Random inputs made with a numpy seed, on ``dev`` (the u32 and u16
    columns through their signed views)."""

    def __init__(self, seed: int, dev):
        import torch
        self.torch = torch
        self.np = np
        self.rs = np.random.default_rng(seed)
        self.dev = torch.device(dev)

    def from_u32(self, a):
        a = np.asarray(a).astype(np.uint32).view(np.int32)
        return self.torch.from_numpy(a).to(self.dev).view(self.torch.uint32)

    def u32(self, *shape, hi=1 << 32):
        return self.from_u32(self.rs.integers(0, hi, size=shape,
                                              dtype=np.uint64))

    def u16(self, *shape, hi=1 << 16):
        a = self.rs.integers(0, hi, size=shape).astype(np.uint16)
        return self.torch.from_numpy(a.view(np.int16)).to(self.dev).view(
            self.torch.uint16)

    def u8(self, *shape, hi=256):
        a = self.rs.integers(0, hi, size=shape).astype(np.uint8)
        return self.torch.from_numpy(a).to(self.dev)

    def flags(self, p, *shape):
        return self.torch.from_numpy(self.rs.random(shape) < p).to(self.dev)

    def put(self, a):
        """A numpy array on the device (u32 and u16 through their signed
        views)."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            return self.from_u32(a)
        if a.dtype == np.uint16:
            return self.torch.from_numpy(a.view(np.int16)).to(
                self.dev).view(self.torch.uint16)
        return self.torch.from_numpy(a).to(self.dev)


def store_inputs(x, n: int, m: int, b: int):
    """Sorted [n, m] rings with a random fill and an [n, b] batch, keys
    drawn from a small range so that duplicates against the ring and
    inside the batch are common (u32 aux, metas 0-3).  ``x`` draws
    (:class:`Draw`, or ``chip_smoke.Inputs``)."""
    from dispersy_tpu_torch.ops import store as st
    torch = x.torch
    g = x.rs.integers(1, 200, size=(n, m))
    mem = x.rs.integers(0, 6, size=(n, m))
    order = np.lexsort((mem, g), axis=1)
    live = np.arange(m)[None, :] < x.rs.integers(0, m + 1, size=n)[:, None]
    store = st.StoreCols(
        gt=x.from_u32(np.where(live, np.take_along_axis(g, order, 1),
                               EMPTY_U32)),
        member=x.from_u32(np.where(live, np.take_along_axis(mem, order, 1),
                                   EMPTY_U32)),
        meta=torch.where(torch.from_numpy(live).to(x.dev),
                         x.u8(n, m, hi=4), 255).to(torch.uint8),
        payload=x.u32(n, m), aux=x.u32(n, m, hi=3), flags=x.u8(n, m, hi=2))
    batch = st.StoreCols(
        gt=x.u32(n, b, hi=200), member=x.u32(n, b, hi=6),
        meta=x.u8(n, b, hi=4), payload=x.u32(n, b), aux=x.u32(n, b, hi=3),
        flags=x.u8(n, b, hi=2))
    return store, batch


def diet_cols(x, rows: int, width: int, prefix: bool):
    """Record columns with a u16 aux: a sorted ring (``prefix`` False) or
    a staging buffer with a valid prefix of random length."""
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.u32 import cast
    torch = x.torch
    g = x.rs.integers(1, 200, size=(rows, width))
    mem = x.rs.integers(0, 6, size=(rows, width))
    if not prefix:
        order = np.lexsort((mem, g), axis=1)
        g = np.take_along_axis(g, order, 1)
        mem = np.take_along_axis(mem, order, 1)
    live = (np.arange(width)[None, :]
            < x.rs.integers(0, width + 1, size=rows)[:, None])
    tl = torch.from_numpy(live).to(x.dev)
    return st.StoreCols(
        gt=x.from_u32(np.where(live, g, EMPTY_U32)),
        member=x.from_u32(np.where(live, mem, EMPTY_U32)),
        meta=torch.where(tl, x.u8(rows, width, hi=4), 255).to(torch.uint8),
        payload=x.from_u32(np.where(live, x.rs.integers(
            0, 1 << 32, size=(rows, width), dtype=np.uint64), EMPTY_U32)),
        aux=cast(torch.where(tl, x.u32(rows, width, hi=3).view(
            torch.int32), 0).view(torch.uint32), torch.uint16),
        flags=torch.where(tl, x.u8(rows, width, hi=2), 0).to(torch.uint8))


def replay_store(x, n: int, m: int):
    """A ring of dynamic flips, undo records and user records whose keys
    collide with the queries (u32 aux, the legacy ring's)."""
    from dispersy_tpu_torch.ops import store as st
    live = x.rs.random((n, m)) < 0.8
    meta = np.where(live, x.rs.choice(np.array(
        [0, 1, 2, 0xF0, 0xF2, 0xF3, 0xF4], np.uint8), size=(n, m)), 255)
    return st.StoreCols(
        gt=x.from_u32(np.where(live, x.rs.integers(1, 40, size=(n, m)),
                               EMPTY_U32)),
        member=x.from_u32(np.where(live, x.rs.integers(0, 16, size=(n, m)),
                                   EMPTY_U32)),
        meta=x.torch.from_numpy(meta.astype(np.uint8)).to(x.dev),
        payload=x.from_u32(np.where(live, x.rs.integers(0, 16, size=(n, m)),
                                    EMPTY_U32)),
        aux=x.u32(n, m, hi=40), flags=x.u8(n, m, hi=2))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k3_bytes(store, mask, got, history: tuple = ()) -> int:
    """The bytes K3 must move on these inputs: the ring's keys (with a
    history, its metas too) and the mask in full, the same columns of the
    batch under the mask, the other columns of the records that survive
    only, and every output."""
    import torch
    n, m = store.gt.shape
    h = 1 if any(k > 0 for k in history) else 0
    kept = int((got[0].view(torch.int32) != -1).sum())
    other = 6 + store.aux.element_size() - h
    return ((8 + h) * n * m + _nbytes(mask) + (8 + h) * int(mask.sum())
            + other * kept + _nbytes(*got))


def k9_selected(mode: str, flag) -> int:
    """How many entries K9's selecting column picks in ``mode``."""
    if mode == "undo_marked":
        return int(((flag == META_UNDO_OWN) | (flag == META_UNDO_OTHER)).sum())
    if mode == "meta_of":
        return int((flag < 32).sum())
    return int(flag.sum())


def k9_bytes(mode: str, w_cols, q_cols, out) -> int:
    """The bytes K9 must move: the selecting column (flag, meta or valid)
    in full, the key and value columns only at the slots it selects, the
    queries (as given, before any broadcast) and the output."""
    per = 4 * (len(w_cols) - 1)
    return (w_cols[0].numel() + per * k9_selected(mode, w_cols[0])
            + _nbytes(*q_cols) + _nbytes(out))


def match_cases(stc, member, gt, q_meta, valid) -> dict:
    """K9's modes on one ring: ``{name: (mode, w_cols, q_cols, plain,
    replaces)}`` at the intake's shapes (the [N, Q] batch queries against
    the ring; ``undo_hits``'s ring rows against the batch) and at the
    retro pass's (the ring's own rows as the queries)."""
    from dispersy_tpu_torch.ops import intake
    flag = stc.meta == META_DYNAMIC
    flip_w = (flag, stc.payload, stc.gt, stc.aux)
    return {
        "flip": ("flip", flip_w, (q_meta, gt),
                 lambda: intake.flip_best_batch_plain(*flip_w, q_meta, gt),
                 "dispersy_tpu/ops/intake.py:182"),
        "undo_marked": ("undo_marked", (stc.meta, stc.payload, stc.aux),
                        (member, gt),
                        lambda: intake.undo_marked_plain(stc, member, gt),
                        "dispersy_tpu/ops/intake.py:217"),
        "meta_of": ("meta_of", (stc.meta, stc.member, stc.gt), (member, gt),
                    lambda: intake.stored_meta_of_plain(stc, member, gt),
                    "dispersy_tpu/ops/intake.py:293"),
        "undo_hits": ("undo_hits", (valid, member, gt),
                      (stc.member, stc.gt),
                      lambda: intake.undo_hits_store_plain(stc, member, gt,
                                                           valid),
                      "dispersy_tpu/ops/intake.py:244"),
        "flip_retro": ("flip", flip_w, (stc.meta, stc.gt),
                       lambda: intake.flip_best_batch_plain(
                           *flip_w, stc.meta, stc.gt),
                       "dispersy_tpu/ops/intake.py:163"),
        "meta_of_retro": ("meta_of", (stc.meta, stc.member, stc.gt),
                          (stc.payload, stc.aux),
                          lambda: intake.stored_meta_of_plain(
                              stc, stc.payload, stc.aux),
                          "dispersy_tpu/ops/intake.py:293"),
        "undo_marked_retro": ("undo_marked",
                              (stc.meta, stc.payload, stc.aux),
                              (stc.member, stc.gt),
                              lambda: intake.undo_marked_plain(
                                  stc, stc.member, stc.gt),
                              "dispersy_tpu/ops/intake.py:217")}


def k3_yardstick(store, new, mask):
    """One stable ``torch.sort`` of the packed (gt, member) key over the
    [N, M + B] ring ++ masked batch: the ordering step of K3's sort form
    as one PyTorch call.  Returns a function of no argument."""
    import torch

    from dispersy_tpu_torch.u32 import wide
    gt = torch.cat([wide(store.gt), torch.where(mask, wide(new.gt),
                                                EMPTY_U32)], 1)
    mb = torch.cat([wide(store.member), torch.where(mask, wide(new.member),
                                                    EMPTY_U32)], 1)
    key = ((gt << 32) | mb) ^ (-(1 << 63))   # u64 order on int64
    return lambda: torch.sort(key, dim=1, stable=True)


def store_cases(n_peers: int = 1 << 20, seed: int = 0,
                dev="cuda") -> dict:
    """K3's and K9's call shapes in the rounds at ``n_peers`` peers, on
    random inputs made with a numpy seed: ``{name: (kernel, plain,
    yardstick or None, bytes, launches key)}``, the first three functions
    of no argument."""
    import torch

    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import intake
    from dispersy_tpu_torch.ops import store as st

    x = Draw(seed, dev)
    leg, perm = slice_config(n_peers), permissioned_config(n_peers)
    n, m = n_peers, leg.msg_capacity
    b = leg.response_budget + leg.push_inbox
    hist = perm.history
    cases = {}

    def k3(name, store, new, mask, history=()):
        new = st.as_store_dtypes(new, store)
        want = st.store_insert_plain(store, new, mask, history)
        cases[name] = (
            lambda: kernels.store_insert(store, new, mask, history),
            lambda: st.store_insert_plain(store, new, mask, history),
            k3_yardstick(store, new, mask),
            k3_bytes(store, mask, [*want.store, *want[1:]], history),
            "store_insert_history" if history else "store_insert")

    store, batch = store_inputs(x, n, m, b)
    mask = x.flags(0.6, n, b)
    k3("insert_intake", store, batch, mask)
    k3("insert_intake_history", store, batch, mask, hist)
    ring = diet_cols(x, n, m, prefix=False)
    sta = diet_cols(x, n, 8, prefix=True)
    k3("insert_staging_u16", ring, sta, sta.valid)
    blk = n // 4
    ring = diet_cols(x, blk, m, prefix=False)
    sta = diet_cols(x, blk, 8, prefix=True)
    k3("insert_cohort_u16", ring, sta, sta.valid)
    one, one_b = store_inputs(x, n, m, 1)
    k3("insert_one", one, one_b, x.flags(0.02, n, 1))
    k3("insert_one_history", one, one_b, x.flags(0.02, n, 1), hist)

    def k9(name, mode, w_cols, q_cols, plain):
        out = plain()
        cases[name] = (lambda: kernels.store_match(mode, w_cols, q_cols),
                       plain, None, k9_bytes(mode, w_cols, q_cols, out),
                       f"store_match_{mode}")

    stc = replay_store(x, n, m)
    q_meta, gt = x.u8(n, b, hi=4), x.u32(n, b, hi=40)
    for name, (mode, w_cols, q_cols, plain, _) in match_cases(
            stc, x.u32(n, b, hi=16), gt, q_meta, x.flags(0.5, n, b)).items():
        k9(name, mode, w_cols, q_cols, plain)
    bstc = replay_store(x, n, b)
    bflag = bstc.meta == META_DYNAMIC
    k9("flip_batch", "flip", (bflag, bstc.payload, bstc.gt, bstc.aux),
       (q_meta, gt), lambda: intake.flip_best_batch_plain(
           bflag, bstc.payload, bstc.gt, bstc.aux, q_meta, gt))
    # engine._author_linear: one meta for every row, at each row's gt.
    flag = stc.meta == META_DYNAMIC
    q1 = x.from_u32([[1]]).expand(n, 1)
    g1 = x.u32(n, 1, hi=40)
    k9("flip_q1", "flip", (flag, stc.payload, stc.gt, stc.aux), (q1, g1),
       lambda: intake.flip_best_batch_plain(flag, stc.payload, stc.gt,
                                            stc.aux, q1, g1))
    return cases


def probe_inputs(x, n: int, m: int, b: int):
    """A ring of user, identity and proof records with empty slots, keys
    from small ranges and values at and above 2^31, and an [N, B] batch
    that copies ring slots (some with the meta, payload or aux changed)
    or draws fresh keys: planted hits for every K11 mode.  Returns the
    ring and the batch's (member, gt, meta, payload, aux)."""
    from dispersy_tpu_torch.ops import store as st
    rs = x.rs
    gts = np.array([1, 2, 3, 1 << 31, (1 << 31) + 5, 0xFFFFFFFE], np.uint32)
    metas = np.array([0, 1, META_IDENTITY, 0xF7], np.uint8)
    live = rs.random((n, m)) < 0.8
    cols = [np.where(live, rs.choice(gts, size=(n, m)), EMPTY_U32),
            np.where(live, rs.integers(0, 6, size=(n, m)), EMPTY_U32),
            np.where(live, rs.choice(metas, size=(n, m)), 0xFF),
            rs.choice(gts, size=(n, m)), rs.choice(gts, size=(n, m))]
    pick = rs.integers(0, m, size=(n, b))
    rows = np.arange(n)[:, None]
    q = [c[rows, pick] for c in (cols[1], cols[0], cols[2], cols[3],
                                 cols[4])]
    fresh = rs.random((n, b)) < 0.3
    q[0] = np.where(fresh, rs.integers(0, 7, size=(n, b)), q[0])
    q[1] = np.where(fresh, rs.choice(gts, size=(n, b)), q[1])
    for i, pool in ((2, metas), (3, gts), (4, gts)):
        q[i] = np.where(rs.random((n, b)) < 0.2, rs.choice(pool, size=(n, b)),
                        q[i])

    def u8(a):
        return x.torch.from_numpy(a.astype(np.uint8)).to(x.dev)
    stc = st.StoreCols(gt=x.from_u32(cols[0]), member=x.from_u32(cols[1]),
                       meta=u8(cols[2]), payload=x.from_u32(cols[3]),
                       aux=x.from_u32(cols[4]), flags=u8(np.zeros((n, m))))
    return stc, (x.from_u32(q[0]), x.from_u32(q[1]), u8(q[2]),
                 x.from_u32(q[3]), x.from_u32(q[4]))


def k11_cases(stc, member, gt, meta, payload, aux) -> dict:
    """K11's modes on one ring and batch: ``{mode: (s_cols, q_cols, plain,
    bytes, compares a (query, slot) pair, replaces)}``.  The bytes are
    what the function must read -- every query column and the ring's
    selecting columns in full ((member, gt) for ``conflict``, the meta for
    ``identity``, (member, meta) for ``seq_max``), the other columns only
    at the slots that select (a live slot of a queried (member, gt), an
    identity slot, a live slot of a queried (member, meta)) -- and the
    output."""
    import torch

    from dispersy_tpu_torch.ops import intake
    (n, m), b = stc.gt.shape, member.shape[1]
    sm, sg = stc.member.view(torch.int32), stc.gt.view(torch.int32)
    same_mg = torch.zeros((n, m), dtype=torch.bool, device=sm.device)
    same_mt = torch.zeros_like(same_mg)
    for j in range(b):     # the ring slots some query selects
        qm = member.view(torch.int32)[:, j:j + 1]
        same_mg |= (sm == qm) & (sg == gt.view(torch.int32)[:, j:j + 1])
        same_mt |= (sm == qm) & (stc.meta == meta[:, j:j + 1])
    live = sg != -1
    n_mg, n_mt = int((same_mg & live).sum()), int((same_mt & live).sum())
    n_id = int((stc.meta == META_IDENTITY).sum())
    nb = n * b
    return {
        "conflict": (
            (stc.gt, stc.member, stc.meta, stc.payload, stc.aux),
            (member, gt, meta, payload, aux),
            lambda: intake.conflict_plain(stc, member, gt, meta, payload,
                                          aux),
            8 * n * m + 9 * n_mg + 17 * nb + nb, 5,
            "dispersy_tpu/ops/intake.py:104"),
        "identity": (
            (stc.meta, stc.member), (member,),
            lambda: intake.identity_stored_plain(stc, member),
            n * m + 4 * n_id + 4 * nb + nb, 2,
            "dispersy_tpu/ops/intake.py:269"),
        "seq_max": (
            (stc.gt, stc.member, stc.meta, stc.aux), (member, meta),
            lambda: intake.seq_stored_max_plain(stc, member, meta),
            5 * n * m + 8 * n_mt + 5 * nb + 4 * nb, 3,
            "dispersy_tpu/ops/intake.py:325")}


def probe_cases(n_peers: int = 1 << 20, seed: int = 0,
                dev="cuda") -> dict:
    """K11's, K2's and K6's call shapes in the rounds at ``n_peers``
    peers, on random inputs made with a numpy seed, in the form of
    :func:`store_cases`: K11 per mode at the hardened intake ([N, 24]
    against [N, 48]); K2's legacy claim build [N, 48] and its serve query
    on a slot of the [N, 4, W] request inbox, the diet freshness query
    [N, 24] (one salt a row), the diet serve [N/4, 48] on a cohort's
    strided block of the digest and the digest rebuild [N/4, 48]; K6 on
    the landed [N, 24] arrivals.  The Bloom bytes: the W words of each
    row read (or written) once, the hashes and the mask (the build: the
    masked hashes only), the salts of a per-row salt, the answers."""
    import torch

    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import bloom
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.u32 import narrow

    x = Draw(seed, dev)
    leg, diet = slice_config(n_peers), bench_config(n_peers)
    n, m = n_peers, leg.msg_capacity
    b = leg.response_budget + leg.push_inbox
    cases = {}
    stc, q = probe_inputs(x, n, m, b)
    for mode, (s_cols, q_cols, plain, moved, _, _) in k11_cases(
            stc, *q).items():
        cases[f"probe_{mode}"] = (
            lambda mode=mode, s_cols=s_cols, q_cols=q_cols:
            kernels.store_probe(mode, s_cols, q_cols),
            plain, None, moved, f"store_probe_{mode}")

    bits, k, w = leg.bloom_bits, leg.bloom_hashes, leg.bloom_words

    def build(name, key, h, mask, salt, digest=None):
        n_set = int(mask.sum())
        moved = _nbytes(mask) + 4 * n_set + 4 * h.shape[0] * w * (
            1 if digest is None else 2)
        if salt is not None and salt.dim():
            moved += _nbytes(salt)
        if digest is None:
            cases[name] = (
                lambda: kernels.bloom_build(h, mask, bits, k, salt),
                lambda: bloom.bloom_build_plain(h, mask, bits, k, salt),
                None, moved, key)
        else:
            cases[name] = (
                lambda: kernels.digest_update(digest, h, mask, bits, k, salt),
                lambda: bloom.digest_update_plain(digest, h, mask, bits, k,
                                                  salt), None, moved, key)

    def query(name, words, h, salt):
        moved = 4 * words.shape[0] * w + _nbytes(h) + h.numel()
        if salt is not None and salt.dim():
            moved += _nbytes(salt)
        cases[name] = (lambda: kernels.bloom_query(words, h, bits, k, salt),
                       lambda: bloom.bloom_query_plain(words, h, bits, k,
                                                       salt),
                       None, moved, "bloom_query")

    def mixed(h, rows, cols):     # half the items built in, half fresh
        return torch.where(x.flags(0.5, rows, cols), h.view(torch.int32),
                           x.u32(rows, cols).view(torch.int32)).view(
                               torch.uint32)

    salt = narrow(torch.tensor(17, device=x.dev))
    h = x.u32(n, m)
    build("bloom_build", "bloom_build", h, x.flags(0.7, n, m), salt)
    built = bloom.bloom_build_plain(h, x.flags(0.7, n, m), bits, k, salt)
    inbox = torch.stack([built, x.u32(n, w), built, built], dim=1)
    query("bloom_query", inbox[:, 0], mixed(h, n, m), salt)
    bd = diet.response_budget + diet.push_inbox
    coh, blk = diet.store.cohorts, n // diet.store.cohorts
    dig = narrow(x.u32(n, w).view(torch.int32).long()
                 & x.u32(n, w).view(torch.int32).long())
    ep = x.u32(n, hi=4)
    hd = x.u32(n, bd)
    build("digest_update", "digest_update", hd, x.flags(0.4, n, bd), ep,
          digest=dig)
    query("bloom_query_diet_fresh", dig, mixed(hd, n, bd), ep)
    salt = narrow(torch.tensor(0xFFFFFFFF, device=x.dev))
    rec = x.u32(blk, m)
    query("bloom_query_diet_serve", st.cohort_take(dig, 1, coh), rec, salt)
    build("bloom_build_diet_rebuild", "bloom_build", rec,
          x.flags(0.7, blk, m), salt)
    return cases


def intake_unsorted_rows(state) -> int:
    """Store rows whose raw (gt, member) keys are not non-decreasing over
    all M slots: the rows that K5's ``in_store`` compares slot by slot
    instead of searching (csrc/intake.cu; none on the engine's rows)."""
    import torch
    g = state.store_gt.view(torch.int32).long() & 0xFFFFFFFF
    mb = state.store_member.view(torch.int32).long() & 0xFFFFFFFF
    down = (g[:, 1:] < g[:, :-1]) | ((g[:, 1:] == g[:, :-1])
                                     & (mb[:, 1:] < mb[:, :-1]))
    return int(down.any(1).sum())


# K4's and K5's corner inputs as numpy arrays: the CPU tests hand them to
# both packages, chip_smoke.py moves them to the card.
COMPACT_FILLS = {np.dtype(np.uint32): 0xFFFFFFFF, np.dtype(np.uint16): 0,
                 np.dtype(np.uint8): 0xFF, np.dtype(np.bool_): False}
COMPACT_DTYPES = (np.uint32, np.uint16, np.uint8, np.bool_)
HIGH_KEYS = np.array([0, 1, 2, 1 << 31, (1 << 31) + 1, 0xFFFFFFFE],
                     np.uint64)


def compact_arrays(rs, n: int, w: int, width: int, p: float = 0.5,
                   dtypes=COMPACT_DTYPES, slots: str = "rank",
                   negative=(-1,)):
    """A [n, w] int32 slot map and ``[(column, fill), ...]`` for
    ``rank_compact_many``.  ``slots``: ``"rank"`` keeps each entry with
    probability ``p`` at its rank among the kept, the others and the
    overflow at ``width`` (the engine's maps); ``"spilled"`` sends every
    entry to ``width``; ``"none"`` every entry to -1; ``"negative"`` a
    rank map with a fifth of its entries drawn from ``negative``."""
    keep = rs.random((n, w)) < p
    rank = np.cumsum(keep, axis=1) - 1
    slot = np.where(keep & (rank < width), rank, width)
    if slots == "spilled":
        slot = np.full((n, w), width)
    elif slots == "none":
        slot = np.full((n, w), -1)
    elif slots == "negative":
        slot = np.where(rs.random((n, w)) < 0.2,
                        rs.choice(np.asarray(negative), size=(n, w)), slot)
    cols = []
    for dt in map(np.dtype, dtypes):
        if dt == np.bool_:
            c = rs.random((n, w)) < 0.5
        else:
            c = rs.integers(0, np.iinfo(dt).max + 1, size=(n, w),
                            dtype=np.uint64).astype(dt)
        cols.append((c, COMPACT_FILLS[dt]))
    return slot.astype(np.int32), cols


# The column patterns of K4's call sites (csrc/compact.cu specialises
# them): the outbox and the recovery pass with a u32 or a u16 aux, the
# forward buffer with either aux, the timeline's auth table.
COMPACT_PATTERNS = {
    "outbox": (np.uint32, np.uint32, np.uint8, np.uint32, np.uint32,
               np.bool_),
    "outbox_u16": (np.uint32, np.uint32, np.uint8, np.uint32, np.uint16,
                   np.bool_),
    "forward": (np.uint32, np.uint32, np.uint8, np.uint32, np.uint32),
    "forward_u16": (np.uint32, np.uint32, np.uint8, np.uint32, np.uint16),
    "auth": (np.uint32, np.uint32, np.uint32, np.bool_, np.uint32)}


def compact_corners(negative=(-1,)) -> dict:
    """K4's corners, ``{name: compact_arrays keywords with w and width}``:
    widths 1, 8, 48 and 256 by W = 1, 31, 33 and 48 (widths above W
    leave slots no entry reaches) with one column of each size in the
    outbox's u16 pattern; each call-site pattern at its shape; every
    entry spilled (slot == width); no live entry (every slot -1); slots
    drawn from ``negative`` among the ranks; every output slot filled;
    k = 1 and k = 8 (a mix no call site uses)."""
    out = {f"width{width}_w{w}": dict(w=w, width=width,
                                      dtypes=COMPACT_PATTERNS["outbox_u16"])
           for width in (1, 8, 48, 256) for w in (1, 31, 33, 48)}
    out.update({f"pattern_{k}": dict(w=24 if k.startswith("forward") else
                                     48, width=4 if k.startswith("forward")
                                     else 8, dtypes=v)
                for k, v in COMPACT_PATTERNS.items()})
    out.update({
        "all_spilled": dict(w=48, width=8, slots="spilled"),
        "no_live": dict(w=48, width=8, slots="none"),
        "negative": dict(w=48, width=8, slots="negative",
                         negative=negative),
        "negative_outbox": dict(w=48, width=8, slots="negative",
                                negative=negative,
                                dtypes=COMPACT_PATTERNS["outbox"]),
        "full": dict(w=48, width=8, p=1.0),
        "full_recovery": dict(w=48, width=48, p=1.0,
                              dtypes=COMPACT_PATTERNS["outbox"]),
        "k1": dict(w=48, width=8, dtypes=(np.uint8,)),
        "k8": dict(w=33, width=8, dtypes=(np.uint32, np.uint8, np.uint16,
                                          np.bool_, np.uint32, np.uint32,
                                          np.uint8, np.uint16))})
    return out


# K5's corners, ``{name: intake_arrays keywords with m and b}``: B = 1,
# 24, 32 and 40 by M = 1, 45 and 48 with a third of the rows shuffled
# among sorted ones; keys at 0, 2^31 and 0xFFFFFFFE; all-EMPTY rings;
# keys repeated in ring and batch; keys that collide under the dedup's
# hash (EMPTY-gt entries against EMPTY slots in every case).
INTAKE_CORNERS = {f"b{b}_m{m}": dict(b=b, m=m, unsorted=0.3)
                  for b in (1, 24, 32, 40) for m in (1, 45, 48)}
INTAKE_CORNERS.update({
    "high_keys": dict(b=24, m=48, high=True, unsorted=0.3),
    "high_keys_b40_m45": dict(b=40, m=45, high=True, unsorted=0.3),
    "empty_rings": dict(b=24, m=48, empty_rings=True),
    "repeats": dict(b=24, m=48, keys=3, members=2, unsorted=0.3),
    "hash_collisions": dict(b=24, m=48, collide=True),
    "hash_collisions_b40": dict(b=40, m=45, collide=True, unsorted=0.3)})


# csrc/intake.cu's dedup hash, gt * HASH_GT ^ member * HASH_MEMBER (mod
# 2^32): :func:`intake_arrays` builds keys that collide under it.
INTAKE_HASH_GT, INTAKE_HASH_MEMBER = 0x9E3779B1, 0x85EBCA6B


def colliding_keys(rs, count: int) -> tuple:
    """``count`` distinct (gt, member) keys with one dedup hash: random
    gts, each member solved for the first key's hash."""
    gt = rs.integers(0, 1 << 32, size=count, dtype=np.uint64)
    inv = pow(INTAKE_HASH_MEMBER, -1, 1 << 32)
    h = (int(gt[0]) * INTAKE_HASH_GT ^ 5 * INTAKE_HASH_MEMBER) & 0xFFFFFFFF
    member = np.array([((h ^ (int(g) * INTAKE_HASH_GT & 0xFFFFFFFF)) * inv)
                       & 0xFFFFFFFF for g in gt], np.uint64)
    return gt, member


def intake_arrays(rs, n: int, m: int, b: int, keys: int = 30,
                  members: int = 3, unsorted: float = 0.0,
                  high: bool = False, empty_rings: bool = False,
                  collide: bool = False):
    """K5's inputs ``(store_gt, store_member, member, gt, ok)``: [n, m]
    rings sorted by (gt, member) with a random fill and EMPTY slots last,
    and an [n, b] batch whose keys come from the same small ranges, so
    hits in the ring and repeats in the batch are common; a tenth of the
    entries have an EMPTY gt, half of those an EMPTY member too.
    ``high`` draws every key from 0, 1, 2, 2^31, 2^31 + 1 and
    0xFFFFFFFE; ``unsorted`` is the share of rows whose slots are
    shuffled (K5's fallback); ``empty_rings`` leaves every slot EMPTY;
    ``collide`` draws every key from four that share one dedup hash
    (:func:`colliding_keys`)."""
    pool = colliding_keys(rs, 4) if collide else None

    def draw(shape):
        if collide:
            pick = rs.integers(0, 4, size=shape)
            return pool[0][pick], pool[1][pick]
        if high:
            return (rs.choice(HIGH_KEYS, size=shape),
                    rs.choice(HIGH_KEYS, size=shape))
        return (rs.integers(1, keys, size=shape),
                rs.integers(0, members, size=shape))
    g, mem = draw((n, m))
    order = np.lexsort((mem, g), axis=1)
    g, mem = (np.take_along_axis(a, order, 1) for a in (g, mem))
    fill = np.zeros(n, int) if empty_rings else rs.integers(0, m + 1, size=n)
    live = np.arange(m)[None, :] < fill[:, None]
    g, mem = (np.where(live, a, EMPTY_U32) for a in (g, mem))
    shuffle = (rs.random(n) < unsorted)[:, None]
    perm = np.argsort(rs.random((n, m)), axis=1)
    g, mem = (np.where(shuffle, np.take_along_axis(a, perm, 1), a)
              for a in (g, mem))
    qg, qm = draw((n, b))
    e = rs.random((n, b))
    qg = np.where(e < 0.1, EMPTY_U32, qg)
    qm = np.where(e < 0.05, EMPTY_U32, qm)
    ok = rs.random((n, b)) < 0.7
    return (*(np.asarray(a).astype(np.uint32) for a in (g, mem, qm, qg)),
            ok)


# What K10 gets in the 1M permissioned round: the rings' rows by live
# count (0..48 live slots; summed over the retro pass's calls) and the
# share of live slots killed.  Read by :func:`remove_shares` (8 rounds
# of chip_smoke.py's permissioned main path: the retro pass ran three
# times, three calls each, on rings 70.6%, 90.5% and 97.7% live, and no
# call killed a slot, live or dead) on an NVIDIA H100 80GB HBM3;
# :func:`remove_arrays` draws K10's timed input with it.
REMOVE_SHARES = {
    "live_rows": (705, 12, 855, 267, 2040, 444, 3153, 1245, 7626, 2478,
                  11367, 5199, 20937, 8757, 28314, 15606, 43545, 22683,
                  56619, 34722, 77835, 46137, 93129, 62151, 118905, 76704,
                  133992, 96735, 157965, 113526, 175317, 131211, 193467,
                  144606, 204675, 160737, 216798, 169557, 221289, 177453,
                  226248, 182466, 225603, 184776, 222933, 182292, 218757,
                  181977, 4773369),
    "killed": 0.0}
# K10's corners as ``{name: remove_arrays keywords with m}``: M = 1, 33
# and 48 with u32 and u16 aux and half the slots killed, nothing killed,
# every slot killed, only dead slots killed, every slot live, dead slots
# scattered through the rows, no live slot.
REMOVE_CORNERS = {f"m{m}_{'u16' if aux16 else 'u32'}": dict(
                      m=m, aux16=aux16, kill="half")
                  for m in (1, 33, 48) for aux16 in (False, True)}
REMOVE_CORNERS.update({
    "kill_none": dict(m=48, kill="none"),
    "kill_all": dict(m=48, kill="all"),
    "kill_dead_only": dict(m=48, kill="dead"),
    "full_rows": dict(m=48, fill="full", kill="half"),
    "holes": dict(m=48, fill="holes", aux16=True, kill="half"),
    "holes_m33": dict(m=33, fill="holes", kill="half"),
    "empty_rows": dict(m=48, fill="empty", kill="half")})


def remove_arrays(rs, n: int, m: int, kill: str = "round",
                  fill: str = "round", aux16: bool = False):
    """K10's inputs as numpy arrays: the six [n, m] store columns (gt,
    member, meta, payload, aux -- u16 with ``aux16`` -- and flags) and a
    bool kill mask.  ``fill``: ``"round"`` rings sorted by (gt, member)
    with each row's live slots first, as many as :data:`REMOVE_SHARES`
    gives the round's rows (scaled to ``m``), ``"full"`` every slot live,
    ``"holes"`` dead slots scattered through the rows, ``"empty"`` none
    live; a dead slot holds the empty record's gt, member and meta and
    random payload, aux and flags.  ``kill``: ``"round"`` each live slot
    with the round's share, ``"half"`` each slot with probability 1/2,
    ``"none"``, ``"all"``, or ``"dead"`` only dead slots."""
    key = np.sort(rs.integers(1, 200, size=(n, m)) * 6
                  + rs.integers(0, 6, size=(n, m)), axis=1)
    g, mem = key // 6, key % 6
    rows = np.asarray(REMOVE_SHARES["live_rows"])
    top = len(rows) - 1
    live = {"round": np.arange(m)[None, :] < (rs.choice(
                top + 1, size=n, p=rows / rows.sum()) * m // top)[:, None],
            "full": np.ones((n, m), bool),
            "holes": rs.random((n, m)) < 0.6,
            "empty": np.zeros((n, m), bool)}[fill]
    k = {"round": live & (rs.random((n, m)) < REMOVE_SHARES["killed"]),
         "half": rs.random((n, m)) < 0.5, "none": np.zeros((n, m), bool),
         "all": np.ones((n, m), bool), "dead": ~live}[kill]
    aux_dt = np.uint16 if aux16 else np.uint32
    cols = [np.where(live, g, EMPTY_U32).astype(np.uint32),
            np.where(live, mem, EMPTY_U32).astype(np.uint32),
            np.where(live, rs.integers(0, 4, size=(n, m)), 0xFF).astype(
                np.uint8),
            rs.integers(0, 1 << 32, size=(n, m), dtype=np.uint64).astype(
                np.uint32),
            rs.integers(0, np.iinfo(aux_dt).max + 1, size=(n, m)).astype(
                aux_dt),
            rs.integers(0, 2, size=(n, m)).astype(np.uint8)]
    return cols, k


def remove_inputs(x, n: int, m: int):
    """K10's timed input on ``x``'s device (:class:`Draw`): the [n, m]
    ring and the kill mask of :func:`remove_arrays`, drawn with the
    round's shares."""
    from dispersy_tpu_torch.ops import store as st
    cols, kill = remove_arrays(x.rs, n, m)
    return st.StoreCols(*map(x.put, cols)), x.put(kill)


def remove_shares(n_peers: int = 1 << 20, rounds: int = 8, seed: int = 0,
                  dev="cuda") -> dict:
    """What K10 gets in ``rounds`` rounds of the permissioned round of
    :func:`permissioned_config` driven by :func:`permissioned_schedule`
    (no destroy), as ``chip_smoke.py``'s permissioned main path drives
    it: for each ``store_remove`` call of the retro pass (its grant,
    permission and undo walks, ``call`` 1-3) the ring's shape, its rows
    by live count, the kills on live slots by row (rows by kill count)
    and by slot, and the kills on dead slots.  ``python -m
    dispersy_tpu_torch.profiling --remove-shares`` prints it as one JSON
    line."""
    import torch

    from dispersy_tpu_torch import engine
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.state import init_state

    cfg = permissioned_config(n_peers)
    creates = permissioned_schedule(n_peers, destroy=False)
    calls = []
    saved = st.store_remove

    def counted(stc, kill):
        n, m = stc.gt.shape
        live = stc.gt.view(torch.int32) != -1
        k = kill & live
        calls.append({
            "round": rnd, "call": len(calls) % 3 + 1, "rows": n, "slots": m,
            "live_rows": torch.bincount(live.sum(1), minlength=m + 1).tolist(),
            "kill_rows": torch.bincount(k.sum(1), minlength=m + 1).tolist(),
            "kill_slots": k.sum(0).tolist(),
            "kill_dead": int((kill & ~live).sum())})
        return saved(stc, kill)
    try:
        st.store_remove = counted
        state = engine.seed_overlay(init_state(cfg, seed, device=dev),
                                    cfg, 8)
        for rnd in range(rounds):
            state = engine.step(run_creates(state, cfg, creates, rnd), cfg)
    finally:
        st.store_remove = saved
    return {"n_peers": n_peers, "rounds": rounds, "calls": calls}


def compact_cases(n_peers: int = 1 << 20, seed: int = 0,
                  dev="cuda") -> dict:
    """K4's, K10's and K5's call shapes in the rounds at ``n_peers``
    peers, on random inputs made with a numpy seed, in the form of
    :func:`store_cases`: K4 at the legacy outbox ([N, 48] -> 8, six
    columns), the forward buffer ([N, 24] -> 4, five), the diet serve
    ([N/4, 48] -> 8, u16 aux) and the recovery pass ([N, 48] -> 48,
    six); K10 on the round's [N, 48] rings and kill masks
    (:func:`remove_inputs`; its bytes: the gt column and the mask, the
    survivors' other five columns, every output); K5 at the legacy intake ([N, 24] against [N, 48]) on sorted
    rings and on the same rings reversed (every row off the search path
    but the 1 in 49 with no live slot), and ``dup_earlier`` alone at the
    diet's [N, 24].  K4's bytes: the slot map, the kept entries of each
    column, the outputs; K5's: every operand and the answers."""
    import torch

    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import intake
    from dispersy_tpu_torch.ops import store as st

    x = Draw(seed, dev)
    leg, diet = slice_config(n_peers), bench_config(n_peers)
    n, m = n_peers, leg.msg_capacity
    b, rb = leg.response_budget + leg.push_inbox, leg.response_budget
    cases = {}

    def slots(keep, width):
        rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
        return torch.where(keep & (rank < width), rank,
                           width).to(torch.int32)

    def k4(name, cols, slot, width):
        kept = int(((slot >= 0) & (slot < width)).sum())
        out = st.rank_compact_many_plain(cols, slot, width)
        moved = (_nbytes(slot) + _nbytes(*out)
                 + kept * sum(c.element_size() for c, _ in cols))
        cases[name] = (
            lambda: kernels.rank_compact_many(cols, slot, width),
            lambda: st.rank_compact_many_plain(cols, slot, width), None,
            moved, "rank_compact_many")

    def ring_cols(r, last):
        return [(r.gt, EMPTY_U32), (r.member, EMPTY_U32), (r.meta, 0xFF),
                (r.payload, EMPTY_U32), (r.aux, 0), last]

    store, batch = store_inputs(x, n, m, b)
    missing = x.flags(0.3, n, m)
    k4("compact_outbox", ring_cols(store, (missing, False)),
       slots(missing, rb), rb)
    k4("compact_forward", [(c, st.empty_of(c.dtype)) for c in batch[:5]],
       slots(x.flags(0.5, n, b), leg.forward_buffer), leg.forward_buffer)
    blk = n // diet.store.cohorts
    ring = diet_cols(x, blk, m, prefix=False)
    missing = x.flags(0.3, blk, m)
    k4("compact_diet_serve", ring_cols(ring, (missing, False)),
       slots(missing, rb), rb)
    keep = (store.gt.view(torch.int32) != -1) & x.flags(0.95, n, m)
    k4("compact_recovery", ring_cols(store, (store.flags, 0)),
       slots(keep, m), m)

    ring, kill = remove_inputs(x, n, m)
    want = st.store_remove_plain(ring, kill)
    kept = int((want.store.gt.view(torch.int32) != -1).sum())
    cases["store_remove"] = (
        lambda: kernels.store_remove(ring, kill),
        lambda: st.store_remove_plain(ring, kill), None,
        _nbytes(ring.gt, kill) + 14 * kept
        + _nbytes(*want.store, want.n_removed), "store_remove")

    ok = x.flags(0.8, n, b)

    def k5(name, sg, sm):
        args = (sg, sm, batch.member, batch.gt, ok)
        cases[name] = (
            lambda: kernels.intake_checks(*args),
            lambda: (intake.in_store_plain(*args[:4]),
                     intake.dup_earlier_plain(*args[2:])), None,
            _nbytes(*args) + 2 * n * b, "intake_checks")

    def rev(c):
        return c.view(torch.int32).flip(1).contiguous().view(torch.uint32)
    k5("intake_sorted", store.gt, store.member)
    k5("intake_unsorted", rev(store.gt), rev(store.member))
    member, gt = x.u32(n, b, hi=4), x.u32(n, b, hi=12)
    dok = x.flags(0.8, n, b)
    cases["dup_earlier_diet"] = (
        lambda: kernels.dup_earlier(member, gt, dok),
        lambda: intake.dup_earlier_plain(member, gt, dok), None,
        _nbytes(member, gt, dok) + n * b, "dup_earlier")
    return cases


def grant_table(x, n: int, a: int):
    """Random [N, A] grant tables: members and global times from small
    ranges (so queries hit, and grant and revoke rows tie), nibble masks
    over the three metas, empty slots.  ``x`` draws (:class:`Draw`)."""
    from dispersy_tpu_torch.ops import timeline as tl
    live = x.rs.random((n, a)) < 0.7
    member = np.where(live, x.rs.integers(0, 64, size=(n, a)), EMPTY_U32)
    return tl.AuthTable(member=x.from_u32(member), mask=x.u32(n, a, hi=1 << 12),
                        gt=x.u32(n, a, hi=40), rev=x.flags(0.3, n, a),
                        issuer=x.from_u32(np.where(live, x.rs.integers(
                            0, 64, size=(n, a)), EMPTY_U32)))


def timeline_queries(x, n: int, q: int, u8: bool = True, empty=None):
    """[N, Q] check queries: members and global times that hit the
    :func:`grant_table` rows, metas 0-2 among control metas (out of the
    nibble range; u8, or u32 with the 0xFFFF not-found sentinel); a share
    ``empty`` of them free slots (member and gt EMPTY_U32), by default
    the round's at this width (:data:`TIMELINE_EMPTY_SHARE`, else 0)."""
    if empty is None:
        empty = TIMELINE_EMPTY_SHARE.get(q, 0.0)
    metas = [0, 1, 2, 0xF0, 0xF5] if u8 else [0, 1, 2, 0xF3, 0xFFFF]
    meta = x.rs.choice(np.array(metas, np.uint32), size=(n, q))
    meta = (x.torch.from_numpy(meta.astype(np.uint8)).to(x.dev) if u8
            else x.from_u32(meta))
    free = x.rs.random((n, q)) < empty
    member = np.where(free, EMPTY_U32, x.rs.integers(0, 64, size=(n, q)))
    gt = np.where(free, EMPTY_U32, x.rs.integers(0, 48, size=(n, q)))
    return x.from_u32(member), meta, x.from_u32(gt)


# The share of K8's queries that are free slots (member EMPTY_U32) at
# each query width of the 1M permissioned round: the intake's batch
# (Q = 24), the retro pass's store rows (48), the author gate (1).  Read
# by :func:`timeline_query_shares` (8 rounds of chip_smoke.py's
# permissioned main path) on an NVIDIA H100 80GB HBM3; the timed K8 cases
# draw their queries with it.
TIMELINE_EMPTY_SHARE = {24: 0.20836218694845834, 48: 0.13767162296507093,
                        1: 0.0}


def timeline_query_shares(n_peers: int = 1 << 20, rounds: int = 8,
                          seed: int = 0, dev="cuda") -> dict:
    """The queries K8 gets in ``rounds`` rounds of the permissioned round
    of :func:`permissioned_config` driven by :func:`permissioned_schedule`
    (no destroy), as ``chip_smoke.py``'s permissioned main path drives
    it: for each entry and query width, the launches, the queries, the
    share of them free slots (member EMPTY_U32), the share of the others
    with a gt of 2^31 or more, and the share of table rows holding such a
    gt (off K8's 32-bit fast path).  ``python -m
    dispersy_tpu_torch.profiling --timeline-shares`` prints it as one JSON
    line."""
    import torch

    from dispersy_tpu_torch import engine
    from dispersy_tpu_torch.ops import timeline as tl
    from dispersy_tpu_torch.state import init_state

    cfg = permissioned_config(n_peers)
    creates = permissioned_schedule(n_peers, destroy=False)
    seen: dict = {}

    def counted(name, fn):
        def call(tab, member, key, gt, *args, **kw):
            m, g = torch.broadcast_tensors(member.view(torch.int32),
                                           gt.view(torch.int32))
            free = m == -1
            row = seen.setdefault(f"{name} Q={m.shape[1]}", [0, 0, 0, 0,
                                                              0, 0])
            row[0] += 1
            row[1] += m.numel()
            row[2] += int(free.sum())
            row[3] += int((~free & (g < 0)).sum())
            row[4] += tab.gt.shape[0]
            row[5] += int((tab.gt.view(torch.int32) < 0).any(1).sum())
            return fn(tab, member, key, gt, *args, **kw)
        return call
    saved = {k: getattr(tl, k) for k in ("check", "check_many",
                                         "check_grant", "check_grant_rev")}
    try:
        for k, fn in saved.items():
            setattr(tl, k, counted(k, fn))
        state = engine.seed_overlay(init_state(cfg, seed, device=dev),
                                    cfg, 8)
        for rnd in range(rounds):
            state = engine.step(run_creates(state, cfg, creates, rnd), cfg)
    finally:
        for k, fn in saved.items():
            setattr(tl, k, fn)
    return {"n_peers": n_peers, "rounds": rounds, "calls": {
                k: {"launches": c, "queries": nq, "empty_share": e / nq,
                    "high_gt_share": h / max(nq - e, 1),
                    "high_table_row_share": hr / rows}
                for k, (c, nq, e, h, rows, hr) in sorted(seen.items())}}


def timeline_stage_cases(n_peers: int = 1 << 20, seed: int = 0,
                         dev="cuda") -> dict:
    """K8's and K7's call shapes in the rounds at ``n_peers`` peers, on
    random inputs made with a numpy seed, in the form of
    :func:`store_cases`: K8 ``check`` at the intake's [N, 24] (u8 metas, a
    founder column), the retro pass's [N, 48] and the author gate's
    [N, 1] (u32 metas); ``check_grant`` at [N, 24] and [N, 48]; the
    intake's fused launches -- ``check_many`` of its three (meta, perm)
    pairs, ``check_grant_rev`` at [N, 24] and [N, 48], and the two
    together; K7 at the diet round's [N, 24] batch (u32 aux) into its
    [N, 8] staging buffer (u16 aux).  K8's bytes:
    the table's four columns (13 B a slot), the queries, the founder
    column and the verdicts; K7's: the mask, the staging row, the
    columns of the arrivals that land, every output."""
    import torch

    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.config import (PERM_AUTHORIZE, PERM_PERMIT,
                                           PERM_REVOKE, PERM_UNDO)
    from dispersy_tpu_torch.ops import store as st
    from dispersy_tpu_torch.ops import timeline as tl

    x = Draw(seed, dev)
    perm, diet = permissioned_config(n_peers), bench_config(n_peers)
    n, a, m, nm = n_peers, perm.k_authorized, perm.msg_capacity, perm.n_meta
    b = perm.response_budget + perm.push_inbox
    tab = grant_table(x, n, a)
    t_bytes = 13 * n * a
    founder = x.u32(n, 1, hi=64)
    cases = {}

    def check(name, q, u8):
        member, meta, gt = timeline_queries(x, n, q, u8)
        args = (tab, member, meta, gt, founder, PERM_PERMIT)
        cases[name] = (lambda: kernels.timeline_check(*args),
                       lambda: tl.check_plain(*args), None,
                       t_bytes + _nbytes(member, meta, gt, founder) + n * q,
                       "timeline_check")
    check("check_intake", b, True)
    check("check_retro", m, True)
    check("check_gate", 1, False)

    def grant_mask(q):
        return x.u32(n, q, hi=1 << 12)
    for name, q in (("check_grant_intake", b), ("check_grant_retro", m)):
        member, _, gt = timeline_queries(x, n, q)
        args = (tab, member, grant_mask(q), gt, nm, PERM_AUTHORIZE)
        cases[name] = (lambda args=args: kernels.timeline_check_grant(*args),
                       lambda args=args: tl.check_grant_plain(*args), None,
                       t_bytes + _nbytes(*args[1:4]) + n * q,
                       "timeline_check_grant")

    # The intake's three checks: undo (u32 stored metas with the
    # not-found sentinel), flip (u32 payloads naming a meta), permit (u8).
    member, meta8, gt = timeline_queries(x, n, b)
    _, undo_meta, _ = timeline_queries(x, n, b, u8=False)
    flip = x.u32(n, b, hi=4)
    pairs = ((undo_meta, PERM_UNDO), (flip, PERM_AUTHORIZE),
             (meta8, PERM_PERMIT))

    def many():
        return kernels.timeline_check_many(tab, member, pairs, gt, founder)

    def many_plain():
        return tuple(tl.check_plain(tab, member, k, gt, founder, p)
                     for k, p in pairs)
    cases["check_many_intake"] = (
        many, many_plain, None,
        t_bytes + _nbytes(member, gt, founder, *(k for k, _ in pairs))
        + 3 * n * b, "timeline_check_many")

    def grant_rev(q):
        g_member, _, g_gt = timeline_queries(x, n, q)
        mask, is_rev = grant_mask(q), x.flags(0.5, n, q)
        args = (tab, g_member, mask, g_gt)

        def kernel():
            return kernels.timeline_check_grant_rev(*args, is_rev, nm)

        def plain():
            rev = tl.check_grant_plain(*args, nm, PERM_REVOKE)
            auth = tl.check_grant_plain(*args, nm, PERM_AUTHORIZE)
            return torch.where(is_rev, rev, auth)
        return (kernel, plain, None,
                t_bytes + _nbytes(*args[1:], is_rev) + n * q,
                "timeline_check_grant_rev")
    cases["check_grant_rev_intake"] = grant_rev(b)
    cases["check_grant_rev_retro"] = grant_rev(m)
    g_kernel, g_plain, _, g_moved, _ = cases["check_grant_rev_intake"]
    cases["intake_fused"] = (
        lambda: (many(), g_kernel()), lambda: (many_plain(), g_plain()), None,
        cases["check_many_intake"][3] + g_moved - t_bytes,
        "timeline_check_many")

    s, bw = diet.store.staging, diet.response_budget + diet.push_inbox
    staging = diet_cols(x, n, s, prefix=True)
    batch = st.StoreCols(
        gt=x.u32(n, bw, hi=200), member=x.u32(n, bw, hi=6),
        meta=x.u8(n, bw, hi=4), payload=x.u32(n, bw), aux=x.u32(n, bw),
        flags=x.u8(n, bw, hi=2))
    new_mask = x.flags(0.25, n, bw)
    cast_b = st.as_store_dtypes(batch, staging)
    want = st.store_stage_plain(staging, cast_b, new_mask)
    landed = int(want.landed.sum())
    slot_b = sum(c.element_size() for c in staging)
    cases["stage_diet"] = (
        lambda: kernels.store_stage(staging, batch, new_mask),
        lambda: st.store_stage_plain(staging, cast_b, new_mask), None,
        _nbytes(new_mask) + n * s * slot_b
        + landed * sum(c.element_size() for c in batch)
        + _nbytes(*want.staging, want.landed, want.n_dropped),
        "store_stage")
    return cases


def profile_store(n_peers: int = 1 << 20, reps: int = 20,
                  seed: int = 0, cases: str = "store") -> dict:
    """Each of :func:`store_cases` (``cases="store"``: K3, K9), of
    :func:`probe_cases` (``"probe"``: K11, K2, K6), of
    :func:`compact_cases` (``"compact"``: K4, K10, K5) or of
    :func:`timeline_stage_cases` (``"timeline_stage"``: K8, K7) on the
    card: the kernel
    held bit for bit against its plain version, then the kernel (``reps``
    launches), K3's ``torch.sort`` yardstick (``reps``) and the plain
    version (5) timed with CUDA events (medians), beside the bytes bound
    at 3.35 TB/s.  ``python -m dispersy_tpu_torch.profiling --store``
    (``--probe``, ``--compact``, ``--timeline-stage``) prints it as one
    JSON line."""
    import torch

    from dispersy_tpu_torch import kernels

    kernels.build()
    out = {"n_peers": n_peers, "reps": reps, "card": card_name(),
           "device": torch.cuda.get_device_name(0),
           "kernels": str(Path(kernels.__file__).resolve().parent),
           "cases": {}}
    make = {"store": store_cases, "probe": probe_cases,
            "compact": compact_cases,
            "timeline_stage": timeline_stage_cases}[cases]
    for name, (kernel, plain, yardstick, moved, key) in make(
            n_peers, seed).items():
        if not _same(kernel(), plain()):
            raise AssertionError(f"{name}: the kernel differs from its "
                                 "plain version")
        out["cases"][name] = {
            "kernel": key, "kernel_ms": cuda_ms(kernel, reps),
            "library_ms": cuda_ms(yardstick, reps) if yardstick else None,
            "plain_ms": cuda_ms(plain, 5),
            "bound_ms": moved / 3.35e12 * 1e3}
        torch.cuda.synchronize()
    return out


def profile_roots(roots: list, call: str) -> list:
    """``call``, an expression over this module (say
    ``"profile_store(cases='probe')"`` or ``"profile_delivery()"``) that
    returns a dict naming its ``kernels`` directory, once for each
    checkout in ``roots``, in turn, each in a process of its own whose
    ``dispersy_tpu_torch`` is the checkout's (this file's cases on that
    checkout's kernels and plain versions; say the parent commit
    unpacked with ``git archive`` into a git-ignored directory, in the
    order parent, this, this, parent)."""
    import json
    import subprocess
    import sys
    runs = []
    for root in roots:
        root = str(Path(root).resolve())
        code = ("import importlib.util, json, sys; sys.path.insert(0, {r!r}); "
                "spec = importlib.util.spec_from_file_location("
                "'root_profile', {f!r}); mod = "
                "importlib.util.module_from_spec(spec); "
                "spec.loader.exec_module(mod); "
                "print('PROFILE ' + json.dumps(mod.{c}))").format(
                    r=root, f=str(Path(__file__).resolve()), c=call)
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("PROFILE ")]
        if proc.returncode or not lines:
            raise RuntimeError(f"{call} on {root} failed:\n"
                               f"{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-4000:]}")
        run = json.loads(lines[0][8:])
        if not run["kernels"].startswith(root):
            raise RuntimeError(f"ran {run['kernels']}, not from {root}")
        run["root"] = root
        runs.append(run)
    return runs

if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(description=profile_rounds.__doc__)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--delivery", nargs="*", metavar="ROOT",
                       help="time and trace K1 and K12 at each call shape "
                       "of the 1M rounds (profile_delivery); with "
                       "checkout ROOTs, once on each in turn")
    which.add_argument("--store", nargs="*", metavar="ROOT",
                       help="time K3 and K9 at each call shape of the 1M "
                       "rounds (profile_store); with checkout ROOTs, once "
                       "on each in turn")
    which.add_argument("--probe", nargs="*", metavar="ROOT",
                       help="time K11, K2 and K6 at each call shape of the "
                       "1M rounds (profile_store's probe cases); with "
                       "checkout ROOTs, once on each in turn")
    which.add_argument("--compact", nargs="*", metavar="ROOT",
                       help="time K4, K10 and K5 at each call shape of the "
                       "1M rounds and K5 on rings out of order "
                       "(profile_store's compact cases); with checkout "
                       "ROOTs, once on each in turn")
    which.add_argument("--timeline-stage", nargs="*", metavar="ROOT",
                       help="time K8 at each call shape of the 1M "
                       "permissioned round (the fused intake launches "
                       "beside the calls they replace) and K7 at the diet "
                       "round's (profile_store's timeline_stage cases); "
                       "with checkout ROOTs, once on each in turn")
    which.add_argument("--ragged-shares", action="store_true",
                       help="count what K12's capped calls get in the 1M "
                       "chaos round: binding buckets, crossing groups, "
                       "boundary positions, classes (ragged_shares)")
    which.add_argument("--remove-shares", action="store_true",
                       help="count what K10 gets in the 1M permissioned "
                       "round: live slots and kills by row and by slot "
                       "(remove_shares)")
    which.add_argument("--timeline-shares", action="store_true",
                       help="count the free-slot share of K8's queries in "
                       "the 1M permissioned round (timeline_query_shares)")
    which.add_argument("--diet", action="store_true",
                       help="trace the byte-diet round of bench_config")
    which.add_argument("--timeline", action="store_true",
                       help="trace the permissioned round of "
                       "permissioned_config")
    which.add_argument("--hardened", action="store_true",
                       help="trace the hardened round of hardened_config")
    which.add_argument("--chaos", action="store_true",
                       help="trace the chaos round of chaos_config")
    which.add_argument("--observed", action="store_true",
                       help="trace the observed round of observed_config "
                       "(telemetry and tracing on the diet round)")
    which.add_argument("--soak", action="store_true",
                       help="trace the soak round of soak_config (the "
                       "delay pen, its request channels, double-signed "
                       "and direct metas)")
    args = ap.parse_args()
    if args.delivery is not None:
        for run in (profile_roots(args.delivery, "profile_delivery()")
                    if args.delivery else [profile_delivery()]):
            print(json.dumps(run), flush=True)
        raise SystemExit(0)
    if args.ragged_shares:
        print(json.dumps(ragged_shares()))
        raise SystemExit(0)
    if args.remove_shares:
        print(json.dumps(remove_shares()))
        raise SystemExit(0)
    if args.timeline_shares:
        print(json.dumps(timeline_query_shares()))
        raise SystemExit(0)
    for cases, roots in (("store", args.store), ("probe", args.probe),
                         ("compact", args.compact),
                         ("timeline_stage", args.timeline_stage)):
        if roots is not None:
            runs = (profile_roots(roots, f"profile_store(cases={cases!r})")
                    if roots else [profile_store(cases=cases)])
            for run in runs:
                print(json.dumps(run), flush=True)
            raise SystemExit(0)
    print(json.dumps(profile_rounds(diet=args.diet, timeline=args.timeline,
                                    hardened=args.hardened, chaos=args.chaos,
                                    observed=args.observed,
                                    soak=args.soak,
                                    rounds=5 if args.timeline else 3)))
