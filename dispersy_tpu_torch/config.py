"""Static simulation configuration (port of ``dispersy_tpu/config.py``).

The same frozen dataclass as the JAX package — fields, defaults, derived
properties and validation — so a config means the same round in both
packages.  The plane configs it embeds are copied in ``planes.py``.
All *times* are simulated seconds; one round == one walker interval.
"""

from __future__ import annotations

import dataclasses
import math

from dispersy_tpu_torch.exceptions import ConfigError
from dispersy_tpu_torch.planes import (MAX_TELEMETRY_PEERS, FaultModel,
                                       OverloadConfig, ParallelConfig,
                                       RecoveryConfig, StoreConfig,
                                       TelemetryConfig, TraceConfig)

# Sentinel for "empty slot" in uint32 record fields: sorts after every real
# global_time, so ascending sort pushes holes to the end of the store ring.
EMPTY_U32 = 0xFFFFFFFF
# Sentinel peer index for "no peer" in int32 index fields.
NO_PEER = -1

# ---- narrowed record-column dtypes (the byte diet, BENCH.md roofline) ----
# The fused round is memory-bandwidth-bound, so persistent columns whose
# value range provably fits a narrower word are stored narrow.  Meta ids
# fit 8 bits: user metas stay < MAX_USER_META (24), the dispersy-* control
# band tops out at META_MALICIOUS (0xF7), and the empty-slot sentinel is
# EMPTY_META = 0xFF — exactly the low byte of EMPTY_U32, so plain uint32
# <-> uint8 truncation is the lossless up/down conversion on the reachable
# value set (checkpoint.restore uses this to load pre-narrowing archives).
# Flags carry single bits (bit 0 = undone).  gt / member / payload / aux
# stay uint32: clocks and payloads are genuinely 32-bit, and aux carries
# full permission-nibble masks (4 bits x 8 metas).
EMPTY_META = 0xFF
META_DTYPE = "uint8"
FLAGS_DTYPE = "uint8"

# Candidate categories (reference: candidate.py WalkCandidate tracks separate
# walk/stumble/intro timestamps; categories drive the walk split).
CAT_NONE = 0
CAT_WALKED = 1
CAT_STUMBLED = 2
CAT_INTRODUCED = 3

# Reserved control meta-message ids (reference: community.py
# _initialize_meta_messages registers the dispersy-* control messages beside
# the app's metas; here user metas take ids [0, n_meta) and controls live in
# a reserved band well above them).  A record's columns are overloaded per
# meta:
#   dispersy-authorize / dispersy-revoke: payload = target member,
#       aux = per-meta permission NIBBLES over user meta ids: bit
#       (4*meta + p) grants (or revokes) permission p for that meta, with
#       p in {0=permit, 1=authorize, 2=revoke, 3=undo} — the reference's
#       four permission types (timeline.py Timeline.check resolves
#       (member, message, permission) triples; message.py Authorize/
#       RevokePayload carries [(member, message, permission)] lists,
#       TPU-packed here as one nibble mask per target).  The AUTHORIZE
#       bit for a meta lets its holder issue further authorize records
#       covering that meta — the reference's permission *chains*
#       (timeline.py Timeline.check walks authorize proofs recursively;
#       here chains grow one fold per round, unbounded across rounds —
#       see ops/timeline.check_grant); the REVOKE bit gates issuing
#       revoke records for that meta, separably from AUTHORIZE; the UNDO
#       bit gates dispersy-undo-other on that meta's records.
#   dispersy-undo-own / dispersy-undo-other: payload = target member,
#       aux = target global_time (reference: payload.py UndoPayload
#       (member, global_time, packet))
#   dispersy-dynamic-settings: payload = target user meta id, aux bit 0 =
#       new resolution policy (0 = PublicResolution, 1 = LinearResolution)
#       taking effect for records with global_time > this record's
#       (reference: payload.py DynamicSettingsPayload [(meta, policy)];
#       timeline.py Timeline.get_resolution_policy)
#   dispersy-destroy-community: payload/aux unused — once stored, the
#       peer's community is hard-killed (reference: community.py
#       HardKilledCommunity + DestroyCommunityPayload)
META_AUTHORIZE = 0xF0
META_REVOKE = 0xF1
META_UNDO_OWN = 0xF2
META_UNDO_OTHER = 0xF3
META_DYNAMIC = 0xF4
META_DESTROY = 0xF5
#   dispersy-identity: payload = mid32 (first 4 bytes of SHA1(pubkey));
#       see dispersy_tpu/crypto.py create_identities.
META_IDENTITY = 0xF6
#   dispersy-malicious-proof: payload = the convicted member, aux = the
#       global_time at which it provably double-signed.  Authored by an
#       EYEWITNESS the moment it observes a conflicting pair (a record
#       matching a stored row's (member, global_time) with different
#       content) and spread at CONTROL_PRIORITY, so convictions converge
#       network-wide instead of staying per-observer (reference:
#       dispersy.py malicious-member machinery spreads the conflicting
#       packet pair).  Structural-trust divergence, documented: the
#       reference's proof carries both signed packets for receivers to
#       re-verify; this simulation's wire records carry no signatures to
#       re-check (identity is structural everywhere — SURVEY §7 stage 9),
#       so the claim record IS the recast of the verified pair.
META_MALICIOUS = 0xF7
# Max user metas: per-meta config bitmasks (seq/double/direct/protected)
# live in the low bits of a uint32.
MAX_USER_META = 24
# Timeline grants pack FOUR bits per meta (the permission quadruple below)
# into a u32 table mask, capping timeline communities at 8 user metas.
MAX_TIMELINE_META = 8

# Permission types within one grant nibble (reference: timeline.py
# resolves u"permit" / u"authorize" / u"revoke" / u"undo" per meta).
PERM_PERMIT = 0
PERM_AUTHORIZE = 1
PERM_REVOKE = 2
PERM_UNDO = 3
PERM_NAMES = {"permit": PERM_PERMIT, "authorize": PERM_AUTHORIZE,
              "revoke": PERM_REVOKE, "undo": PERM_UNDO}


def perm_bit(meta: int, perm) -> int:
    """The aux/table-mask bit granting ``perm`` for user meta ``meta``;
    ``perm`` is a PERM_* id or one of the reference's permission strings
    (timeline.py u"permit" etc.)."""
    if isinstance(perm, str):
        try:
            perm = PERM_NAMES[perm]
        except KeyError:
            raise ConfigError(
                f"unknown permission {perm!r}; expected one of "
                f"{sorted(PERM_NAMES)}") from None
    if not 0 <= meta < MAX_TIMELINE_META:
        raise ConfigError(
            f"timeline permissions cover metas [0, {MAX_TIMELINE_META}), "
            f"got {meta}")
    if not 0 <= perm <= PERM_UNDO:
        raise ConfigError(f"unknown permission id {perm}")
    return 1 << (4 * meta + perm)


def perm_mask(pairs) -> int:
    """Nibble mask from [(meta_id, perm)] pairs (see :func:`perm_bit`)."""
    mask = 0
    for meta, perm in pairs:
        mask |= perm_bit(meta, perm)
    return mask


def user_perm_mask(n_meta: int) -> int:
    """All grantable nibble bits for ``n_meta`` user metas."""
    return (1 << (4 * min(n_meta, MAX_TIMELINE_META))) - 1

# Sync-response ordering priorities (reference: distribution.py — each
# Distribution carries a `priority`; community.py gives the permission
# control messages a high one so proofs outrun the records they permit,
# and dispersy-identity a LOW one: identities are bulk data, not urgent —
# without this, an identity flood starves permission records of the
# bounded forward slots and the sync budget).
DEFAULT_PRIORITY = 128
CONTROL_PRIORITY = 224
IDENTITY_PRIORITY = 16

# Byte-equivalent packet sizes for the traffic counters (reference:
# conversion.py wire shapes — 23 B common header = 1 B dispersy version +
# 1 B community version + 20 B master mid + 1 B message id; addresses are
# 6 B sockaddrs).  The simulation has no real wire format (declared
# anti-goal, SURVEY §7); these model the reference's packet sizes so
# total_up/total_down are comparable, not byte-exact.
HEADER_BYTES = 23
ADDR_BYTES = 6
# introduction-request: header + dest/lan/wan addrs + flags byte +
# 2 B identifier + sync tuple (time_low/high 8+8, modulo 2, offset 2)
# + the Bloom bitset (added per-config: bloom_words * 4).
INTRO_REQUEST_BASE_BYTES = HEADER_BYTES + 3 * ADDR_BYTES + 1 + 2 + 20
# introduction-response: header + dest/lan/wan + introduced lan/wan +
# flags + identifier.
INTRO_RESPONSE_BYTES = HEADER_BYTES + 5 * ADDR_BYTES + 1 + 2
# puncture-request: header + target lan/wan + identifier.
PUNCTURE_REQUEST_BYTES = HEADER_BYTES + 2 * ADDR_BYTES + 2
# puncture: header + own lan/wan + identifier.
PUNCTURE_BYTES = HEADER_BYTES + 2 * ADDR_BYTES + 2
# one sync record on the wire: header + 5 uint32 columns.
RECORD_BYTES = HEADER_BYTES + 20
# missing-proof request: header + 2 B identifier + (member, global_time)
# (reference: payload.py MissingProofPayload).
MISSING_PROOF_BYTES = HEADER_BYTES + 2 + 8
# missing-sequence request: header + 2 B identifier + member + 1 B meta +
# (missing_low, missing_high) (reference: payload.py
# MissingSequencePayload (member, message, missing_low, missing_high)).
MISSING_SEQ_BYTES = HEADER_BYTES + 2 + 4 + 1 + 8
# missing-message request: header + 2 B identifier + (member, global_time)
# (reference: payload.py MissingMessagePayload — member + one global_time
# in the round-synchronous recast).
MISSING_MSG_BYTES = HEADER_BYTES + 2 + 8
# missing-identity request: header + 2 B identifier + the 20-byte member
# id (reference: payload.py MissingIdentityPayload carries the mid).
MISSING_IDENTITY_BYTES = HEADER_BYTES + 2 + 20
# signature-request: header + 2 B identifier + the draft record's columns
# (reference: conversion.py packs the half-signed message inside
# dispersy-signature-request; the response carries it back countersigned).
SIGNATURE_REQUEST_BYTES = HEADER_BYTES + 2 + 20
SIGNATURE_RESPONSE_BYTES = HEADER_BYTES + 2 + 20


def priority_of(meta: int, n_meta: int, priorities) -> int:
    """Serving/forwarding priority of one meta id (scalar form; the engine
    computes the same thing vectorized).  User metas carry their declared
    priority; the control band is CONTROL_PRIORITY except low-priority
    dispersy-identity."""
    if meta < n_meta:
        return priorities[meta]
    return IDENTITY_PRIORITY if meta == META_IDENTITY else CONTROL_PRIORITY


def bloom_size_for(error_rate: float, capacity: int) -> tuple[int, int]:
    """(n_bits, n_hashes) for a Bloom filter with the given design point.

    Mirrors the reference's constructor-from-(error_rate, capacity)
    (reference: bloomfilter.py ``BloomFilter.__init__``): standard formulas
    m = -n·ln(p)/ln(2)^2, k = m/n·ln(2); n_bits rounded up to a multiple of
    32 so the bitset packs exactly into uint32 words.
    """
    if not (0.0 < error_rate < 1.0):
        raise ConfigError(f"error_rate must be in (0,1), got {error_rate}")
    if capacity <= 0:
        raise ConfigError(f"capacity must be positive, got {capacity}")
    m = -capacity * math.log(error_rate) / (math.log(2) ** 2)
    n_bits = int(math.ceil(m / 32.0)) * 32
    k = max(1, int(round(n_bits / capacity * math.log(2))))
    return n_bits, k


@dataclasses.dataclass(frozen=True)
class CommunityConfig:
    """All static knobs for one simulated community.

    Field defaults mirror the reference's protocol constants (BASELINE.md
    table; symbol-level citations in each comment).
    """

    # ---- population ----
    n_peers: int = 1024
    n_trackers: int = 2  # bootstrap peers, indices [0, n_trackers)
    #   (reference: bootstrap.py tracker list -> BootstrapCandidate)
    # Multi-community layout (reference: dispersy.py multiplexes many
    # Community instances over one runtime; the sync table is keyed by
    # community).  Each entry is (n_members, n_trackers) for one community;
    # the row axis is laid out as [all trackers, community-major][all
    # members, community-major], so every community is a contiguous block
    # with its own trackers inside the global tracker prefix and the whole
    # multiplex runs as ONE fused step — walks, candidates, stores and
    # clocks never cross blocks because candidates only ever enter through
    # in-block walks/bootstraps.  A physical peer joining k communities
    # contributes one row per membership, exactly like the reference's one
    # Community instance per joined overlay.  Empty = single community
    # (n_peers, n_trackers).
    communities: tuple = ()

    # ---- walker (reference: community.py walker task + candidate.py) ----
    walk_interval: float = 5.0          # seconds per round / per step
    walk_timeout: float = 10.5          # IntroductionRequestCache.timeout_delay
    walk_lifetime: float = 57.5         # WalkCandidate walk/stumble lifetime
    intro_lifetime: float = 27.5        # lifetime of introduced candidates
    eligibility_delay: float = 27.5     # min age before re-walking a candidate
    # Category split for dispersy_get_walk_candidate (reference:
    # community.py; ≈49.75% walked / 24.875% stumbled / 24.875% introduced /
    # 0.5% bootstrap).
    p_revisit_walked: float = 0.4975
    p_stumbled: float = 0.24875
    p_introduced: float = 0.24875
    p_bootstrap: float = 0.005
    k_candidates: int = 16              # candidate-table slots per peer
    walker_enabled: bool = True         # dispersy_enable_candidate_walker

    # ---- bloom sync (reference: community.py dispersy_claim_sync_bloom_filter,
    #      bloomfilter.py; bloom sized to fit one ~1500B UDP payload) ----
    sync_enabled: bool = True           # dispersy_enable_bloom_filter_sync
    sync_strategy: str = "largest"      # "largest" | "modulo" claim strategy
    #   (reference: _dispersy_claim_sync_bloom_filter_largest / _modulo)
    bloom_error_rate: float = 0.01      # dispersy_sync_bloom_filter_error_rate
    bloom_capacity: int = 256           # entries per sync slice / bloom
    response_budget: int = 16           # records per sync response
    #   (reference: dispersy_sync_response_limit ≈ 5 KB / packet size)

    # ---- message store (reference: the SQLite `sync` table;
    #      UNIQUE(community, member, global_time)) ----
    msg_capacity: int = 256             # store ring slots per peer
    request_inbox: int = 8              # intro-requests processed per peer/round
    tracker_inbox: int = 512            # intro-requests a *tracker* serves/round
    #   (reference: tool/tracker.py runs dedicated high-capacity introduction
    #    servers; a flash-crowd of bootstrapping peers is their design load.
    #    Size this near n_peers/n_trackers for cold flash-crowd starts: an
    #    undersized tracker leaves the overlay storm-locked — everyone
    #    bootstraps, drops, and removes candidates forever.  The tracker
    #    inbox is a compact [n_trackers, tracker_inbox] array, so large
    #    values are cheap.)
    # Sync intake needs no separate inbox knob: records flow back only
    # along the request edge, so per-round intake is exactly
    # request-count x response_budget by construction.

    # ---- push forwarding (reference: dispersy.py store_update_forward ->
    #      _forward: every freshly accepted/created sync message is pushed
    #      to `node_count` random verified candidates, per
    #      destination.py CommunityDestination(node_count=10)) ----
    forward_fanout: int = 3             # candidates pushed to per record batch
    forward_buffer: int = 4             # fresh records buffered per peer/round
    push_inbox: int = 16                # pushed records accepted per peer/round

    # ---- distribution policies per user meta (reference: distribution.py
    #      FullSyncDistribution / LastSyncDistribution / DirectDistribution;
    #      message.py binds one policy per meta) ----
    # keep-last-k per (member, meta): 0 = FullSync (keep everything);
    # k > 0 = LastSyncDistribution(history_size=k).  Empty tuple = all 0.
    last_sync_history: tuple = ()
    # Bit i set: user meta i is FullSync with enable_sequence_number — the
    # author stamps consecutive sequence numbers in `aux` and receivers
    # accept strictly in order; gaps are repaired by the Bloom pull (the
    # record stays out of the requester's bloom until accepted, so the
    # responder keeps re-offering it — the round-synchronous equivalent of
    # dispersy-missing-sequence).
    seq_meta_mask: int = 0
    # Bit i set: user meta i is DirectDistribution — delivered by one push
    # hop to sampled verified candidates (CommunityDestination shape),
    # never stored, never synced, never re-forwarded; receipt is counted in
    # stats.msgs_direct.
    direct_meta_mask: int = 0
    # Sync-response ordering (reference: the responder's ORDER BY
    # (priority DESC, global_time ASC|DESC per meta)).  Empty tuple = all
    # DEFAULT_PRIORITY.  Control metas are fixed at CONTROL_PRIORITY.
    meta_priority: tuple = ()
    # Bit i set: user meta i syncs newest-first (DESC).
    desc_meta_mask: int = 0

    # ---- double-signed messages (reference: authentication.py
    #      DoubleMemberAuthentication + the dispersy-signature-request/
    #      -response flow, SURVEY §3.5; stored rows land in
    #      double_signed_sync) ----
    # Bit i set: user meta i needs two signatures — the author drafts the
    # record and a chosen counterparty countersigns before it enters the
    # store (record's `aux` column carries the countersigner id).
    double_meta_mask: int = 0
    # Outstanding signature request lifetime (reference: the signature
    # RequestCache timeout; the request is sent ONCE — no retransmit — and
    # the cache slot frees on timeout, exactly like the reference).
    sig_timeout: float = 10.5
    # signature-requests a peer processes per round (bounded inbox).
    sig_inbox: int = 4
    # Probability the counterparty agrees to countersign — the simulation
    # knob standing in for the app-supplied allow_signature_func
    # (reference: community.py on_signature_request delegates the decision
    # to the application).  Deterministic per (peer, round, slot) draw.
    countersign_rate: float = 1.0

    # ---- delayed messages (reference: message.py ``DelayMessageByProof``
    #      + community.py on_missing_proof / dispersy-missing-proof): a
    #      record rejected ONLY because its permission proof has not
    #      arrived yet is parked in a bounded per-peer pen and re-enters
    #      the intake batch every round until the authorize record lands,
    #      the pen overflows, or it times out.  The round-synchronous
    #      recast of "delay the batch, request the proof, release on
    #      arrival": the proof request itself is subsumed by the timeline
    #      records' CONTROL_PRIORITY spread; the *delay semantics* — the
    #      record is not lost while the proof is in flight — live here.
    #      0 disables the pen (rejected records are dropped and re-learned
    #      only when a Bloom re-offer happens to repeat them). ----
    delay_inbox: int = 0                # pen slots per peer
    delay_timeout: float = 52.5         # seconds a record may wait
    #   (reference: DelayMessage lifetimes are request-cache timeouts;
    #    10.5 s x ~5 retries is the missing-proof retry window)
    # Active missing-proof round trips (reference: community.py
    # on_missing_proof / the dispersy-missing-proof exchange): each round
    # a peer with parked records asks each record's DELIVERING peer for
    # the author's grant chain; the server answers with its stored
    # authorize/revoke records targeting that author, returned by receipt
    # in the same round — pen residence becomes one round trip instead of
    # Bloom re-offer luck.  Off by default (the passive pen alone matches
    # the r2 semantics; this knob adds the reference's active request).
    proof_requests: bool = False
    proof_inbox: int = 4                # proof requests served per round
    proof_budget: int = 2               # control records returned per request
    # Active missing-sequence round trips (reference: community.py
    # on_missing_sequence / message.py DelayMessageBySequence): a
    # sequence-gapped record PARKS in the same pen instead of being
    # rejected, and each round its deliverer is asked for the missing
    # range [holder's max+1, gap-1]; the server answers with its stored
    # in-range records (ascending — chains accept bottom-up), returned by
    # receipt in the same round.  Gap-fill latency becomes a round trip
    # instead of Bloom re-offer luck.  Shares the pen and the
    # proof_inbox/proof_budget channel bounds.
    seq_requests: bool = False
    # Active missing-message round trips (reference: community.py
    # on_missing_message / payload.py MissingMessagePayload, via
    # message.py DelayPacketByMissingMessage): a dispersy-undo-other
    # whose check fails (target record not yet stored, or undoer's grant
    # chain unseen) PARKS in the pen instead of being rejected, and each
    # round its deliverer is asked for the exact (member, global_time)
    # record it names; the stored record rides back by receipt and joins
    # the same round's intake — the undo re-checks against it next round.
    # Shares the pen and the proof_inbox channel bound (budget 1: the
    # UNIQUE(member, global_time) store key makes the reply a single
    # record).
    msg_requests: bool = False
    # Unknown-member gate (reference: member.py — a packet whose author's
    # public key is unknown cannot be verified; conversion.py raises
    # DelayPacketByMissingMember): a USER record from an author whose
    # dispersy-identity record is not stored parks in the pen (or, with
    # the pen disabled/full, is rejected and re-learned by Bloom
    # re-offer).  Control records stay exempt — their authority is
    # structural in the simulation (SURVEY §7 stage 9).
    identity_required: bool = False
    # Active missing-identity round trips (reference: community.py
    # on_missing_identity / payload.py MissingIdentityPayload): each
    # round an identity-parked record's deliverer is asked for the
    # author's stored dispersy-identity record, returned by receipt in
    # the same round.  Shares the pen and proof_inbox bound (budget 1:
    # one identity record per member).
    identity_requests: bool = False

    # ---- clock (reference: community.py claim_global_time /
    #      dispersy_acceptable_global_time_range) ----
    acceptable_global_time_range: int = 10000

    # ---- environment / fault model (reference: failure handling *is* the
    #      protocol — candidate timeouts, walk timeouts; SURVEY.md §5.3) ----
    churn_rate: float = 0.0             # fraction of peers replaced per round
    packet_loss: float = 0.0            # Bernoulli drop per logical packet
    #   (traced-liftable under the fleet plane: a per-replica override
    #    may replace this VALUE inside one compiled multi-replica
    #    program while the config stays static — faults.
    #    TRACED_FAULT_KNOBS / engine.effective_faults; FLEET.md)
    # ---- NAT model (reference: candidate.py ``connection_type`` —
    #      u"public" vs u"symmetric-NAT", advertised in every
    #      introduction request/response; community.py
    #      dispersy_get_introduce_candidate never introduces two
    #      symmetric-NAT peers to each other because the puncture
    #      exchange cannot open a mapping between two address-dependent
    #      NATs).  ``p_symmetric``: fraction of members behind a
    #      symmetric NAT, assigned statically per identity (the NAT is
    #      the router's property — it survives churn rebirth; trackers
    #      are public infrastructure).  Effects when > 0: responders and
    #      trackers never introduce symmetric<->symmetric, and a
    #      puncture between two symmetric peers is dropped (so even a
    #      stray pairing cannot hole-punch) — symmetric peers reach each
    #      other's records via public intermediaries, exactly the
    #      reference's behavior. ----
    p_symmetric: float = 0.0

    # ---- identity (reference: member.py / dispersy-identity; see
    #      dispersy_tpu/crypto.py) ----
    # Declares that dispersy-identity records are in play, which folds
    # IDENTITY_PRIORITY into the serving/forwarding order so an identity
    # flood cannot starve other records of the bounded budgets.
    # create_identities refuses to run without it.
    identity_enabled: bool = False

    # ---- malicious-member bookkeeping (reference: dispersy.py's
    #      malicious-member machinery + dispersy-malicious-proof: a member
    #      provably signing two DIFFERENT messages at one global_time is
    #      blacklisted).  Detection is local-per-peer: a conflicting
    #      arrival against the store convicts the author on the receiving
    #      peer, which then rejects all its records at intake and ejects
    #      it from the candidate table.  With malicious_gossip on, an
    #      eyewitness additionally AUTHORS a dispersy-malicious-proof
    #      record (META_MALICIOUS: the reference spreads the conflicting
    #      packet pair) that sync-spreads at CONTROL_PRIORITY; accepting
    #      peers convict too, so blacklists converge network-wide instead
    #      of per-observer. ----
    malicious_enabled: bool = False
    k_malicious: int = 8                # blacklist slots per peer
    malicious_gossip: bool = False      # spread convictions as records

    # ---- community load/unload (reference: dispersy.py define_auto_load
    #      / get_community(load=True) + Community.load_community /
    #      unload_community, tests/test_classification.py) ----
    # True (the reference's default): a community packet arriving at a
    # peer whose instance is unloaded loads it for the next round.  False:
    # only an explicit load (scenario Load event / Community.load) does.
    auto_load: bool = True

    # ---- permissions (reference: timeline.py; bounded table of authorized
    #      members — real overlays authorize a handful of members) ----
    timeline_enabled: bool = False
    k_authorized: int = 16              # authorized-member slots per peer
    n_meta: int = 8                     # distinct user meta-message ids
    # Bit i set: user meta i is LinearResolution-protected — a record is
    # accepted only if its author holds the permit permission at the
    # record's global_time (reference: resolution.py LinearResolution +
    # timeline.py Timeline.check).  Unset bits are PublicResolution.
    protected_meta_mask: int = 0
    # Bit i set: user meta i is DynamicResolution — its policy can be
    # flipped at runtime by founder-sent dispersy-dynamic-settings records
    # (reference: resolution.py DynamicResolution, community.py
    # create_dynamic_settings).  The meta's protected_meta_mask bit is its
    # *initial* policy; a record is checked against the policy in force at
    # the record's own global_time, i.e. the highest-global_time flip at or
    # below it, replayed from the store exactly like the reference rebuilds
    # Timeline policy state from the database.
    dynamic_meta_mask: int = 0
    # The community founder: implicit holder of every permission, the root
    # of authority (reference: community.py master member).  Authorize/
    # revoke records are accepted from the founder or from any member
    # holding the AUTHORIZE/REVOKE permission for every granted meta
    # (nibble grants — ops/timeline.check_grant, mirroring
    # Timeline.check's recursive proof walk); undo-other needs the UNDO
    # permission on the target's meta, dynamic-settings the AUTHORIZE
    # permission on the flipped meta; destroy stays founder-only
    # (reference: the master member signs dispersy-destroy-community).
    # -1 = auto: the first non-tracker peer (index n_trackers).
    founder_member: int = -1

    # ---- parallel plane (dispersy_tpu/shardplane.py: shard-count +
    #      cross-shard exchange budget + chunked bloom scatters for the
    #      sharding-clean multichip step; PARALLEL.md).  All defaults
    #      compile to exactly the legacy single-device step.  MUST stay
    #      the SEVENTH-TO-LAST field, directly before ``trace`` (then
    #      ``store``, ``overload``, ``recovery``, ``telemetry``,
    #      ``faults``): checkpoint.py reconstructs pre-v16 config
    #      fingerprints by stripping the trailing ``parallel=...`` repr
    #      component (then ``trace=`` pre-v15, ``store=`` pre-v14,
    #      ``overload=`` pre-v13, ``recovery=`` pre-v12, ``telemetry=``
    #      pre-v10, ``faults=`` pre-v9). ----
    parallel: ParallelConfig = ParallelConfig()

    # ---- dissemination-tracing plane (dispersy_tpu/traceplane.py:
    #      on-device record lineage — per-peer first-arrival rounds,
    #      first-delivery channel codes, duplicate-delivery counters,
    #      coverage-percentile latches; OBSERVABILITY.md "Dissemination
    #      tracing").  All defaults compile to exactly the trace-free
    #      step.  MUST stay the SIXTH-TO-LAST field, directly before
    #      ``store`` (then ``overload``, ``recovery``, ``telemetry``,
    #      ``faults``): checkpoint.py reconstructs pre-v15 config
    #      fingerprints by stripping the trailing ``trace=...`` repr
    #      component (then ``store=`` pre-v14, ``overload=`` pre-v13,
    #      ``recovery=`` pre-v12, ``telemetry=`` pre-v10, ``faults=``
    #      pre-v9). ----
    trace: TraceConfig = TraceConfig()

    # ---- byte-diet store plane (dispersy_tpu/storediet.py: staging
    #      buffer + amortized compaction, cadenced sync, incremental
    #      Bloom digest — the ROADMAP item 1 byte diet).  All defaults
    #      compile to exactly the legacy every-round-merge step.  MUST
    #      stay the FIFTH-TO-LAST field, directly before ``overload``
    #      (then ``recovery``, ``telemetry``, ``faults``):
    #      checkpoint.py reconstructs pre-v14 config fingerprints by
    #      stripping the trailing ``store=...`` repr component (then
    #      ``overload=`` pre-v13, ``recovery=`` pre-v12, ``telemetry=``
    #      pre-v10, ``faults=`` pre-v9). ----
    store: StoreConfig = StoreConfig()

    # ---- ingress-protection plane (dispersy_tpu/overload.py:
    #      per-sender token buckets, priority admission under inbox
    #      overflow, flood-fair drop attribution; OVERLOAD.md).  All
    #      defaults compile to exactly the protection-free step.  MUST
    #      stay the FOURTH-TO-LAST field, directly before ``recovery``
    #      (then ``telemetry``, then ``faults``): checkpoint.py
    #      reconstructs pre-v13 config fingerprints by stripping the
    #      trailing ``overload=...`` repr component (then
    #      ``recovery=`` pre-v12, ``telemetry=`` pre-v10, ``faults=``
    #      pre-v9). ----
    overload: OverloadConfig = OverloadConfig()

    # ---- recovery plane (dispersy_tpu/recovery.py: staged repair of
    #      health-flagged peers — soft repair, walk backoff, quarantine
    #      with hysteresis; RECOVERY.md).  All defaults compile to
    #      exactly the recovery-free step.  MUST stay the THIRD-TO-LAST
    #      field, directly before ``telemetry`` (which precedes
    #      ``faults``): checkpoint.py reconstructs pre-v12 config
    #      fingerprints by stripping the trailing ``recovery=...`` repr
    #      component (then ``telemetry=`` pre-v10, ``faults=``
    #      pre-v9). ----
    recovery: RecoveryConfig = RecoveryConfig()

    # ---- telemetry plane (dispersy_tpu/telemetry.py: fused in-step
    #      metrics row, device-resident round-history ring, on-device
    #      histograms, flight recorder — OBSERVABILITY.md).  All
    #      defaults compile to exactly the telemetry-free step.  MUST
    #      stay the SECOND-TO-LAST field, directly before ``faults``:
    #      checkpoint.py reconstructs pre-v10 config fingerprints by
    #      stripping the trailing ``telemetry=...`` (and, pre-v9,
    #      ``faults=...``) repr components. ----
    telemetry: TelemetryConfig = TelemetryConfig()

    # ---- correlated fault channel + health sentinels (the chaos
    #      harness — dispersy_tpu/faults.py: Gilbert–Elliott bursty
    #      loss, region partitions, duplication, corruption, byzantine
    #      flooders, on-device health bits).  All-defaults compiles to
    #      exactly the fault-free step (FAULTS.md).  MUST stay the LAST
    #      field (with ``telemetry`` directly before it): checkpoint.py
    #      reconstructs pre-v10/pre-v9 config fingerprints by stripping
    #      the trailing repr components. ----
    faults: FaultModel = FaultModel()

    # ------------------------------------------------------------------
    @property
    def bloom_bits(self) -> int:
        return bloom_size_for(self.bloom_error_rate, self.bloom_capacity)[0]

    @property
    def bloom_hashes(self) -> int:
        return bloom_size_for(self.bloom_error_rate, self.bloom_capacity)[1]

    @property
    def bloom_words(self) -> int:
        return self.bloom_bits // 32

    @property
    def store_diet(self) -> bool:
        """Is the incremental (staging + digest + cadenced-sync) store
        plane compiled in?  (dispersy_tpu/storediet.py)"""
        return self.store.staging > 0

    @property
    def aux_dtype(self) -> str:
        """The persistent ``aux`` record-column dtype: u16 under the
        byte-diet opt-in (store.aux_bits=16), u32 otherwise.  Wire/batch
        aux stays u32 everywhere; the store boundary truncates (the
        meta/flags narrowing pattern, ops/store.store_insert)."""
        return "uint16" if self.store.aux_bits == 16 else "uint32"

    @property
    def store_stagger(self) -> bool:
        """Is the cohort-staggered compaction cadence compiled in?
        (store.cohorts > 1 riding the diet; storediet.stagger_of)"""
        return self.store.staging > 0 and self.store.cohorts > 1

    @property
    def cand_stamp_dtype(self) -> str:
        """The persistent candidate-timestamp dtype: u16 round-stamps
        under the byte-diet opt-in (store.cand_bits=16), f32 sim-seconds
        otherwise.  The walker always computes on f32 seconds; the store
        boundary (de)quantizes (engine._tab / engine's wrap-up)."""
        return "uint16" if self.store.cand_bits == 16 else "float32"

    @property
    def walk_lifetime_rounds(self) -> float:
        return self.walk_lifetime / self.walk_interval

    @property
    def intro_lifetime_rounds(self) -> float:
        return self.intro_lifetime / self.walk_interval

    @property
    def eligibility_delay_rounds(self) -> float:
        return self.eligibility_delay / self.walk_interval

    @property
    def sig_timeout_rounds(self) -> int:
        """Signature-request lifetime in whole rounds (>= 1 when enabled)."""
        return int(self.sig_timeout / self.walk_interval)

    @property
    def delay_enabled(self) -> bool:
        """Is the DelayMessageByProof pen compiled in?"""
        return self.delay_inbox > 0

    @property
    def delay_timeout_rounds(self) -> int:
        """Pen-record lifetime in whole rounds (>= 1 when enabled)."""
        return int(self.delay_timeout / self.walk_interval)

    @property
    def founder(self) -> int:
        """Resolved founder index (founder_member with -1 defaulted)."""
        return self.n_trackers if self.founder_member < 0 else self.founder_member

    @property
    def history(self) -> tuple:
        """last_sync_history with the empty default expanded."""
        return self.last_sync_history or (0,) * self.n_meta

    @property
    def priorities(self) -> tuple:
        """meta_priority with the empty default expanded."""
        return self.meta_priority or (DEFAULT_PRIORITY,) * self.n_meta

    @property
    def any_last_sync(self) -> bool:
        return any(k > 0 for k in self.history)

    @property
    def n_communities(self) -> int:
        return len(self.communities) or 1

    def layout(self):
        """Per-row community layout arrays (numpy, computed per config).

        Returns ``(community, boot_base, boot_count, mem_base, mem_count)``
        int32[n_peers] arrays: each row's community id, its community's
        tracker range [boot_base, boot_base + boot_count) and member range
        [mem_base, mem_base + mem_count) in global row indices.  Used as
        trace-time constants by the engine and directly by the oracle, so
        both derive identical structure from one place.
        """
        import numpy as np
        n = self.n_peers
        if not self.communities:
            t = self.n_trackers
            return (np.zeros(n, np.int32),
                    np.zeros(n, np.int32),
                    np.full(n, t, np.int32),
                    np.full(n, t, np.int32),
                    np.full(n, n - t, np.int32))
        community = np.zeros(n, np.int32)
        boot_base = np.zeros(n, np.int32)
        boot_count = np.zeros(n, np.int32)
        mem_base = np.zeros(n, np.int32)
        mem_count = np.zeros(n, np.int32)
        t_off = 0
        m_off = self.n_trackers
        for c, (m_c, t_c) in enumerate(self.communities):
            for lo, hi in ((t_off, t_off + t_c), (m_off, m_off + m_c)):
                community[lo:hi] = c
                boot_base[lo:hi] = t_off
                boot_count[lo:hi] = t_c
                mem_base[lo:hi] = m_off
                mem_count[lo:hi] = m_c
            t_off += t_c
            m_off += m_c
        return community, boot_base, boot_count, mem_base, mem_count

    @property
    def needs_priority_forward(self) -> bool:
        """Does the forward-buffer selection need priority ordering?  The
        bounded push buffer admits the F highest-priority fresh records
        (control metas outrank user metas), so a dispersy-authorize or
        dynamic-settings record cannot lose its only push to bulk traffic.
        Plain communities (no timeline, no identities, uniform priorities)
        keep cheap batch-order selection."""
        return (self.timeline_enabled or self.identity_enabled
                or len(set(self.priorities)) > 1)

    @property
    def needs_response_order(self) -> bool:
        """Does the sync responder need a non-store-order view?  True when
        priorities differ across metas (incl. control metas outranking user
        metas under the timeline, or low-priority identity records being
        in play) or any meta syncs DESC."""
        if self.desc_meta_mask:
            return True
        if len(set(self.priorities)) > 1:
            return True
        if self.identity_enabled and self.priorities[0] != IDENTITY_PRIORITY:
            return True
        return self.timeline_enabled and self.priorities[0] != CONTROL_PRIORITY

    def __post_init__(self) -> None:
        if self.n_peers <= 0:
            raise ConfigError("n_peers must be positive")
        if not (0 <= self.n_trackers <= self.n_peers):
            raise ConfigError("n_trackers must be in [0, n_peers]")
        p = (self.p_revisit_walked + self.p_stumbled + self.p_introduced
             + self.p_bootstrap)
        if abs(p - 1.0) > 1e-6:
            raise ConfigError(f"walk category probabilities sum to {p}, not 1")
        if self.forward_fanout > self.k_candidates:
            raise ConfigError("forward_fanout cannot exceed k_candidates")
        if self.forward_fanout > 0 and (self.forward_buffer < 1
                                        or self.push_inbox < 1):
            raise ConfigError("forward_fanout > 0 requires forward_buffer >= 1 "
                             "and push_inbox >= 1")
        if not (1 <= self.n_meta <= MAX_USER_META):
            raise ConfigError(f"n_meta must be in [1, {MAX_USER_META}]")
        if self.protected_meta_mask >> self.n_meta:
            raise ConfigError("protected_meta_mask has bits above n_meta")
        if self.dynamic_meta_mask:
            if self.dynamic_meta_mask >> self.n_meta:
                raise ConfigError("dynamic_meta_mask has bits above n_meta")
            if not self.timeline_enabled:
                raise ConfigError("dynamic_meta_mask requires "
                                 "timeline_enabled (policy flips are "
                                 "timeline state)")
        for name, mask in (("seq_meta_mask", self.seq_meta_mask),
                           ("direct_meta_mask", self.direct_meta_mask),
                           ("desc_meta_mask", self.desc_meta_mask),
                           ("double_meta_mask", self.double_meta_mask)):
            if mask >> self.n_meta:
                raise ConfigError(f"{name} has bits above n_meta")
        if self.seq_meta_mask & self.direct_meta_mask:
            raise ConfigError("a meta cannot be both sequenced and direct")
        if self.double_meta_mask & (self.seq_meta_mask
                                    | self.direct_meta_mask):
            # aux carries the countersigner for double metas, so it cannot
            # also carry a sequence number; Direct never stores, so a
            # double signature would protect nothing.
            raise ConfigError("a double-signed meta cannot be sequenced or "
                             "direct")
        if self.double_meta_mask:
            if self.sig_inbox < 1:
                raise ConfigError("double_meta_mask requires sig_inbox >= 1")
            if self.sig_timeout_rounds < 1:
                raise ConfigError("sig_timeout must cover >= 1 round")
            if not (0.0 <= self.countersign_rate <= 1.0):
                raise ConfigError("countersign_rate must be in [0, 1]")
        if self.seq_meta_mask & self.desc_meta_mask:
            # DESC would deliver newest-first and leave permanent sequence
            # gaps; the reference pairs enable_sequence_number with ASC.
            raise ConfigError("sequenced metas must sync ASC")
        if self.last_sync_history and len(self.last_sync_history) != self.n_meta:
            raise ConfigError("last_sync_history length must equal n_meta")
        if self.meta_priority and len(self.meta_priority) != self.n_meta:
            raise ConfigError("meta_priority length must equal n_meta")
        if any(not (0 <= p <= 255) for p in self.priorities):
            raise ConfigError("meta_priority entries must be in [0, 255]")
        for i, k in enumerate(self.history):
            if k < 0:
                raise ConfigError("last_sync_history entries must be >= 0")
            if k > 0 and ((self.seq_meta_mask >> i) & 1
                          or (self.direct_meta_mask >> i) & 1):
                raise ConfigError("a LastSync meta cannot be sequenced/direct")
        if self.communities:
            if any(m < 0 or t < 0 for m, t in self.communities):
                raise ConfigError("community sizes must be non-negative")
            if sum(m + t for m, t in self.communities) != self.n_peers:
                raise ConfigError("community blocks must sum to n_peers")
            if sum(t for _, t in self.communities) != self.n_trackers:
                raise ConfigError(
                    "community tracker counts must sum to n_trackers")
            if self.timeline_enabled and self.founder_member >= 0:
                raise ConfigError(
                    "multi-community timelines use per-community founders "
                    "(each block's first member); founder_member must stay "
                    "auto (-1)")
        if self.timeline_enabled:
            f = self.founder
            if not (self.n_trackers <= f < self.n_peers):
                raise ConfigError("founder_member must be a non-tracker peer")
            if self.k_authorized < 1:
                raise ConfigError("timeline_enabled requires k_authorized >= 1")
            if self.n_meta > MAX_TIMELINE_META:
                raise ConfigError(
                    f"timeline grants pack 4 permission bits per meta into "
                    f"a u32, so timeline_enabled caps n_meta at "
                    f"{MAX_TIMELINE_META} (got {self.n_meta})")
        if self.malicious_enabled and self.k_malicious < 1:
            raise ConfigError("malicious_enabled requires k_malicious >= 1")
        if self.malicious_gossip and not self.malicious_enabled:
            raise ConfigError("malicious_gossip requires malicious_enabled "
                              "(gossip spreads convictions the local "
                              "detector produces)")
        if not (0.0 <= self.p_symmetric <= 1.0):
            raise ConfigError("p_symmetric must be in [0, 1]")
        if self.delay_inbox < 0:
            raise ConfigError("delay_inbox must be >= 0")
        if self.delay_inbox > 0:
            if not self.timeline_enabled:
                raise ConfigError("delay_inbox requires timeline_enabled "
                                 "(only permission-rejected records are "
                                 "delayable — DelayMessageByProof)")
            if self.delay_timeout_rounds < 1:
                raise ConfigError("delay_timeout must cover >= 1 round")
        if self.proof_requests:
            if not self.delay_enabled:
                raise ConfigError("proof_requests requires delay_inbox > 0 "
                                 "(only parked records request proofs)")
            if self.proof_inbox < 1 or self.proof_budget < 1:
                raise ConfigError("proof_requests requires proof_inbox >= 1 "
                                 "and proof_budget >= 1")
        if self.seq_requests:
            if not self.seq_meta_mask:
                raise ConfigError("seq_requests needs a seq_meta_mask "
                                  "(no sequenced metas, no gaps to fill)")
            if not self.delay_enabled:
                raise ConfigError("seq_requests requires delay_inbox > 0 "
                                  "(gapped records park in the pen; note "
                                  "the pen itself needs timeline_enabled)")
            if self.proof_inbox < 1 or self.proof_budget < 1:
                raise ConfigError("seq_requests shares the proof channel: "
                                  "proof_inbox/proof_budget must be >= 1")
        if self.msg_requests:
            if not self.timeline_enabled:
                raise ConfigError("msg_requests serves undo-other targets, "
                                  "which need timeline_enabled")
            if not self.delay_enabled:
                raise ConfigError("msg_requests requires delay_inbox > 0 "
                                  "(target-less undos park in the pen)")
            if self.proof_inbox < 1:
                raise ConfigError("msg_requests shares the proof channel: "
                                  "proof_inbox must be >= 1")
        if self.identity_required and not self.identity_enabled:
            raise ConfigError("identity_required gates on stored "
                              "dispersy-identity records — set "
                              "identity_enabled and create_identities first")
        fm = self.faults
        if not isinstance(fm, FaultModel):
            raise ConfigError("faults must be a FaultModel")
        for (a_lo, a_hi), (b_lo, b_hi) in fm.partitions:
            if a_hi > self.n_peers or b_hi > self.n_peers:
                raise ConfigError(
                    f"partition ranges must stay inside [0, {self.n_peers})")
            if not (a_hi <= b_lo or b_hi <= a_lo):
                raise ConfigError(
                    f"partition sides [{a_lo},{a_hi}) and [{b_lo},{b_hi}) "
                    "overlap — a peer on both sides would be cut off from "
                    "its own side; sides must be disjoint")
        if fm.flood_enabled:
            if any(s >= self.n_peers for s in fm.flood_senders):
                raise ConfigError("flood_senders must be peer indices "
                                  f"< n_peers ({self.n_peers})")
            if self.n_peers <= self.n_trackers:
                raise ConfigError("flooding needs at least one non-tracker "
                                  "victim")
            if self.push_inbox < 1:
                raise ConfigError("flooding rides the push channel: "
                                  "push_inbox must be >= 1")
        tr = self.trace
        if not isinstance(tr, TraceConfig):
            raise ConfigError("trace must be a TraceConfig")
        if tr.enabled:
            # The lineage channel table covers exactly create /
            # walk-sync / push / flood (traceplane.CHANNEL_NAMES), so
            # the plane refuses configs that open OTHER intake
            # segments or create sites — attribution would silently
            # have no code for them (traceplane.py scope gate).
            for flag, why in (
                    (self.delay_enabled,
                     "the delay pen re-enters records through its own "
                     "intake segment (and carries the proof/seq/msg/"
                     "identity request channels)"),
                    (bool(self.double_meta_mask),
                     "double-signed completions arrive through the "
                     "signature segment"),
                    (self.malicious_gossip,
                     "eyewitness proofs are authored inside the fused "
                     "step, a create site the lineage fold cannot "
                     "attribute")):
                if flag:
                    raise ConfigError(
                        "trace.enabled (the dissemination-tracing "
                        f"plane) is incompatible with this knob: {why}; "
                        "its channel table covers create/walk-sync/"
                        "push/flood only")
        sd = self.store
        if not isinstance(sd, StoreConfig):
            raise ConfigError("store must be a StoreConfig")
        if sd.staging > 0:
            # The incremental store serves/queries through the epoch
            # digest and defers ring merges; the full-feature check
            # pipeline (timeline folds, sequence chains, conviction
            # scans, the delay pen) reads the every-round-merged store
            # directly and stays on the legacy path.  Gate loudly
            # instead of silently diverging (STORE.md scope table).
            for flag, why in (
                    (self.timeline_enabled,
                     "timeline folds re-walk the merged store"),
                    (self.malicious_enabled,
                     "conviction scans compare arrivals against the "
                     "merged store"),
                    (bool(self.seq_meta_mask),
                     "sequence chains read stored maxima every round"),
                    (bool(self.double_meta_mask),
                     "the signature flow stores completions directly"),
                    (self.delay_enabled,
                     "the delay pen re-checks against the merged "
                     "store"),
                    (self.identity_required,
                     "the identity gate queries stored identities "
                     "every round")):
                if flag:
                    raise ConfigError(
                        "store.staging (the incremental byte-diet "
                        f"store) is incompatible with this knob: {why}; "
                        "use the legacy store (store.staging=0) for "
                        "full-feature communities")
            if self.sync_enabled and self.sync_strategy != "largest":
                raise ConfigError(
                    "store.staging requires sync_strategy='largest': "
                    "the digest covers the newest-window slice; a "
                    "modulo stripe changes per epoch and would leave "
                    "digest false negatives for out-of-stripe records")
            if sd.cohorts > 1:
                # The staggered cadence extracts the active cohort's
                # rows as one reshape + dynamic-slice block
                # (ops/store.cohort_take), which needs the mod
                # assignment to tile the peer axis exactly.
                if self.n_peers % sd.cohorts:
                    raise ConfigError(
                        "store.cohorts must divide n_peers: cohort "
                        "blocks are extracted as equal reshape slices "
                        f"({self.n_peers} % {sd.cohorts} != 0)")
                if not self.sync_enabled:
                    raise ConfigError(
                        "store.cohorts > 1 staggers the SYNC cadence — "
                        "meaningless with sync_enabled=False; leave "
                        "cohorts=1")
        ov = self.overload
        if not isinstance(ov, OverloadConfig):
            raise ConfigError("overload must be an OverloadConfig")
        rc = self.recovery
        if not isinstance(rc, RecoveryConfig):
            raise ConfigError("recovery must be a RecoveryConfig")
        if rc.enabled and not fm.health_checks:
            raise ConfigError(
                "recovery.enabled maps latched health-sentinel bits to "
                "repair actions — it requires faults.health_checks=True")
        pl = self.parallel
        if not isinstance(pl, ParallelConfig):
            raise ConfigError("parallel must be a ParallelConfig")
        if pl.shards > 1 and self.n_peers % pl.shards != 0:
            raise ConfigError(
                f"parallel.shards={pl.shards} must divide n_peers "
                f"({self.n_peers}): the ragged exchange addresses "
                "destination shards as key // (n_peers // shards)")
        tl = self.telemetry
        if not isinstance(tl, TelemetryConfig):
            raise ConfigError("telemetry must be a TelemetryConfig")
        if tl.enabled and self.n_peers > MAX_TELEMETRY_PEERS:
            raise ConfigError(
                f"telemetry's byte-lane u64 sums are exact only up to "
                f"{MAX_TELEMETRY_PEERS} peers (got {self.n_peers})")
        if tl.flight_recorder > 0 and not fm.health_checks:
            raise ConfigError(
                "telemetry.flight_recorder records health-sentinel "
                "latches — it requires faults.health_checks=True")
        if self.identity_requests:
            if not self.identity_required:
                raise ConfigError("identity_requests without "
                                  "identity_required has nothing to ask "
                                  "for (no record ever parks on identity)")
            if not self.delay_enabled:
                raise ConfigError("identity_requests requires delay_inbox "
                                  "> 0 (identity-less records park in the "
                                  "pen; note the pen needs "
                                  "timeline_enabled)")
            if self.proof_inbox < 1:
                raise ConfigError("identity_requests shares the proof "
                                  "channel: proof_inbox must be >= 1")

    def replace(self, **kw) -> "CommunityConfig":
        return dataclasses.replace(self, **kw)
