"""PeerState: the whole overlay as dense per-peer tensors (port of
``dispersy_tpu/state.py``).

Every leaf keeps the JAX package's name, dtype (``torch.uint32``,
``uint16``, ``uint8``, ``int32``, ``float32``, ``bool``) and shape,
zero-width where a plane is compiled out, so :mod:`bridge` carries a
state across exactly and a 1M-peer state has the JAX package's layout.
"""

from __future__ import annotations

import dataclasses

import torch

from dispersy_tpu_torch.config import (EMPTY_META, EMPTY_U32, NO_PEER,
                                       CommunityConfig)
from dispersy_tpu_torch.planes import NUM_HEALTH_BITS
from dispersy_tpu_torch.telemetry import FLIGHT_WIDTH, row_width
from dispersy_tpu_torch.traceplane import NUM_CHANNELS
from dispersy_tpu_torch.u32 import bits, full_u32, narrow, unbits, zeros

NEVER = -1.0e9  # "timestamp never happened" for float32 sim-seconds fields
FLAG_UNDONE = 1


def resolve_device(device) -> torch.device:
    """The entry points' device rule: ``"cuda"`` unless the caller asks for
    the CPU, and never a silent fallback when the card is missing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev


class _Tree:
    """``replace`` and ordered leaf access for the state dataclasses."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def items(self):
        for f in dataclasses.fields(self):
            yield f.name, getattr(self, f.name)


@dataclasses.dataclass
class Stats(_Tree):
    """Per-peer counters (reference: statistics.py DispersyStatistics)."""
    walk_success: torch.Tensor
    walk_fail: torch.Tensor
    msgs_stored: torch.Tensor
    msgs_dropped: torch.Tensor
    requests_dropped: torch.Tensor
    punctures: torch.Tensor
    msgs_forwarded: torch.Tensor
    msgs_rejected: torch.Tensor
    msgs_direct: torch.Tensor
    msgs_delayed: torch.Tensor
    msgs_corrupt_dropped: torch.Tensor
    msgs_shed_rate: torch.Tensor
    msgs_shed_priority: torch.Tensor
    xshard_shed: torch.Tensor
    trace_delivered: torch.Tensor
    trace_dup: torch.Tensor
    recov_soft: torch.Tensor
    recov_backoff: torch.Tensor
    recov_quarantine: torch.Tensor
    recov_cleared: torch.Tensor
    proof_requests: torch.Tensor
    proof_records: torch.Tensor
    seq_requests: torch.Tensor
    seq_records: torch.Tensor
    mm_requests: torch.Tensor
    mm_records: torch.Tensor
    id_requests: torch.Tensor
    id_records: torch.Tensor
    sig_signed: torch.Tensor
    sig_done: torch.Tensor
    sig_expired: torch.Tensor
    conflicts: torch.Tensor
    convictions_rx: torch.Tensor
    auth_unwound: torch.Tensor
    msgs_retro: torch.Tensor
    bytes_up: torch.Tensor
    bytes_down: torch.Tensor
    accepted_by_meta: torch.Tensor


@dataclasses.dataclass
class PeerState(_Tree):
    """Field order and meaning as ``dispersy_tpu.state.PeerState``."""
    alive: torch.Tensor
    loaded: torch.Tensor
    is_tracker: torch.Tensor
    session: torch.Tensor
    global_time: torch.Tensor
    health: torch.Tensor
    ge_bad: torch.Tensor
    backoff: torch.Tensor
    quar_until: torch.Tensor
    repair_round: torch.Tensor
    bucket: torch.Tensor
    walk_streak: torch.Tensor
    tele_row: torch.Tensor
    tele_ring: torch.Tensor
    fr_ring: torch.Tensor
    fr_pos: torch.Tensor
    trace_member: torch.Tensor
    trace_gt: torch.Tensor
    trace_first: torch.Tensor
    trace_chan: torch.Tensor
    trace_dups: torch.Tensor
    trace_latch: torch.Tensor
    cand_peer: torch.Tensor
    cand_last_walk: torch.Tensor
    cand_last_stumble: torch.Tensor
    cand_last_intro: torch.Tensor
    store_gt: torch.Tensor
    store_member: torch.Tensor
    store_meta: torch.Tensor
    store_payload: torch.Tensor
    store_aux: torch.Tensor
    store_flags: torch.Tensor
    sta_gt: torch.Tensor
    sta_member: torch.Tensor
    sta_meta: torch.Tensor
    sta_payload: torch.Tensor
    sta_aux: torch.Tensor
    sta_flags: torch.Tensor
    digest: torch.Tensor
    cohort: torch.Tensor
    epoch: torch.Tensor
    fwd_gt: torch.Tensor
    fwd_member: torch.Tensor
    fwd_meta: torch.Tensor
    fwd_payload: torch.Tensor
    fwd_aux: torch.Tensor
    auth_member: torch.Tensor
    auth_mask: torch.Tensor
    auth_gt: torch.Tensor
    auth_rev: torch.Tensor
    auth_issuer: torch.Tensor
    mal_member: torch.Tensor
    dly_gt: torch.Tensor
    dly_member: torch.Tensor
    dly_meta: torch.Tensor
    dly_payload: torch.Tensor
    dly_aux: torch.Tensor
    dly_since: torch.Tensor
    dly_src: torch.Tensor
    sig_target: torch.Tensor
    sig_meta: torch.Tensor
    sig_payload: torch.Tensor
    sig_gt: torch.Tensor
    sig_since: torch.Tensor
    stats: Stats
    key: torch.Tensor
    time: torch.Tensor
    round_index: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.alive.device


def stats_gates(config: CommunityConfig) -> dict:
    """Which feature-gated ``Stats`` counters are full ``[N]`` width."""
    return {
        "msgs_rejected": (config.timeline_enabled
                          or bool(config.seq_meta_mask)
                          or config.identity_required
                          or config.malicious_enabled),
        "msgs_direct": bool(config.direct_meta_mask),
        "msgs_delayed": config.delay_enabled,
        "proof_requests": config.proof_requests,
        "proof_records": config.proof_requests,
        "seq_requests": config.seq_requests,
        "seq_records": config.seq_requests,
        "mm_requests": config.msg_requests,
        "mm_records": config.msg_requests,
        "id_requests": config.identity_requests,
        "id_records": config.identity_requests,
        "sig_signed": bool(config.double_meta_mask),
        "sig_done": bool(config.double_meta_mask),
        "sig_expired": bool(config.double_meta_mask),
        "conflicts": config.malicious_enabled,
        "convictions_rx": config.malicious_enabled,
        "auth_unwound": config.timeline_enabled,
        "msgs_retro": config.timeline_enabled,
        "xshard_shed": (config.parallel.shards > 1
                        and config.parallel.cross_shard_budget > 0),
    }


def init_stats(config: CommunityConfig, device) -> Stats:
    n, n_meta = config.n_peers, config.n_meta
    n_corrupt = n if (config.faults.corrupt_rate > 0.0
                      or config.faults.flood_enabled) else 0
    n_recov = n if config.recovery.enabled else 0
    n_overload = n if config.overload.enabled else 0
    n_trace = n if config.trace.enabled else 0
    gates = stats_gates(config)

    def z(*shape):
        return zeros(shape, torch.uint32, device)

    kw = {name: z(n if on else 0) for name, on in gates.items()}
    return Stats(walk_success=z(n), walk_fail=z(n), msgs_stored=z(n),
                 msgs_dropped=z(n), requests_dropped=z(n), punctures=z(n),
                 msgs_forwarded=z(n), msgs_corrupt_dropped=z(n_corrupt),
                 msgs_shed_rate=z(n_overload),
                 msgs_shed_priority=z(n_overload),
                 trace_delivered=z(n_trace, NUM_CHANNELS),
                 trace_dup=z(n_trace, NUM_CHANNELS),
                 recov_soft=z(n_recov), recov_backoff=z(n_recov),
                 recov_quarantine=z(n_recov),
                 recov_cleared=z(n_recov, NUM_HEALTH_BITS),
                 bytes_up=z(n), bytes_down=z(n),
                 accepted_by_meta=z(n, n_meta + 1), **kw)


def seed_key(seed: int) -> list:
    """The u32 pair ``jax.random.key_data(jax.random.PRNGKey(seed))`` holds
    for the default threefry key with 64-bit mode off (the JAX package's
    setting): ``[0, seed mod 2^32]``."""
    return [0, int(seed) & 0xFFFFFFFF]


def init_state(config: CommunityConfig, seed: int = 0,
               device="cuda") -> PeerState:
    """Fresh overlay: everyone alive, empty stores, empty candidate tables.

    Equal leaf for leaf to ``dispersy_tpu.state.init_state(config,
    jax.random.PRNGKey(seed))``.
    """
    dev = resolve_device(device)
    n, k, m = config.n_peers, config.k_candidates, config.msg_capacity
    f = config.forward_buffer
    a = config.k_authorized if config.timeline_enabled else 0
    km = config.k_malicious if config.malicious_enabled else 0
    ns = n if config.double_meta_mask else 0
    s_w = config.store.staging
    d_w = config.bloom_words if (config.store_diet
                                 and config.sync_enabled) else 0
    t_w = config.trace.tracked_slots if config.trace.enabled else 0
    aux_dt = torch.uint16 if config.aux_dtype == "uint16" else torch.uint32
    aux_empty = 0xFFFF if aux_dt == torch.uint16 else EMPTY_U32
    st_n = n if config.store_stagger else 0
    dl = config.delay_inbox
    rw = row_width(config)

    def u32(shape, v=0):
        return full_u32(shape, v, dev)

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    def meta(shape):
        return torch.full(shape, EMPTY_META, dtype=torch.uint8, device=dev)

    def aux(shape, v):
        if aux_dt == torch.uint16:
            return torch.full(shape, v - (1 << 16) if v >= (1 << 15) else v,
                              dtype=torch.int16, device=dev).view(
                                  torch.uint16)
        return u32(shape, v)

    def never():
        if config.store.cand_bits == 16:
            return zeros((n, k), torch.uint16, dev)
        return torch.full((n, k), NEVER, dtype=torch.float32, device=dev)

    def no_peer(shape):
        return torch.full(shape, NO_PEER, dtype=torch.int32, device=dev)

    idx = torch.arange(n, device=dev)
    return PeerState(
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        loaded=torch.ones(n, dtype=torch.bool, device=dev),
        is_tracker=idx < config.n_trackers,
        session=u32((n,)),
        global_time=u32((n,), 1),
        health=u32((n if config.faults.health_checks else 0,)),
        ge_bad=z((n if config.faults.ge_enabled else 0,), torch.bool),
        backoff=z((n if config.recovery.enabled else 0,), torch.uint8),
        quar_until=u32((n if config.recovery.enabled else 0,)),
        repair_round=u32((n if config.recovery.enabled else 0,)),
        bucket=z((n if config.overload.enabled else 0,), torch.uint8),
        walk_streak=u32((n if config.telemetry.histograms else 0,)),
        tele_row=u32((rw,)),
        tele_ring=u32((config.telemetry.history, rw)),
        fr_ring=u32((config.telemetry.flight_recorder, FLIGHT_WIDTH)),
        fr_pos=u32((1 if config.telemetry.flight_recorder else 0,)),
        trace_member=u32((t_w,), EMPTY_U32),
        trace_gt=u32((t_w,), EMPTY_U32),
        trace_first=u32((n if t_w else 0, t_w)),
        trace_chan=z((n if t_w else 0, t_w), torch.uint8),
        trace_dups=u32((n if t_w else 0, t_w)),
        trace_latch=u32((t_w, 3)),
        cand_peer=no_peer((n, k)),
        cand_last_walk=never(),
        cand_last_stumble=never(),
        cand_last_intro=never(),
        store_gt=u32((n, m), EMPTY_U32),
        store_member=u32((n, m), EMPTY_U32),
        store_meta=meta((n, m)),
        store_payload=u32((n, m), EMPTY_U32),
        store_aux=aux((n, m), 0),
        store_flags=z((n, m), torch.uint8),
        sta_gt=u32((n, s_w), EMPTY_U32),
        sta_member=u32((n, s_w), EMPTY_U32),
        sta_meta=meta((n, s_w)),
        sta_payload=u32((n, s_w), EMPTY_U32),
        sta_aux=aux((n, s_w), 0),
        sta_flags=z((n, s_w), torch.uint8),
        digest=u32((n if d_w else 0, d_w)),
        cohort=(idx[:st_n] % config.store.cohorts).to(torch.int16).view(
            torch.uint16),
        epoch=u32((st_n,)),
        fwd_gt=u32((n, f), EMPTY_U32),
        fwd_member=u32((n, f), EMPTY_U32),
        fwd_meta=meta((n, f)),
        fwd_payload=u32((n, f), EMPTY_U32),
        fwd_aux=aux((n, f), aux_empty),
        dly_gt=u32((n, dl), EMPTY_U32),
        dly_member=u32((n, dl), EMPTY_U32),
        dly_meta=meta((n, dl)),
        dly_payload=u32((n, dl), EMPTY_U32),
        dly_aux=u32((n, dl)),
        dly_since=u32((n, dl)),
        dly_src=no_peer((n, dl)),
        auth_member=u32((n, a), EMPTY_U32),
        auth_mask=u32((n, a)),
        auth_gt=u32((n, a)),
        auth_rev=z((n, a), torch.bool),
        auth_issuer=u32((n, a), EMPTY_U32),
        mal_member=u32((n, km), EMPTY_U32),
        sig_target=no_peer((ns,)),
        sig_meta=u32((ns,)),
        sig_payload=u32((ns,)),
        sig_gt=u32((ns,)),
        sig_since=u32((ns,)),
        stats=init_stats(config, dev),
        key=narrow(torch.tensor(seed_key(seed), dtype=torch.int64,
                                device=dev)),
        time=torch.zeros((), dtype=torch.float32, device=dev),
        round_index=u32(()),
    )


# Every PeerState leaf's wipe class (a copy of the JAX package's
# inventory): "lifecycle" (alive / loaded), "identity" (structural, kept
# by rebirth, unload and restart), "process" (per-process bookkeeping),
# "clock" (reset by rebirth), "disk" (the database: kept by unload,
# wiped with the store by a wiped-disk rebirth), "instance" (community-
# instance memory, wiped by rebirth and by unload; the second element
# names the fill), "stats" (kept like the counters) and "global"
# (leaves with no per-peer row).
WIPE_INVENTORY: dict = {
    "alive": ("lifecycle", None),
    "loaded": ("lifecycle", None),
    "is_tracker": ("identity", None),
    "session": ("clock", None),
    "global_time": ("clock", None),
    "health": ("process", None),
    "ge_bad": ("identity", None),
    "backoff": ("process", None),
    "quar_until": ("identity", None),
    "repair_round": ("process", None),
    "bucket": ("identity", None),
    "walk_streak": ("stats", None),
    "tele_row": ("global", None),
    "tele_ring": ("global", None),
    "fr_ring": ("global", None),
    "fr_pos": ("global", None),
    "trace_member": ("global", None),
    "trace_gt": ("global", None),
    "trace_first": ("disk", None),
    "trace_chan": ("disk", None),
    "trace_dups": ("disk", None),
    "trace_latch": ("global", None),
    "cand_peer": ("instance", "no_peer"),
    "cand_last_walk": ("instance", "never"),
    "cand_last_stumble": ("instance", "never"),
    "cand_last_intro": ("instance", "never"),
    "store_gt": ("disk", None),
    "store_member": ("disk", None),
    "store_meta": ("disk", None),
    "store_payload": ("disk", None),
    "store_aux": ("disk", None),
    "store_flags": ("disk", None),
    "sta_gt": ("disk", None),
    "sta_member": ("disk", None),
    "sta_meta": ("disk", None),
    "sta_payload": ("disk", None),
    "sta_aux": ("disk", None),
    "sta_flags": ("disk", None),
    "digest": ("disk", None),
    "cohort": ("identity", None),   # idx % cohorts — structural, like
    #   is_tracker: rebirth/unload/restart all keep it
    "epoch": ("disk", None),        # wiped with the store by rebirth and
    #   immediately RE-DERIVED from (round, cohort) in the same block
    #   (engine._rebirth_wipe): the reborn peer rejoins the fleet cadence
    #   at the epoch every surviving peer already attributes to it
    "fwd_gt": ("instance", "empty"),
    "fwd_member": ("instance", "empty"),
    "fwd_meta": ("instance", "empty"),
    "fwd_payload": ("instance", "empty"),
    "fwd_aux": ("instance", "empty"),
    "auth_member": ("disk", None),
    "auth_mask": ("disk", None),
    "auth_gt": ("disk", None),
    "auth_rev": ("disk", None),
    "auth_issuer": ("disk", None),
    "mal_member": ("instance", "empty"),
    "dly_gt": ("instance", "empty"),
    "dly_member": ("instance", "empty"),
    "dly_meta": ("instance", "empty"),
    "dly_payload": ("instance", "empty"),
    "dly_aux": ("instance", "zero"),
    "dly_since": ("instance", "zero"),
    "dly_src": ("instance", "no_peer"),
    "sig_target": ("instance", "no_peer"),
    "sig_meta": ("instance", "zero"),
    "sig_payload": ("instance", "zero"),
    "sig_gt": ("instance", "zero"),
    "sig_since": ("instance", "zero"),
    "key": ("global", None),
    "time": ("global", None),
    "round_index": ("global", None),
}

# The "instance" rows of WIPE_INVENTORY with their fill kinds: what
# engine.unload_members and checkpoint._wipe_ephemeral wipe.
INSTANCE_MEMORY_FIELDS: tuple = tuple(
    (name, fill) for name, (cls, fill) in WIPE_INVENTORY.items()
    if cls == "instance")


def wipe_instance_memory(state: PeerState, mask: torch.Tensor) -> PeerState:
    """Every :data:`INSTANCE_MEMORY_FIELDS` leaf filled with its empty
    value on the rows of ``mask`` (bool [N]), the other rows untouched.
    ``"empty"`` is the all-ones word of the column's own dtype,
    ``"never"`` the f32 ``NEVER`` or 0 in the u16 stamp columns,
    ``"no_peer"`` ``NO_PEER``; a zero-width plane leaf is skipped."""
    n = mask.shape[0]
    updates = {}
    for name, kind in INSTANCE_MEMORY_FIELDS:
        arr = getattr(state, name)
        if arr.dim() >= 1 and arr.shape[0] != n:
            continue
        m = mask.to(arr.device).reshape((n,) + (1,) * (arr.dim() - 1))
        # torch.where has no u32 / u16 form on the card: the signed view.
        view = bits(arr)
        if kind == "empty":
            fill = -1 if view is not arr else torch.iinfo(arr.dtype).max
        elif kind == "never":
            fill = NEVER if arr.is_floating_point() else 0
        elif kind == "no_peer":
            fill = NO_PEER
        else:
            fill = 0
        updates[name] = unbits(torch.where(m, torch.full(
            (), fill, dtype=view.dtype, device=arr.device), view), arr.dtype)
    return state.replace(**updates)
