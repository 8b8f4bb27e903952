"""The bench shape (port of ``bench_config`` in ``dispersy_tpu/profiling.py``),
the permissioned and the hardened communities and the chaos round at
that shape, the schedules that drive them, and the card's profile of a
main path.

Only the config builder is ported: the JAX module's cost-analysis
helpers price XLA executables and have no counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from dispersy_tpu_torch.config import (DEFAULT_PRIORITY, EMPTY_U32,
                                       META_AUTHORIZE, META_DESTROY,
                                       META_DYNAMIC, META_IDENTITY,
                                       META_REVOKE, META_UNDO_OTHER,
                                       CommunityConfig, perm_bit)
from dispersy_tpu_torch.planes import (FaultModel, OverloadConfig,
                                       ParallelConfig, RecoveryConfig,
                                       StoreConfig)


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
    """Make the creates and plants of round ``rnd`` on a port state, in
    order (an undo-other's aux read from the state's own store rows)."""
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


def pin_gt(payload: np.ndarray, authors: np.ndarray, rows) -> np.ndarray:
    """uint32[N] aux of an undo-other call: for each author, the highest
    global time of a pin (meta 1) that its payload member holds in its
    own store, else 0.  ``rows(ids)`` returns the numpy
    ``(store_gt, store_member, store_meta)`` rows of those peers."""
    out = np.zeros(payload.shape[0], np.uint32)
    ids = np.flatnonzero(authors)
    if not ids.size:
        return out
    tgt = payload[ids].astype(np.int64)
    g, m, t = (np.asarray(a).astype(np.int64) for a in rows(tgt))
    own = (m == tgt[:, None]) & (t == PIN) & (g != EMPTY_U32)
    out[ids] = np.where(own, g, 0).max(axis=1)
    return out


# Every device function of the hand-written kernels (csrc/*.cu and
# kernels/intake_triton.py) is named with this prefix, which gives the
# profile's own-kernel share.
OWN_KERNEL_PREFIX = "dk_"


def profile_rounds(n_peers: int = 1 << 20, warmup: int = 3, rounds: int = 3,
                   seed: int = 0, top: int = 15, diet: bool = False,
                   timeline: bool = False, hardened: bool = False,
                   chaos: bool = False) -> dict:
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
    :func:`one_record_schedule`.  Reports wall time; device busy time (the sum
    of the device-side events' times -- the round runs on one stream);
    the share of it in the hand-written kernels; and the ``top`` entries
    by device time, both as PyTorch ops (host-side events, each charged
    the device time of its own kernels) and as device kernels.  Needs a
    CUDA card; the run is driven as ``chip_smoke.py``'s main path is.
    ``python -m dispersy_tpu_torch.profiling [--diet | --timeline |
    --hardened | --chaos]`` prints it as one JSON line."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dispersy_tpu_torch import engine
    from dispersy_tpu_torch.state import init_state
    from dispersy_tpu_torch.storediet import phase_of

    if diet + timeline + hardened + chaos > 1:
        raise ValueError("pick one of diet, timeline, hardened and chaos")
    if chaos:
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
    events = [e for e in prof.key_averages() if e.self_device_time_total]
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
        "phases": [phase_of(cfg, warmup + i) for i in range(rounds)],
        "wall_ms_per_round": wall_ms / rounds,
        "device_busy_ms_per_round": busy,
        "device_idle_share": 1.0 - busy * rounds / wall_ms,
        "own_kernel_ms_per_round": ms([e for e in device if own(e)]),
        "device_events_per_round": sum(e.count for e in device) / rounds,
        "top_ops": table(ops), "top_kernels": table(device),
    }


def delivery_cases(n_peers: int = 1 << 20, seed: int = 0) -> dict:
    """K1's and K12's call shapes in the rounds at ``n_peers`` peers, on
    random inputs made with a numpy seed on the card: ``{name: (kernel,
    plain, yardstick)}``, three functions of no argument -- the kernel's
    wrapper, its plain version and one ``torch.sort`` of the packed
    (destination, class, position) key that orders the same edges."""
    import torch

    from dispersy_tpu_torch import kernels
    from dispersy_tpu_torch.ops import inbox
    from dispersy_tpu_torch.ops import overload as ovo

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
    fm = chaos.faults
    e = (n * chaos.forward_buffer * chaos.forward_fanout
         + len(fm.flood_senders) * fm.flood_fanout)
    cols = [u32(e), u32(e), u8(e, 8), u32(e), u32(e),
            torch.from_numpy(rs.random(e) < 0.001).to(dev)]
    cls = ovo.admission_class(cols[2], chaos.n_meta,
                              chaos.priorities).to(torch.uint8)
    dst, valid = edges(e, n, 0.05)
    cases["cls_push"] = k1(dst, cols, valid, n, chaos.push_inbox, cls)
    cases["ragged_push_cls"] = k12(dst, cols, valid, chaos.push_inbox,
                                   chaos.parallel.cross_shard_budget, cls,
                                   False)
    return cases


def profile_delivery(n_peers: int = 1 << 20, reps: int = 20,
                     seed: int = 0) -> dict:
    """Each of :func:`delivery_cases` on the card: the kernel held bit
    for bit against its plain version once, then ``reps`` calls of the
    kernel and of its ``torch.sort`` yardstick timed with CUDA events
    (medians), and ``reps`` more kernel calls traced with
    ``torch.profiler``: the device time per call of each device function
    and memset of the call, and the device events per call (launches and
    memsets).  ``python -m dispersy_tpu_torch.profiling --delivery``
    prints it as one JSON line."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out]
        return [t for o in out for t in flat(o)]

    def same(a, b):
        a, b = flat(a), flat(b)
        return len(a) == len(b) and all(
            x.shape == y.shape and x.dtype == y.dtype and torch.equal(
                x.view(torch.uint8), y.view(torch.uint8))
            for x, y in zip(a, b))

    def cuda_ms(fn):
        for _ in range(3):
            fn()
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for a, b in evs:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in evs)

    out = {"n_peers": n_peers, "reps": reps,
           "device": torch.cuda.get_device_name(0), "cases": {}}
    for name, (kernel, plain, yardstick) in delivery_cases(
            n_peers, seed).items():
        if not same(kernel(), plain()):
            raise AssertionError(f"{name}: the kernel differs from its "
                                 "plain version")
        row = {"kernel_ms": cuda_ms(kernel), "sort_ms": cuda_ms(yardstick)}
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


if __name__ == "__main__":
    import argparse
    import json
    ap = argparse.ArgumentParser(description=profile_rounds.__doc__)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--delivery", action="store_true",
                       help="time and trace K1 and K12 at each call shape "
                       "of the 1M rounds (profile_delivery)")
    which.add_argument("--diet", action="store_true",
                       help="trace the byte-diet round of bench_config")
    which.add_argument("--timeline", action="store_true",
                       help="trace the permissioned round of "
                       "permissioned_config")
    which.add_argument("--hardened", action="store_true",
                       help="trace the hardened round of hardened_config")
    which.add_argument("--chaos", action="store_true",
                       help="trace the chaos round of chaos_config")
    args = ap.parse_args()
    if args.delivery:
        print(json.dumps(profile_delivery()))
        raise SystemExit(0)
    print(json.dumps(profile_rounds(diet=args.diet, timeline=args.timeline,
                                    hardened=args.hardened, chaos=args.chaos,
                                    rounds=5 if args.timeline else 3)))
