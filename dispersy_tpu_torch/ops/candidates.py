"""Candidate-table ops: peer bookkeeping and walk-target sampling (port of
``dispersy_tpu/ops/candidates.py``).

A fixed ``[N, K]`` slot table per peer (peer index + three f32
timestamps); a slot's category is derived from timestamp freshness each
round; sampling uses hashed per-slot priorities, so choices replay the
JAX package's bit for bit.  No TPU-only form exists here: plain PyTorch
on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dispersy_tpu_torch.config import (CAT_INTRODUCED, CAT_NONE,
                                       CAT_STUMBLED, CAT_WALKED, NO_PEER,
                                       CommunityConfig)
from dispersy_tpu_torch.ops import rng

KIND_WALK = 0
KIND_STUMBLE = 1
KIND_INTRO = 2
_NEVER = -1.0e9


class CandTable(NamedTuple):
    """[N, K] candidate slots; ``peer == NO_PEER`` marks an empty slot."""
    peer: torch.Tensor          # i32[N, K]
    last_walk: torch.Tensor     # f32[N, K]
    last_stumble: torch.Tensor  # f32[N, K]
    last_intro: torch.Tensor    # f32[N, K]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def categories(tab: CandTable, now: torch.Tensor,
               cfg: CommunityConfig) -> torch.Tensor:
    """i32[N, K] category, precedence walked > stumbled > introduced."""
    occupied = tab.peer != NO_PEER
    wl = _f32(cfg.walk_lifetime, now)
    walked = occupied & (now - tab.last_walk < wl)
    stumbled = occupied & (now - tab.last_stumble < wl)
    intro = occupied & (now - tab.last_intro < _f32(cfg.intro_lifetime, now))
    out = torch.full(tab.peer.shape, CAT_NONE, dtype=torch.int32,
                     device=now.device)
    out = torch.where(intro, CAT_INTRODUCED, out)
    out = torch.where(stumbled, CAT_STUMBLED, out)
    return torch.where(walked, CAT_WALKED, out).to(torch.int32)


def is_eligible(tab: CandTable, cats: torch.Tensor, now: torch.Tensor,
                cfg: CommunityConfig) -> torch.Tensor:
    cooled = now - tab.last_walk >= _f32(cfg.eligibility_delay, now)
    return (cats != CAT_NONE) & cooled


def _activity(tab: CandTable) -> torch.Tensor:
    act = torch.maximum(tab.last_walk,
                        torch.maximum(tab.last_stumble, tab.last_intro))
    return torch.where(tab.peer == NO_PEER, _f32(_NEVER * 2.0, act), act)


def upsert_many(tab: CandTable, upd_peer: torch.Tensor,
                upd_kind: torch.Tensor, upd_valid: torch.Tensor,
                now: torch.Tensor, self_idx: torch.Tensor,
                n_trackers: int = 0) -> CandTable:
    """Apply ``[N, U]`` observations in order: refresh an existing entry's
    timestamp, else insert into the least-recently-active slot; the owner
    itself and trackers are ignored."""
    upd_valid = (upd_valid & (upd_peer != NO_PEER)
                 & (upd_peer != self_idx[:, None])
                 & (upd_peer >= n_trackers))
    k = tab.peer.shape[1]
    kk = torch.arange(k, device=now.device)[None, :]
    never = _f32(_NEVER, now)
    t = tab
    for i in range(upd_peer.shape[-1]):
        p = upd_peer[:, i:i + 1]
        kind = upd_kind[:, i:i + 1]
        ok = upd_valid[:, i:i + 1]
        match = (t.peer == p) & ok
        have = match.any(dim=1, keepdim=True)
        victim = torch.argmin(_activity(t), dim=1)
        insert = (kk == victim[:, None]) & ok & ~have
        hit = match | insert
        new_peer = torch.where(insert, p, t.peer)

        def stamp(ts, kd):
            cleared = torch.where(insert, never, ts)
            return torch.where(hit & (kind == kd), now, cleared)

        t = CandTable(peer=new_peer,
                      last_walk=stamp(t.last_walk, KIND_WALK),
                      last_stumble=stamp(t.last_stumble, KIND_STUMBLE),
                      last_intro=stamp(t.last_intro, KIND_INTRO))
    return t


def remove(tab: CandTable, peer: torch.Tensor,
           valid: torch.Tensor) -> CandTable:
    """Drop one candidate per row (walk-timeout eviction)."""
    kill = (tab.peer == peer[:, None]) & valid[:, None]
    never = _f32(_NEVER, tab.last_walk)
    return CandTable(
        peer=torch.where(kill, NO_PEER, tab.peer),
        last_walk=torch.where(kill, never, tab.last_walk),
        last_stumble=torch.where(kill, never, tab.last_stumble),
        last_intro=torch.where(kill, never, tab.last_intro))


def _score(mask: torch.Tensor, prio: torch.Tensor) -> torch.Tensor:
    """Mask in bit 31 over the top 31 bits of the hashed priority."""
    return (prio >> 1) | (mask.to(torch.int64) << 31)


def _pick_by_priority(mask, prio) -> torch.Tensor:
    """Index of the max-priority True slot per row (lowest index on a
    tie, as ``argmax``); -1 if none."""
    best = torch.argmax(_score(mask, prio), dim=1)
    return torch.where(mask.any(dim=1), best, -1)


def sample_walk_target(tab: CandTable, now: torch.Tensor,
                       cfg: CommunityConfig, seed, round_index,
                       self_idx: torch.Tensor, boot_base: torch.Tensor,
                       boot_count: torch.Tensor) -> torch.Tensor:
    """One walk destination per peer (``dispersy_get_walk_candidate``):
    category by one uniform draw with cyclic fall-through, slot by hashed
    priority, bootstrap to a random own-community tracker.  i32[N]."""
    n, k = tab.peer.shape
    dev = now.device
    cats = categories(tab, now, cfg)
    elig = is_eligible(tab, cats, now, cfg)
    prio = rng.rand_u32(seed, round_index, self_idx[:, None], rng.P_SLOT,
                        torch.arange(k, device=dev)[None, :])
    picks = []
    for cat in (CAT_WALKED, CAT_STUMBLED, CAT_INTRODUCED):
        slot = _pick_by_priority(elig & (cats == cat), prio)
        got = torch.gather(tab.peer, 1, slot.clamp(min=0)[:, None])[:, 0]
        picks.append(torch.where(slot >= 0, got, NO_PEER))
    if cfg.n_trackers > 0:
        bb = boot_base.to(torch.int64)
        bc = torch.clamp(boot_count.to(torch.int64), min=1)
        si = self_idx.to(torch.int64)
        tt = bb + rng.rand_u32(seed, round_index, self_idx,
                               rng.P_BOOTSTRAP) % bc
        tt = torch.where(tt == si, bb + (tt - bb + 1) % bc, tt)
        boot = torch.where((tt == si) | (boot_count == 0), NO_PEER, tt)
    else:
        boot = torch.full((n,), NO_PEER, dtype=torch.int64, device=dev)
    picks.append(boot)
    r = rng.rand_uniform(seed, round_index, self_idx, rng.P_CATEGORY)
    p0 = _f32(cfg.p_revisit_walked, r)
    p1 = _f32(cfg.p_revisit_walked + cfg.p_stumbled, r)
    p2 = _f32(1.0 - cfg.p_bootstrap, r)
    c0 = torch.where(r < p0, 0, torch.where(r < p1, 1,
                                            torch.where(r < p2, 2, 3)))
    stacked = torch.stack([p.to(torch.int64) for p in picks], 0)  # [4, N]
    order = (c0[None, :] + torch.arange(4, device=dev)[:, None]) % 4
    rotated = torch.gather(stacked, 0, order)
    avail = rotated != NO_PEER
    first = torch.argmax(avail.to(torch.int32), dim=0)
    target = torch.gather(rotated, 0, first[None, :])[0]
    return torch.where(avail.any(0), target, NO_PEER).to(torch.int32)


def sample_forward_targets(tab: CandTable, now: torch.Tensor,
                           cfg: CommunityConfig, seed, round_index,
                           self_idx: torch.Tensor) -> torch.Tensor:
    """``forward_fanout`` distinct verified candidates per peer: top-C of
    hashed slot priorities (ties to the lower slot, as ``lax.top_k``).
    i32[N, C], NO_PEER-filled."""
    n, k = tab.peer.shape
    c = cfg.forward_fanout
    dev = now.device
    cats = categories(tab, now, cfg)
    verified = (cats == CAT_WALKED) | (cats == CAT_STUMBLED)
    slots = torch.arange(k, device=dev)[None, :]
    prio = rng.rand_u32(seed, round_index, self_idx[:, None], rng.P_GOSSIP,
                        slots + (1 << 8))
    score = _score(verified, prio)
    # Unique keys: a lower slot wins a score tie.
    top = torch.topk(score * k + (k - 1 - slots), c, dim=1).values
    top_slots = (k - 1) - top % k
    picked = torch.gather(tab.peer, 1, top_slots)
    ok = ((top // k) >> 31) == 1
    return torch.where(ok, picked, NO_PEER).to(torch.int32)


def sample_introductions(tab: CandTable, now: torch.Tensor,
                         cfg: CommunityConfig, seed, round_index,
                         self_idx: torch.Tensor, exclude: torch.Tensor,
                         salt_base: int = 0, req_sym=None,
                         slot_sym=None) -> torch.Tensor:
    """Third-peer picks for a batch of introduction responses: a uniformly
    random verified candidate other than the requester, one independent
    draw per request slot.  i32[N, S], NO_PEER where nobody qualifies.
    ``req_sym`` (bool[N, S]) and ``slot_sym`` (bool[N, K]), when given,
    are the symmetric-NAT flags of the requesters and of the table's
    candidates: a symmetric requester is never introduced to a symmetric
    candidate (two such NATs cannot hole-punch)."""
    n, k = tab.peer.shape
    s = exclude.shape[1]
    dev = now.device
    cats = categories(tab, now, cfg)
    verified = (cats == CAT_WALKED) | (cats == CAT_STUMBLED)
    mask = verified[:, None, :] & (tab.peer[:, None, :] != exclude[:, :, None])
    if req_sym is not None:
        mask = mask & ~(req_sym[:, :, None] & slot_sym[:, None, :])
    salt = (torch.arange(s, device=dev)[:, None] * k
            + torch.arange(k, device=dev)[None, :] + salt_base)
    prio = rng.rand_u32(seed, round_index, self_idx[:, None, None],
                        rng.P_INTRO, salt[None, :, :])
    best = torch.argmax(_score(mask, prio), dim=-1)
    pick = torch.gather(tab.peer[:, None, :].expand(n, s, k), 2,
                        best[:, :, None])[..., 0]
    return torch.where(mask.any(-1), pick, NO_PEER).to(torch.int32)
