"""The permission engine as a bounded grant table (port of
``dispersy_tpu/ops/timeline.py``).

Each peer holds ``[A]`` grant/revoke rows (member, per-meta permission
nibble mask, global time, revoke flag, issuer).  :func:`check` asks
whether a member holds one permission for a meta at a global time
(:func:`check_many` for up to three (meta, perm) pairs of one query);
:func:`check_grant` whether a member may issue a grant or revoke
covering a mask (the delegation-chain link test; :func:`check_grant_rev`
with the perm per query).  All four are wrappers: a CPU tensor takes the
plain version beside them, a CUDA tensor the hand-written kernel of
``csrc/timeline.cu`` (K8) or an error.

:func:`fold` (insert accepted authorize/revoke records, keeping the A
highest rows), :func:`revalidate` (re-walk every row's granting chain)
and :func:`fold_set` (the bounded blacklist insert) have no TPU-only
form in the JAX package; they run as plain PyTorch on both devices.
``fold`` and ``fold_set`` are loops over the batch, as the JAX
package's ``lax.fori_loop`` is.

u32 values are compared through int64 carriers (``u32.wide``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dispersy_tpu_torch import kernels
from dispersy_tpu_torch.config import (EMPTY_U32, MAX_TIMELINE_META,
                                       PERM_AUTHORIZE, PERM_PERMIT,
                                       PERM_REVOKE)
from dispersy_tpu_torch.u32 import bits, narrow, unbits, wide


class AuthTable(NamedTuple):
    """[N, A] grant/revoke rows; ``member == EMPTY_U32`` marks a free slot."""
    member: torch.Tensor  # u32[N, A]
    mask: torch.Tensor    # u32[N, A] per-meta permission nibbles
    gt: torch.Tensor      # u32[N, A]
    rev: torch.Tensor     # bool[N, A] True = revoke row
    issuer: torch.Tensor  # u32[N, A] member that signed the row


def _latest_row_verdict(match, row_gt, is_rev) -> torch.Tensor:
    """The highest-gt matching row decides; a revoke row beats a grant row
    at the same global time; no matching row means not held."""
    best = row_gt.amax(-1, keepdim=True)
    at_best = match & (row_gt == best)
    return ((at_best & ~is_rev).any(-1) & ~(at_best & is_rev).any(-1)
            & match.any(-1))


def _founder_u32(founder, like: torch.Tensor) -> torch.Tensor:
    """An int founder or a u32 founder column as an int64 carrier."""
    if isinstance(founder, torch.Tensor):
        return wide(founder)
    return torch.tensor(int(founder) & 0xFFFFFFFF, dtype=torch.int64,
                        device=like.device)


def check_plain(tab: AuthTable, member, meta, gt, founder,
                perm: int = PERM_PERMIT) -> torch.Tensor:
    """bool[N, Q]: does ``member`` hold ``perm`` for ``meta`` at ``gt``?"""
    tm, tk, tg = (wide(c)[:, None, :] for c in (tab.member, tab.mask,
                                                 tab.gt))
    qm, qt, qg = (wide(c)[:, :, None] for c in (member, meta, gt))
    in_range = qt < MAX_TIMELINE_META
    sh = torch.clamp(4 * qt + perm, max=31)
    bit = ((tk >> sh) & 1 == 1) & in_range
    match = (tm == qm) & (tm != EMPTY_U32) & bit & (tg <= qg)
    row_gt = torch.where(match, tg, 0)
    granted = _latest_row_verdict(match, row_gt, tab.rev[:, None, :])
    return granted | (wide(member) == _founder_u32(founder, member))


def check(tab: AuthTable, member, meta, gt, founder,
          perm: int = PERM_PERMIT) -> torch.Tensor:
    """bool[N, Q]: the latest grant/revoke row carrying bit
    ``4 * meta + perm`` for ``member`` at global time <= ``gt`` decides,
    revoke winning a tie; the founder (an int, or a u32 column
    broadcastable to [N, Q]) holds everything.  ``meta`` is u8 or u32;
    metas outside the nibble range (control ids, the 0xFFFF not-found
    sentinel) match no bit."""
    if member.device.type == "cpu":
        return check_plain(tab, member, meta, gt, founder, perm)
    return kernels.timeline_check(tab, member, meta, gt, founder, perm)


def check_many_plain(tab: AuthTable, member, keys_perms, gt,
                     founder) -> tuple:
    """:func:`check_plain` of each (meta, perm) pair of ``keys_perms``."""
    return tuple(check_plain(tab, member, meta, gt, founder, perm)
                 for meta, perm in keys_perms)


def check_many(tab: AuthTable, member, keys_perms, gt, founder) -> tuple:
    """A tuple of bool[N, Q]: :func:`check` of one (member, gt, founder)
    query for each of up to three (meta, perm) pairs of ``keys_perms``
    (each meta u8 or u32), one walk of the table on the card."""
    if member.device.type == "cpu":
        return check_many_plain(tab, member, keys_perms, gt, founder)
    return kernels.timeline_check_many(tab, member, keys_perms, gt, founder)


def check_grant_plain(tab: AuthTable, member, mask, gt, n_meta: int,
                      perm=PERM_AUTHORIZE) -> torch.Tensor:
    """bool[N, Q]: the JAX package's broadcast form.  ``perm`` is an int
    or an int64 [N, Q] column of one perm per query."""
    tm, tk, tg = (wide(c)[:, None, :] for c in (tab.member, tab.mask,
                                                 tab.gt))
    qm, qk, qg = wide(member), wide(mask), wide(gt)
    live = tm != EMPTY_U32
    base = live & (tm == qm[:, :, None]) & (tg <= qg[:, :, None])
    rev = tab.rev[:, None, :]
    if isinstance(perm, torch.Tensor):
        perm = perm[:, :, None]
    ok = qk != 0
    # Nibbles past bit 31 of a u32 mask are empty: they need nothing.
    for k in range(min(n_meta, MAX_TIMELINE_META)):
        need = ((qk >> (4 * k)) & 0xF) != 0
        match = base & (((tk >> (4 * k + perm)) & 1) == 1)
        granted = _latest_row_verdict(match, torch.where(match, tg, 0), rev)
        ok = ok & (~need | granted)
    return ok


def check_grant(tab: AuthTable, member, mask, gt, n_meta: int,
                perm: int = PERM_AUTHORIZE) -> torch.Tensor:
    """bool[N, Q]: may ``member`` issue a grant (``perm`` =
    PERM_AUTHORIZE) or revoke (PERM_REVOKE) covering ``mask`` at ``gt``?
    Every meta whose nibble in ``mask`` is non-empty needs the authority
    bit by the latest-wins rule of :func:`check`; an empty mask proves
    nothing.  The founder shortcut is the caller's."""
    if member.device.type == "cpu":
        return check_grant_plain(tab, member, mask, gt, n_meta, perm)
    return kernels.timeline_check_grant(tab, member, mask, gt, n_meta, perm)


def check_grant_rev_plain(tab: AuthTable, member, mask, gt, is_rev,
                          n_meta: int) -> torch.Tensor:
    """:func:`check_grant_plain` with REVOKE where ``is_rev`` is set and
    AUTHORIZE elsewhere."""
    shape = torch.broadcast_shapes(member.shape, mask.shape, gt.shape,
                                   is_rev.shape)
    perm = torch.where(torch.broadcast_to(is_rev, shape), PERM_REVOKE,
                       PERM_AUTHORIZE).to(torch.int64)
    return check_grant_plain(tab, member, mask, gt, n_meta, perm)


def check_grant_rev(tab: AuthTable, member, mask, gt, is_rev,
                    n_meta: int) -> torch.Tensor:
    """bool[N, Q]: :func:`check_grant` with the perm per query -- REVOKE
    where the bool ``is_rev`` is set, AUTHORIZE elsewhere; the same as
    ``torch.where(is_rev, check_grant(.., PERM_REVOKE), check_grant(..,
    PERM_AUTHORIZE))`` in one walk of the table on the card."""
    if member.device.type == "cpu":
        return check_grant_rev_plain(tab, member, mask, gt, is_rev, n_meta)
    return kernels.timeline_check_grant_rev(tab, member, mask, gt, is_rev,
                                            n_meta)


class FoldResult(NamedTuple):
    table: AuthTable
    n_dropped: torch.Tensor  # i32[N] new rows lost (keyed below the window)
    n_evicted: torch.Tensor  # i32[N] existing rows displaced


def _row_lt(a, b) -> torch.Tensor:
    """Lexicographic (gt, member, mask, rev, issuer) strict less-than of
    two row-key tuples (carriers, ``rev`` as int64)."""
    lt = torch.zeros_like(a[0] < b[0])
    eq = torch.ones_like(lt)
    for x, y in zip(a, b):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt


def fold(tab: AuthTable, target, mask, gt, is_revoke, valid,
         issuer) -> FoldResult:
    """Insert [N, B] accepted authorize/revoke records into each table,
    in batch order, idempotent per (issuer, member, mask, gt, revoke)
    row.  A full table keeps its A highest (gt, member, mask, rev,
    issuer) rows: an arriving row replaces the minimum row when it keys
    above it and is dropped otherwise; both losses are counted."""
    n, b = target.shape
    a = tab.member.shape[-1]
    dev = target.device
    is_revoke = torch.broadcast_to(torch.as_tensor(is_revoke, device=dev),
                                   (n, b))
    t_member, t_mask, t_gt, t_issuer = (
        wide(c) for c in (tab.member, tab.mask, tab.gt, tab.issuer))
    t_rev = tab.rev.to(torch.int64)
    c_tg, c_mk, c_g, c_isr = (wide(c) for c in (target, mask, gt, issuer))
    c_rv = is_revoke.to(torch.int64)
    dropped = torch.zeros(n, dtype=torch.int32, device=dev)
    evicted = torch.zeros(n, dtype=torch.int32, device=dev)
    slots = torch.arange(a, device=dev)
    rows = torch.arange(n, device=dev)
    big = torch.iinfo(torch.int64).max
    for i in range(b):
        new = (c_g[:, i:i + 1], c_tg[:, i:i + 1], c_mk[:, i:i + 1],
               c_rv[:, i:i + 1], c_isr[:, i:i + 1])
        cur = (t_gt, t_member, t_mask, t_rev, t_issuer)
        dup = ((t_member == new[1]) & (t_mask == new[2]) & (t_gt == new[0])
               & (t_rev == new[3]) & (t_issuer == new[4])).any(1)
        want = valid[:, i] & ~dup
        free = t_member == EMPTY_U32
        has_free = free.any(1)
        # The minimum live row by the total order: narrow the candidate
        # set key by key (the set of live rows keyed at the minimum).
        cand = ~free
        for key in cur:
            kmin = torch.where(cand, key, big).amin(1, keepdim=True)
            cand = cand & (key == kmin)
        min_slot = cand.to(torch.int8).argmax(1)
        at_min = tuple(k[rows, min_slot][:, None] for k in cur)
        new_above_min = _row_lt(at_min, new)[:, 0]
        slot = torch.where(has_free, free.to(torch.int8).argmax(1), min_slot)
        can = want & (has_free | new_above_min)
        hit = (slots[None, :] == slot[:, None]) & can[:, None]
        t_gt, t_member, t_mask, t_rev, t_issuer = (
            torch.where(hit, v, c) for v, c in zip(new, cur))
        dropped += (want & ~can).to(torch.int32)
        evicted += (can & ~has_free).to(torch.int32)
    table = AuthTable(member=narrow(t_member), mask=narrow(t_mask),
                      gt=narrow(t_gt), rev=t_rev.bool(),
                      issuer=narrow(t_issuer))
    return FoldResult(table=table, n_dropped=dropped, n_evicted=evicted)


def revalidate(tab: AuthTable, founder, n_meta: int) -> torch.Tensor:
    """bool[N, A]: the rows whose granting chain still checks out.  Each
    row is re-judged by whether its issuer held the AUTHORIZE bit (a
    grant) or the REVOKE bit (a revoke) for every meta of its mask at the
    row's global time, over the surviving rows, A times so invalidation
    unwinds transitively; a row never witnesses itself and
    founder-issued rows are axiomatic."""
    n, a = tab.member.shape
    dev = tab.member.device
    member, mask, gt, issuer = (wide(c) for c in (tab.member, tab.mask,
                                                   tab.gt, tab.issuer))
    live = member != EMPTY_U32
    by_founder = issuer == _founder_u32(founder, tab.member).reshape(-1, 1)
    permsel = torch.where(tab.rev, PERM_REVOKE, PERM_AUTHORIZE)  # [N, Ar]
    not_self = ~torch.eye(a, dtype=torch.bool, device=dev)[None]
    # [N, Ar, As]: row s names row r's issuer at or before r's gt.
    base = (not_self & (member[:, None, :] == issuer[:, :, None])
            & (gt[:, None, :] <= gt[:, :, None]))
    s_gt = gt[:, None, :].expand(n, a, a)
    s_rev = tab.rev[:, None, :]
    s_mask = mask[:, None, :]
    keep = live
    for _ in range(a):
        ok = mask != 0
        cand = base & keep[:, None, :]
        for k in range(min(n_meta, MAX_TIMELINE_META)):
            need = ((mask >> (4 * k)) & 0xF) != 0
            sh = (4 * k + permsel)[:, :, None]
            match = cand & (((s_mask >> sh) & 1) == 1)
            granted = _latest_row_verdict(match, torch.where(match, s_gt, 0),
                                          s_rev)
            ok = ok & (~need | granted)
        keep = live & (ok | by_founder)
    return keep


class SetFoldResult(NamedTuple):
    table: torch.Tensor       # u32[N, S] the updated member set
    n_inserted: torch.Tensor  # i32[N] members newly added
    n_dropped: torch.Tensor   # i32[N] members lost to a full table


def fold_set(tab, member, valid) -> SetFoldResult:
    """Insert [N, B] member ids (u32) into each row's bounded member set
    ``tab`` (u32 [N, S], ``EMPTY_U32`` free), in batch order: idempotent
    per member, first free slot, overflow counted."""
    n, b = member.shape
    dev = member.device
    t = bits(tab)
    mb_all = bits(member)
    slots = torch.arange(tab.shape[1], device=dev)
    inserted = torch.zeros(n, dtype=torch.int32, device=dev)
    dropped = torch.zeros(n, dtype=torch.int32, device=dev)
    for i in range(b):
        mb = mb_all[:, i:i + 1]
        want = valid[:, i] & ~(t == mb).any(1)
        free = t == -1
        can = want & free.any(1)
        slot = free.to(torch.int8).argmax(1)
        t = torch.where((slots[None, :] == slot[:, None]) & can[:, None],
                        mb, t)
        inserted += can.to(torch.int32)
        dropped += (want & ~can).to(torch.int32)
    return SetFoldResult(table=unbits(t, torch.uint32), n_inserted=inserted,
                         n_dropped=dropped)
