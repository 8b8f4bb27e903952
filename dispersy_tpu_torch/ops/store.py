"""Message-store ops: the SQLite ``sync`` table as a sorted ring (port of
``dispersy_tpu/ops/store.py``).

Each peer owns ``msg_capacity`` record slots kept sorted by (global_time,
member) with ``EMPTY_U32`` holes at the end.  Columns keep their schema
dtypes (u32 gt/member/payload, u8 meta/flags, and an aux column that is
u32, or u16 under the byte-diet store's ``aux_bits=16``).

:func:`store_insert`, :func:`rank_compact_many` and :func:`store_stage`
are wrappers: a CPU tensor takes the plain PyTorch version beside them, a
CUDA tensor the hand-written kernel (``csrc/store.cu``,
``csrc/compact.cu``, ``csrc/stage.cu``) or an error.
:func:`cohort_take`, :func:`cohort_put` and :func:`cohort_set` move a cohort's row block of
the staggered store; they compute nothing and need no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dispersy_tpu_torch import kernels
from dispersy_tpu_torch.config import EMPTY_U32
from dispersy_tpu_torch.u32 import bits, cast, unbits, wide


def empty_of(dtype) -> int:
    """Empty-slot sentinel of a record-column dtype: its all-ones value."""
    return {torch.uint32: 0xFFFFFFFF, torch.uint16: 0xFFFF,
            torch.uint8: 0xFF, torch.int32: -1, torch.bool: True}[dtype]


class StoreCols(NamedTuple):
    """One peer-store (or record batch): same-shaped columns."""
    gt: torch.Tensor
    member: torch.Tensor
    meta: torch.Tensor
    payload: torch.Tensor
    aux: torch.Tensor
    flags: torch.Tensor

    @property
    def valid(self) -> torch.Tensor:
        return bits(self.gt) != -1


def empty_records(shape, aux_dtype, device) -> StoreCols:
    """Empty record columns of ``shape`` (``aux`` in ``aux_dtype``)."""
    return StoreCols(*(unbits(fill_bits(shape, f, dt, device), dt)
                       for f, dt in ((EMPTY_U32, torch.uint32),
                                     (EMPTY_U32, torch.uint32),
                                     (0xFF, torch.uint8),
                                     (EMPTY_U32, torch.uint32),
                                     (0, aux_dtype), (0, torch.uint8))))


def count_valid(gt: torch.Tensor) -> torch.Tensor:
    """i32[N]: live records per row."""
    return (bits(gt) != -1).sum(-1, dtype=torch.int32)


def fill_bits(shape, fill, dtype, device) -> torch.Tensor:
    """A ``fill``-valued tensor of ``dtype``, in its :func:`bits` view."""
    if dtype == torch.uint32:
        fill = fill - (1 << 32) if fill >= (1 << 31) else fill
        return torch.full(shape, fill, dtype=torch.int32, device=device)
    if dtype == torch.uint16:
        fill = fill - (1 << 16) if fill >= (1 << 15) else fill
        return torch.full(shape, fill, dtype=torch.int16, device=device)
    return torch.full(shape, fill, dtype=dtype, device=device)


def rank_compact(col: torch.Tensor, slot: torch.Tensor, width: int,
                 fill) -> torch.Tensor:
    """Keep entries whose ``slot`` < ``width`` at that slot of a fresh
    ``fill`` row (plain form; slots below ``width`` are unique per row)."""
    n = col.shape[0]
    out = fill_bits((n, width + 1), fill, col.dtype, col.device)
    sl = torch.where((slot >= 0) & (slot < width), slot.to(torch.int64),
                     width)
    out.scatter_(1, sl, bits(col))
    return unbits(out[:, :width].contiguous(), col.dtype)


def rank_compact_many_plain(cols_fills, slot: torch.Tensor,
                            width: int) -> list:
    return [rank_compact(c, slot, width, f) for c, f in cols_fills]


def rank_compact_many(cols_fills, slot: torch.Tensor, width: int) -> list:
    """:func:`rank_compact` for several same-shaped columns sharing one
    ``slot`` map — ``cols_fills`` is ``[(col, fill), ...]``."""
    if slot.device.type == "cpu":
        return rank_compact_many_plain(cols_fills, slot, width)
    if width == 0:
        return [c[:, :0] for c, _ in cols_fills]
    return kernels.rank_compact_many(cols_fills, slot.to(torch.int32), width)


class InsertResult(NamedTuple):
    store: StoreCols
    n_inserted: torch.Tensor  # i32[N] new records now in the store
    n_dropped: torch.Tensor   # i32[N] new records lost (dup or overflow)
    n_evicted: torch.Tensor   # i32[N] existing records lost to overflow


def _masked_batch(new: StoreCols, new_mask: torch.Tensor) -> StoreCols:
    """Masked-out batch entries become empty records (in bits views)."""
    fills = (EMPTY_U32, EMPTY_U32, empty_of(new.meta.dtype), EMPTY_U32, 0, 0)
    return StoreCols(*(
        torch.where(new_mask, bits(c),
                    fill_bits((), f, c.dtype, new_mask.device))
        for c, f in zip(new, fills)))


def as_store_dtypes(new: StoreCols, store: StoreCols) -> StoreCols:
    """The batch's narrowed columns (meta, aux, flags) in the store's
    dtypes: truncating, as the JAX package's ``astype``."""
    return new._replace(meta=cast(new.meta, store.meta.dtype),
                        aux=cast(new.aux, store.aux.dtype),
                        flags=cast(new.flags, store.flags.dtype))


def store_insert_plain(store: StoreCols, new: StoreCols,
                       new_mask: torch.Tensor) -> InsertResult:
    """The JAX package's sort form (``_sort_ordered``): one lexicographic
    sort of ring ++ batch on (gt, member, position), then the UNIQUE(member,
    gt) dup kill and a rank compaction that keeps the lowest gts."""
    m = store.gt.shape[-1]
    n_before = count_valid(store.gt)
    masked = _masked_batch(new, new_mask)
    n_new_valid = (masked.gt != -1).sum(-1, dtype=torch.int32)
    cat = StoreCols(*(torch.cat([bits(a), b], dim=-1)
                      for a, b in zip(store, masked)))
    # Two stable sorts give the (gt, member, position) order.
    o1 = torch.sort(wide(cat.member), dim=-1, stable=True).indices
    g1 = torch.gather(wide(cat.gt), -1, o1)
    o2 = torch.sort(g1, dim=-1, stable=True).indices
    perm = torch.gather(o1, -1, o2)
    gt, member, meta, payload, aux, flags = (
        torch.gather(c, -1, perm) for c in cat)
    origin = perm >= m
    dup = torch.zeros_like(origin)
    dup[:, 1:] = ((gt[:, 1:] == gt[:, :-1]) & (member[:, 1:] == member[:, :-1])
                  & (gt[:, 1:] != -1))
    keep = (gt != -1) & ~dup
    rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    slot = torch.where(keep & (rank < m), rank, m)
    dts = [c.dtype for c in store]
    out = StoreCols(*rank_compact_many_plain(
        [(unbits(gt, dts[0]), EMPTY_U32), (unbits(member, dts[1]), EMPTY_U32),
         (unbits(meta, dts[2]), empty_of(dts[2])),
         (unbits(payload, dts[3]), EMPTY_U32),
         (unbits(aux, dts[4]), 0), (unbits(flags, dts[5]), 0)], slot, m))
    kept = keep & (rank < m)
    n_inserted = (kept & origin).sum(-1, dtype=torch.int32)
    n_old = (kept & ~origin).sum(-1, dtype=torch.int32)
    return InsertResult(store=out, n_inserted=n_inserted,
                        n_dropped=n_new_valid - n_inserted,
                        n_evicted=n_before - n_old)


def store_insert(store: StoreCols, new: StoreCols, new_mask: torch.Tensor,
                 history: tuple = ()) -> InsertResult:
    """Merge a batch of records into each peer's sorted store.

    UNIQUE(member, global_time): the existing record wins, then batch
    order.  Capacity overflow keeps the lowest global_times.  LastSync
    ``history`` (keep-last-k) is not ported yet.  The batch's narrowed
    columns follow the store's dtypes.
    """
    if any(k > 0 for k in history):
        raise NotImplementedError(
            "store_insert with a LastSync history (last_sync_history) is "
            "not ported yet")
    new = as_store_dtypes(new, store)
    if new_mask.device.type == "cpu":
        return store_insert_plain(store, new, new_mask)
    gt, member, meta, payload, aux, flags, ins, drop, evi = \
        kernels.store_insert(store, new, new_mask)
    return InsertResult(StoreCols(gt, member, meta, payload, aux, flags),
                        ins, drop, evi)


class SyncSlice(NamedTuple):
    """The sync range advertised in an introduction request (int64
    carriers of u32 values); ``time_high == 0`` means unbounded."""
    time_low: torch.Tensor
    time_high: torch.Tensor
    modulo: torch.Tensor
    offset: torch.Tensor


def slice_mask(gt: torch.Tensor, s: SyncSlice) -> torch.Tensor:
    """bool[N, M]: membership of store entries in an advertised slice."""
    g = wide(gt)
    valid = g != EMPTY_U32
    lo = g >= wide(s.time_low)[..., None]
    th = wide(s.time_high)[..., None]
    hi = (th == 0) | (g <= th)
    mod = (g % torch.clamp(wide(s.modulo), min=1)[..., None]) \
        == wide(s.offset)[..., None]
    return valid & lo & hi & mod


def claim_slice_largest(gt: torch.Tensor, capacity: int) -> SyncSlice:
    """"Largest" claim: the newest ≤ capacity entries, open-ended above."""
    n_valid = count_valid(gt).to(torch.int64)
    start = torch.clamp(n_valid - capacity, min=0)
    boundary = torch.gather(wide(gt), -1, start[..., None])[..., 0]
    time_low = torch.where(start == 0, 1, boundary)
    z = torch.zeros_like(time_low)
    return SyncSlice(time_low=time_low, time_high=z,
                     modulo=torch.ones_like(time_low), offset=z.clone())


def claim_slice_modulo(gt: torch.Tensor, capacity: int,
                       round_index) -> SyncSlice:
    """"Modulo" claim: stripe the whole store across successive rounds."""
    n_valid = count_valid(gt).to(torch.int64)
    modulo = torch.clamp((n_valid + capacity - 1) // capacity, min=1)
    offset = wide(round_index) % modulo
    ones = torch.ones_like(modulo)
    return SyncSlice(time_low=ones, time_high=torch.zeros_like(modulo),
                     modulo=modulo, offset=offset)


class StageResult(NamedTuple):
    staging: StoreCols
    landed: torch.Tensor     # bool[N, B] arrivals that took a staging slot
    n_dropped: torch.Tensor  # i32[N] arrivals lost to staging overflow


def store_stage_plain(staging: StoreCols, new: StoreCols,
                      new_mask: torch.Tensor) -> StageResult:
    s = staging.gt.shape[-1]
    cnt = count_valid(staging.gt).to(torch.int64)
    rank = torch.cumsum(new_mask.to(torch.int64), dim=-1) - 1
    slot = cnt[:, None] + rank
    landed = new_mask & (slot < s)
    tgt = torch.where(landed, slot, s)

    def put(cur, val):
        out = torch.cat([bits(cur), bits(cur[:, :1])], dim=-1)
        out.scatter_(1, tgt, bits(val))
        return unbits(out[:, :s].contiguous(), cur.dtype)
    out = StoreCols(*(put(c, v) for c, v in zip(staging, new)))
    n_dropped = (new_mask & ~landed).sum(-1, dtype=torch.int32)
    return StageResult(staging=out, landed=landed, n_dropped=n_dropped)


def store_stage(staging: StoreCols, new: StoreCols,
                new_mask: torch.Tensor) -> StageResult:
    """Append the masked arrivals to each peer's ``[N, S]`` staging buffer
    in batch order, after the row's valid prefix; arrivals past ``S`` are
    dropped and counted.  The batch's columns follow the staging dtypes
    (``aux`` u32 -> u16 truncates; the kernel narrows it on the way
    in).  Returns new tensors."""
    if new_mask.device.type == "cpu":
        return store_stage_plain(staging, as_store_dtypes(new, staging),
                                 new_mask)
    *cols, landed, n_dropped = kernels.store_stage(staging, new, new_mask)
    return StageResult(StoreCols(*cols), landed, n_dropped)


# ---- cohort blocks of the staggered store -----------------------------------
# Row j of cohort a's block is full row j * cohorts + a, so a block is a
# strided view of the full array: no copy, no kernel.  ``a`` is a host int
# (the engine reads the round index once per round).

def cohort_take(col: torch.Tensor, a: int, cohorts: int) -> torch.Tensor:
    """Cohort ``a``'s ``[N // cohorts, ...]`` row block of a full
    ``[N, ...]`` array: a strided view."""
    n = col.shape[0]
    return col.view((n // cohorts, cohorts) + tuple(col.shape[1:]))[:, a]


def cohort_set(col: torch.Tensor, blk: torch.Tensor, a: int,
               cohorts: int) -> torch.Tensor:
    """Write ``blk`` into cohort ``a``'s row block of ``col`` in place and
    return ``col`` (for a ``col`` that the caller made itself)."""
    cohort_take(bits(col), a, cohorts).copy_(bits(blk))
    return col


def cohort_put(col: torch.Tensor, blk: torch.Tensor, a: int,
               cohorts: int) -> torch.Tensor:
    """A copy of ``col`` with cohort ``a``'s row block replaced by ``blk``
    (the caller's tensor is not written)."""
    return cohort_set(unbits(bits(col).clone(), col.dtype), blk, a, cohorts)


def cohort_take_cols(stc: StoreCols, a: int, cohorts: int) -> StoreCols:
    """:func:`cohort_take` of every column, made contiguous (the kernels
    take contiguous rows; the copy is what the block slice costs)."""
    return StoreCols(*(unbits(bits(cohort_take(c, a, cohorts)).contiguous(),
                              c.dtype) for c in stc))


def cohort_put_cols(stc: StoreCols, blk: StoreCols, a: int,
                    cohorts: int) -> StoreCols:
    """:func:`cohort_put` of every column."""
    return StoreCols(*(cohort_put(c, b, a, cohorts)
                       for c, b in zip(stc, blk)))
