"""Message-store ops: the SQLite ``sync`` table as a sorted ring (port of
``dispersy_tpu/ops/store.py``).

Each peer owns ``msg_capacity`` record slots kept sorted by (global_time,
member) with ``EMPTY_U32`` holes at the end.  Columns keep their schema
dtypes (u32 gt/member/payload/aux, u8 meta/flags).

:func:`store_insert` and :func:`rank_compact_many` are wrappers: a CPU
tensor takes the plain PyTorch version beside them, a CUDA tensor the
hand-written kernel (``csrc/store.cu``, ``csrc/compact.cu``) or an error.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dispersy_tpu_torch import kernels
from dispersy_tpu_torch.config import EMPTY_U32
from dispersy_tpu_torch.u32 import bits, unbits, wide


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
        return self.gt != EMPTY_U32


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
    if (new.meta.dtype != store.meta.dtype
            or new.flags.dtype != store.flags.dtype
            or new.aux.dtype != store.aux.dtype):
        new = new._replace(meta=new.meta.to(store.meta.dtype),
                           flags=new.flags.to(store.flags.dtype),
                           aux=new.aux.to(store.aux.dtype))
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
