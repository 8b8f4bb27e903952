"""Recovery ops: store repair, the walk-backoff gate and the quarantine
gate (port of ``dispersy_tpu/ops/recovery.py``).

No TPU-only form exists here: plain PyTorch on every device.
"""

from __future__ import annotations

import torch

from dispersy_tpu_torch.config import EMPTY_U32
from dispersy_tpu_torch.ops.store import StoreCols, rank_compact_many
from dispersy_tpu_torch.u32 import bits, unbits, wide


def store_repair(store: StoreCols, mask: torch.Tensor) -> StoreCols:
    """Re-sort the masked rows by (gt, member, meta, payload) with holes
    last, drop later duplicates of a (gt, member) pair and compact the
    survivors to the front; unmasked rows pass through."""
    # Lexicographic order by four stable sorts, the last key first.
    perm = None
    for col in (store.payload, store.meta, store.member, store.gt):
        key = wide(col)
        if perm is not None:
            key = torch.gather(key, -1, perm)
        order = torch.sort(key, dim=-1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, -1, order)
    srt = StoreCols(*(unbits(torch.gather(bits(c), -1, perm), c.dtype)
                      for c in store))
    gt, member = wide(srt.gt), wide(srt.member)
    live = gt != EMPTY_U32
    dup = torch.zeros_like(live)
    dup[:, 1:] = ((gt[:, 1:] == gt[:, :-1]) & (member[:, 1:] == member[:, :-1])
                  & live[:, 1:])
    keep = live & ~dup
    m = gt.shape[1]
    rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    slot = torch.where(keep, rank, m)
    rep = rank_compact_many(
        [(srt.gt, EMPTY_U32), (srt.member, EMPTY_U32), (srt.meta, 0xFF),
         (srt.payload, EMPTY_U32), (srt.aux, 0), (srt.flags, 0)], slot, m)
    m1 = mask[:, None]
    return StoreCols(*(unbits(torch.where(m1, bits(r), bits(c)), c.dtype)
                       for r, c in zip(rep, store)))


def backoff_gate(rnd: int, backoff: torch.Tensor) -> torch.Tensor:
    """bool[N]: may each peer walk this round?  Exponent ``e`` admits the
    rounds with ``rnd & (2^e - 1) == 0``."""
    mask = (1 << backoff.to(torch.int64)) - 1
    return (rnd & mask) == 0


def quarantine_active(rnd, quar_until: torch.Tensor) -> torch.Tensor:
    """bool[N]: is each peer quarantined (``rnd`` before its release
    round, compared unsigned; 0 never is)."""
    return rnd < wide(quar_until)
