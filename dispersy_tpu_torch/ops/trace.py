"""Dissemination-tracing ops: the per-slot lineage fold, the coverage
counts and the coverage latches (port of ``dispersy_tpu/ops/trace.py``).

The JAX package has no TPU-only form of these ops, so each is plain
PyTorch on both devices.  Columns may come as ``torch.uint32`` leaves or
int64 carriers (``u32.py``); :func:`slot_lineage` returns carriers (the
round keeps its lineage in them), the others ``torch.uint32``.
"""

from __future__ import annotations

import torch

from dispersy_tpu_torch.traceplane import LATCH_PCTS, NUM_CHANNELS
from dispersy_tpu_torch.u32 import MASK, narrow, wide

def slot_lineage(first, chan, dups, match, landed, arrived, chan_code,
                 round_post):
    """Fold one intake batch into the tracked slots' lineage columns.

    ``first`` u32[N, T] first-arrival rounds, ``chan`` u8[N, T] their
    channels, ``dups`` u32[N, T] duplicate deliveries; ``match`` bool[N,
    T, B] the batch entries with each slot's key, ``landed`` bool[N, B]
    those that entered the logical store this round, ``arrived`` those
    past intake; ``chan_code`` u8[B] each entry's channel code (1-4, as
    the round's batch segments carry); ``round_post`` the post-step
    round.  A slot's useful entry is a landed match on a row with no
    lineage yet -- at most one a row (in-batch dedup keeps only the first
    same-key entry fresh); every other arrived match is a duplicate.
    Each slot is the JAX package's ``slot_lineage`` of that slot.
    Returns ``(first, chan, dups, useful_by, dup_by)``: the u32 values as
    int64 carriers, ``chan`` u8, the per-channel counts summed over the
    slots, [N, 4] in channel order.
    """
    n, t, b = match.shape
    f = wide(first)
    useful_e = match & landed[:, None, :] & (f == 0)[:, :, None]
    # The max selects the useful entry's channel (every code is >= 1, so
    # a code is set exactly where a useful entry is).
    ch_new = (torch.where(useful_e, chan_code, torch.zeros_like(chan_code))
              .amax(dim=2) if b else torch.zeros_like(chan))
    any_u = ch_new != 0
    first = torch.where(any_u, wide(round_post), f)
    chan = torch.where(any_u, ch_new, chan)
    # Duplicates by slot and channel: the entries' one-hot codes summed
    # by a matrix product (exact: 0/1 inputs in bfloat16, float32 sums
    # of at most B).
    dup_e = match & arrived[:, None, :] & ~useful_e
    codes = torch.arange(1, NUM_CHANNELS + 1, device=match.device)
    onehot = (chan_code[:, None] == codes).to(torch.bfloat16)   # [B, 4]
    dup_tc = (dup_e.reshape(n * t, b).to(torch.bfloat16) @ onehot).to(
        torch.int64).reshape(n, t, NUM_CHANNELS)
    dups = (wide(dups) + dup_tc.sum(dim=2)) & MASK
    useful_by = ((ch_new[:, :, None] == codes) & any_u[:, :, None]).sum(
        dim=1)
    return first, chan, dups, useful_by, dup_tc.sum(dim=1)


def coverage_counts(first, members: torch.Tensor) -> torch.Tensor:
    """u32[T]: per tracked slot, the alive non-tracker peers whose
    first-arrival round is set."""
    return narrow(((wide(first) != 0) & members[:, None]).sum(dim=0))


def latch_update(latch, cov, registered: torch.Tensor, alive_cnt,
                 round_post) -> torch.Tensor:
    """u32[T, 3]: latch the post-step round in each registered slot's
    {50, 90, 99}% column the first round its coverage reaches that share
    of the alive members (``cov * 100 >= pct * alive`` in u32)."""
    lat, a = wide(latch), wide(alive_cnt)
    pcts = torch.stack([torch.full((), p, dtype=torch.int64,
                                   device=lat.device) for p in LATCH_PCTS])
    reach = ((wide(cov)[:, None] * 100) & MASK) >= ((pcts[None, :] * a)
                                                    & MASK)
    cond = (lat == 0) & registered[:, None] & (a > 0) & reach
    return narrow(torch.where(cond, wide(round_post), lat))
