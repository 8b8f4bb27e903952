"""Intake checks: batch-vs-store membership and in-batch dedup (port of
``in_store`` and ``dup_earlier`` in ``dispersy_tpu/ops/intake.py``).

Both are compare-and-any reductions per (row, batch entry): over the M
store slots for ``in_store``, over the earlier batch entries for
``dup_earlier``.  :func:`intake_checks` is the wrapper that computes both
in one pass -- on a CUDA tensor through the Triton kernel in
``kernels/intake_triton.py``, on a CPU tensor through the plain broadcast
forms beside it.  :func:`dup_earlier` is the same kernel in its mode
without a store operand: under the byte-diet store the "already stored?"
test is a digest query, so a quiet round reads no ring bytes.  Only
equality is tested, so u32 columns are compared through their int32 bit
views.
"""

from __future__ import annotations

import torch

from dispersy_tpu_torch import kernels
from dispersy_tpu_torch.u32 import bits


def in_store_plain(store_gt, store_member, member, gt) -> torch.Tensor:
    return ((bits(store_gt)[:, None, :] == bits(gt)[:, :, None])
            & (bits(store_member)[:, None, :] == bits(member)[:, :, None])
            ).any(-1)


def dup_earlier_plain(member, gt, ok) -> torch.Tensor:
    b = member.shape[1]
    ar = torch.arange(b, device=ok.device)
    earlier = ar[None, :] < ar[:, None]                       # [B, B]
    g, m = bits(gt), bits(member)
    return ((g[:, :, None] == g[:, None, :]) & (m[:, :, None] == m[:, None, :])
            & ok[:, None, :] & earlier[None]).any(-1)


def intake_checks(store_gt, store_member, member, gt, ok):
    """(in_store, dup_earlier), each bool[N, B]: is (member, gt) already a
    stored row, and did an earlier valid batch entry carry it."""
    if gt.device.type == "cpu":
        return (in_store_plain(store_gt, store_member, member, gt),
                dup_earlier_plain(member, gt, ok))
    return kernels.intake_checks(store_gt, store_member, member, gt, ok)


def dup_earlier(member, gt, ok) -> torch.Tensor:
    """bool[N, B]: did an earlier valid batch entry carry the same
    (member, gt)?  Reads no store."""
    if gt.device.type == "cpu":
        return dup_earlier_plain(member, gt, ok)
    return kernels.dup_earlier(member, gt, ok)
