"""Intake checks: batch-vs-store membership, in-batch dedup and the
Timeline's store replays (port of ``in_store``, ``dup_earlier``,
``flip_best``, ``flip_best_batch``, ``undo_marked``, ``undo_hits_store``,
``stored_meta_of``, ``conflict``, ``identity_stored`` and
``seq_stored_max`` in ``dispersy_tpu/ops/intake.py``).

``in_store`` and ``dup_earlier`` are compare-and-any reductions per (row, batch entry): over the M
store slots for ``in_store``, over the earlier batch entries for
``dup_earlier``.  :func:`intake_checks` is the wrapper that computes both
in one pass -- on a CUDA tensor through the Triton kernel in
``kernels/intake_triton.py``, on a CPU tensor through the plain broadcast
forms beside it.  :func:`dup_earlier` is the same kernel in its mode
without a store operand: under the byte-diet store the "already stored?"
test is a digest query, so a quiet round reads no ring bytes.  Only
equality is tested, so u32 columns are compared through their int32 bit
views.  The replays below share one CUDA kernel (K9 ``store_match``,
``csrc/match.cu``) in four modes, and the hardened community's three
store probes -- double-sign evidence, the identity gate and the
sequence-chain base -- a Triton kernel (K11 ``store_probe``) in three.
"""

from __future__ import annotations

import torch

from dispersy_tpu_torch import kernels
from dispersy_tpu_torch.config import (EMPTY_U32, META_DYNAMIC,
                                       META_IDENTITY, META_UNDO_OTHER,
                                       META_UNDO_OWN)
from dispersy_tpu_torch.u32 import MASK, bits, narrow, wide

# stored_meta_of's answer for a target that is not a stored user record.
META_NOT_FOUND = 0xFFFF


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


# ---- the Timeline's store replays (K9 store_match) -------------------------
# Each is one compare-and-reduce pass per row: the queries [N, Q] against
# the row's W store (or batch) entries.  On a CUDA tensor every one goes
# through the CUDA kernel of ``csrc/match.cu`` in its mode; on a CPU
# tensor through the plain broadcast form beside it.

def flip_best_batch_plain(flip_ok, payload, gt, aux, q_meta,
                          q_gt) -> torch.Tensor:
    hit = (flip_ok[:, None, :]
           & (wide(payload)[:, None, :] == wide(q_meta)[:, :, None])
           & (wide(gt)[:, None, :] <= wide(q_gt)[:, :, None]))
    key = (wide(gt) * 2 + (wide(aux) & 1)) & MASK
    return narrow(torch.where(hit, key[:, None, :], 0).amax(-1))


def flip_best_batch(flip_ok, payload, gt, aux, q_meta, q_gt) -> torch.Tensor:
    """u32[N, Q]: per (meta, gt) query, the max ``gt * 2 | (aux & 1)``
    key (u32, wrapping) over the flagged dynamic-settings flips whose
    payload names the meta at or below the query gt; 0 when none
    applies (the DynamicResolution replay over this batch's flips)."""
    if q_gt.device.type == "cpu":
        return flip_best_batch_plain(flip_ok, payload, gt, aux, q_meta, q_gt)
    return kernels.store_match("flip", (flip_ok, payload, gt, aux),
                               (q_meta, q_gt))


def flip_best(stc, q_meta, q_gt) -> torch.Tensor:
    """u32[N, Q]: :func:`flip_best_batch` over the stored flips."""
    return flip_best_batch(stc.meta == META_DYNAMIC, stc.payload, stc.gt,
                           stc.aux, q_meta, q_gt)


def undo_marked_plain(stc, member, gt) -> torch.Tensor:
    undo_rows = (stc.meta == META_UNDO_OWN) | (stc.meta == META_UNDO_OTHER)
    return (undo_rows[:, None, :]
            & (bits(stc.payload)[:, None, :] == bits(member)[:, :, None])
            & (bits(stc.aux)[:, None, :] == bits(gt)[:, :, None])).any(-1)


def undo_marked(stc, member, gt) -> torch.Tensor:
    """bool[N, Q]: does a stored undo record target (member, gt)?"""
    if gt.device.type == "cpu":
        return undo_marked_plain(stc, member, gt)
    return kernels.store_match("undo_marked",
                               (stc.meta, stc.payload, stc.aux),
                               (member, gt))


def undo_hits_store_plain(stc, target_member, target_gt,
                          valid) -> torch.Tensor:
    return (valid[:, None, :]
            & (bits(stc.member)[:, :, None] == bits(target_member)[:, None, :])
            & (bits(stc.gt)[:, :, None] == bits(target_gt)[:, None, :])
            ).any(-1)


def undo_hits_store(stc, target_member, target_gt, valid) -> torch.Tensor:
    """bool[N, M]: which stored rows does the batch's accepted undo set
    (``valid`` [N, B]) name by (member, gt)?"""
    if valid.device.type == "cpu":
        return undo_hits_store_plain(stc, target_member, target_gt, valid)
    return kernels.store_match("undo_hits", (valid, target_member, target_gt),
                               (stc.member, stc.gt))


def stored_meta_of_plain(stc, member, gt) -> torch.Tensor:
    user = stc.meta < 32
    match = (user[:, None, :]
             & (bits(stc.member)[:, None, :] == bits(member)[:, :, None])
             & (bits(stc.gt)[:, None, :] == bits(gt)[:, :, None]))
    meta = stc.meta.to(torch.int64)[:, None, :]
    return narrow(torch.where(match, meta, META_NOT_FOUND).amin(-1))


def stored_meta_of(stc, member, gt) -> torch.Tensor:
    """u32[N, Q]: the meta of the stored user record at (member, gt), else
    ``META_NOT_FOUND`` (0xFFFF)."""
    if gt.device.type == "cpu":
        return stored_meta_of_plain(stc, member, gt)
    return kernels.store_match("meta_of", (stc.meta, stc.member, stc.gt),
                               (member, gt))


# ---- the hardened community's store probes (K11 store_probe) ----------------
# Each is one compare-and-reduce pass per row: the [N, B] batch entries
# against the row's [N, M] store.  On a CUDA tensor every one goes
# through the Triton kernel of ``kernels/intake_triton.py`` in its MODE;
# on a CPU tensor through the plain broadcast form beside it.

def conflict_plain(stc, member, gt, meta, payload, aux) -> torch.Tensor:
    same = ((bits(stc.member)[:, None, :] == bits(member)[:, :, None])
            & (bits(stc.gt)[:, None, :] == bits(gt)[:, :, None])
            & (wide(stc.gt)[:, None, :] != EMPTY_U32))
    differs = ((stc.meta[:, None, :] != meta[:, :, None])
               | (bits(stc.payload)[:, None, :] != bits(payload)[:, :, None])
               | (bits(stc.aux)[:, None, :] != bits(aux)[:, :, None]))
    return (same & differs).any(-1)


def conflict(stc, member, gt, meta, payload, aux) -> torch.Tensor:
    """bool[N, B]: does a live stored row share (member, gt) with the
    batch entry but differ in (meta, payload, aux)?  (Double-sign
    evidence.)  u32 columns; ``meta`` u8 as the store's."""
    if gt.device.type == "cpu":
        return conflict_plain(stc, member, gt, meta, payload, aux)
    return kernels.store_probe(
        "conflict", (stc.gt, stc.member, stc.meta, stc.payload, stc.aux),
        (member, gt, meta, payload, aux))


def identity_stored_plain(stc, member) -> torch.Tensor:
    rows = stc.meta == META_IDENTITY
    return (rows[:, None, :]
            & (bits(stc.member)[:, None, :] == bits(member)[:, :, None])
            ).any(-1)


def identity_stored(stc, member) -> torch.Tensor:
    """bool[N, B]: does the store hold a dispersy-identity record of
    ``member``?  (No gt test, as in the JAX package.)"""
    if member.device.type == "cpu":
        return identity_stored_plain(stc, member)
    return kernels.store_probe("identity", (stc.meta, stc.member), (member,))


def seq_stored_max_plain(stc, member, meta) -> torch.Tensor:
    same = ((bits(stc.member)[:, None, :] == bits(member)[:, :, None])
            & (stc.meta[:, None, :] == meta[:, :, None])
            & (wide(stc.gt)[:, None, :] != EMPTY_U32))
    return narrow(torch.where(same, wide(stc.aux)[:, None, :], 0).amax(-1))


def seq_stored_max(stc, member, meta) -> torch.Tensor:
    """u32[N, B]: the highest stored ``aux`` (the sequence number) over
    the live rows of the entry's (member, meta), else 0."""
    if member.device.type == "cpu":
        return seq_stored_max_plain(stc, member, meta)
    return kernels.store_probe("seq_max",
                               (stc.gt, stc.member, stc.meta, stc.aux),
                               (member, meta))
