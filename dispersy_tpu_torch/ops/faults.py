"""Fault-channel ops: the Gilbert–Elliott advance, the partition gate,
the popcount and the store-invariant test (port of
``dispersy_tpu/ops/faults.py``).

No TPU-only form exists here: plain PyTorch on every device.  Draws are
the counter hashes of :mod:`ops.rng`, compared in float32.
"""

from __future__ import annotations

import torch

from dispersy_tpu_torch.config import EMPTY_U32
from dispersy_tpu_torch.ops import rng
from dispersy_tpu_torch.u32 import MASK, wide


def _f32(x: float, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def ge_advance(ge_bad: torch.Tensor, seed, rnd, idx: torch.Tensor,
               p_bad: float, p_good: float) -> torch.Tensor:
    """bool[N]: one Gilbert–Elliott transition of every peer's channel
    (good -> bad with ``p_bad``, bad -> good with ``p_good``), one
    ``P_GE`` draw per peer."""
    u = rng.rand_uniform(seed, rnd, idx, rng.P_GE)
    dev = ge_bad.device
    return torch.where(ge_bad, ~(u < _f32(p_good, dev)),
                       u < _f32(p_bad, dev))


def partition_blocked(src: torch.Tensor, dst: torch.Tensor,
                      partitions: tuple) -> torch.Tensor:
    """bool: is the edge src -> dst severed?  Its endpoints lie in the
    opposite ranges of one ``((lo_a, hi_a), (lo_b, hi_b))`` pair, in
    either direction; NO_PEER and out-of-range endpoints never are."""
    out = None
    for (a_lo, a_hi), (b_lo, b_hi) in partitions:
        src_a = (src >= a_lo) & (src < a_hi)
        src_b = (src >= b_lo) & (src < b_hi)
        dst_a = (dst >= a_lo) & (dst < a_hi)
        dst_b = (dst >= b_lo) & (dst < b_hi)
        hit = (src_a & dst_b) | (src_b & dst_a)
        out = hit if out is None else out | hit
    if out is None:
        shape = torch.broadcast_shapes(tuple(src.shape), tuple(dst.shape))
        return torch.zeros(shape, dtype=torch.bool, device=src.device)
    return out


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 set-bit count of each u32 element (the SWAR form, masked to
    32 bits at every step)."""
    x = wide(x)
    x = (x - ((x >> 1) & 0x55555555)) & MASK
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK) >> 24


def store_invariant_violated(gt: torch.Tensor,
                             member: torch.Tensor) -> torch.Tensor:
    """bool[N]: does an adjacent pair of store slots break the ascending
    (gt, member), UNIQUE and holes-last invariant?"""
    g, m = wide(gt), wide(member)
    g0, g1 = g[:, :-1], g[:, 1:]
    m0, m1 = m[:, :-1], m[:, 1:]
    ok = (g1 == EMPTY_U32) | (g0 < g1) | ((g0 == g1) & (m0 < m1))
    return (~ok).any(dim=1)
