"""Deterministic uint32 hashing (port of ``dispersy_tpu/ops/hashing.py``).

murmur3-style mixing on u32 values carried in int64 (``u32.py``); every
wrapping operation is masked back to 32 bits, so the results equal the
JAX package's wrapping uint32 arithmetic bit for bit.  The same functions
exist as ``__device__`` helpers in ``csrc/common.cuh`` for the kernels.
"""

from __future__ import annotations

import torch

from dispersy_tpu_torch.u32 import MASK, mul32, wide

GOLDEN = 0x9E3779B9
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35

# Domain-separation seeds for the two Bloom double-hashing streams and the
# per-filter salt (the reference's BloomFilter prefix).
BLOOM_SEED_1 = 0x8F1BBCDC
BLOOM_SEED_2 = 0xCA62C1D6
BLOOM_SALT_SEED = 0x6ED9EBA1


def _c(x) -> torch.Tensor:
    return wide(x) if isinstance(x, torch.Tensor) else torch.tensor(
        int(x) & MASK, dtype=torch.int64)


def fmix32_int(x: int) -> int:
    """:func:`fmix32` on a Python int (host-side constants)."""
    x &= MASK
    x ^= x >> 16
    x = (x * _C1) & MASK
    x ^= x >> 13
    x = (x * _C2) & MASK
    return x ^ (x >> 16)


def fmix32(x) -> torch.Tensor:
    """murmur3 32-bit finalizer: a bijective avalanche mix on u32."""
    x = _c(x)
    x = x ^ (x >> 16)
    x = mul32(x, _C1)
    x = x ^ (x >> 13)
    x = mul32(x, _C2)
    return x ^ (x >> 16)


def hash_u32(x, seed: int) -> torch.Tensor:
    """Seeded hash of a u32 value."""
    return fmix32(_c(x) ^ fmix32_int(seed))


def combine(h, v) -> torch.Tensor:
    """Fold value ``v`` into running hash ``h`` (boost::hash_combine-style)."""
    h = _c(h)
    return h ^ ((fmix32(v) + GOLDEN + ((h << 6) & MASK) + (h >> 2)) & MASK)


def record_hash(member, global_time, meta, payload) -> torch.Tensor:
    """Hash of one sync record, its identity for Bloom membership."""
    h = fmix32(member)
    h = combine(h, global_time)
    h = combine(h, meta)
    return combine(h, payload)
