"""Packed-uint32 Bloom filters (port of ``dispersy_tpu/ops/bloom.py``).

The bitset is ``uint32[W]`` per row.  Double hashing: bit_j =
(h1 + j·h2) mod n_bits with h2 forced odd, h1/h2 drawn from seeded
:func:`hashing.hash_u32` streams of the item hash, optionally salted per
filter (the reference's BloomFilter prefix).

:func:`bloom_build` and :func:`bloom_query` are wrappers: a CPU tensor
takes the plain version (the JAX package's gather form on a probe
tensor), a CUDA tensor the hand-written kernel in ``csrc/bloom.cu``, which
derives the probes in registers and never materialises them.
"""

from __future__ import annotations

import torch

from dispersy_tpu_torch import kernels
from dispersy_tpu_torch.ops.hashing import (BLOOM_SALT_SEED, BLOOM_SEED_1,
                                            BLOOM_SEED_2, hash_u32)
from dispersy_tpu_torch.u32 import MASK, bits, narrow, unbits, wide


def probe_bits(item_hash: torch.Tensor, n_bits: int, n_hashes: int,
               salt=None) -> torch.Tensor:
    """int64 bit indices probed per item: ``item_hash.shape + (n_hashes,)``.
    ``salt=None`` is unsalted (not the same as salt 0)."""
    h = wide(item_hash)
    if salt is not None:
        mix = hash_u32(salt, BLOOM_SALT_SEED)
        if mix.dim() == 1:      # one salt per row: line up with the rows
            mix = mix.reshape((mix.shape[0],) + (1,) * (h.dim() - 1))
        h = h ^ mix
    h1 = hash_u32(h, BLOOM_SEED_1)
    h2 = hash_u32(h, BLOOM_SEED_2) | 1
    j = torch.arange(n_hashes, dtype=torch.int64, device=h.device)
    return ((h1[..., None] + j * h2[..., None]) & MASK) % n_bits


def pack_bits(dense: torch.Tensor) -> torch.Tensor:
    """bool[..., 32·W] -> uint32[..., W], bit i of word w == bit 32w+i."""
    w = dense.reshape(*dense.shape[:-1], -1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=dense.device)
    return narrow((w << shifts).sum(-1))


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """uint32[..., W] -> bool[..., 32·W] (inverse of :func:`pack_bits`)."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    return (((wide(words)[..., None] >> shifts) & 1) > 0).reshape(
        *words.shape[:-1], -1)


def bloom_build_plain(item_hashes, mask, n_bits, n_hashes,
                      salt=None) -> torch.Tensor:
    probes = probe_bits(item_hashes, n_bits, n_hashes, salt)
    lead = item_hashes.shape[:-1]
    rows = probes.reshape(-1, probes.shape[-2] * probes.shape[-1])
    tgt = torch.where(mask.reshape(rows.shape[0], -1, 1),
                      probes.reshape(rows.shape[0], -1, n_hashes),
                      n_bits).reshape(rows.shape)
    dense = torch.zeros((rows.shape[0], n_bits + 1), dtype=torch.bool,
                        device=item_hashes.device)
    dense.scatter_(1, tgt, True)
    return pack_bits(dense[:, :n_bits]).reshape(*lead, n_bits // 32)


def bloom_query_plain(words, item_hashes, n_bits, n_hashes,
                      salt=None) -> torch.Tensor:
    probes = probe_bits(item_hashes, n_bits, n_hashes, salt)
    w = wide(words)
    sel = torch.gather(w, -1, (probes >> 5).reshape(
        *probes.shape[:-2], -1)).reshape(probes.shape)
    return (((sel >> (probes & 31)) & 1) == 1).all(-1)


def digest_update_plain(digest, item_hashes, mask, n_bits, n_hashes,
                        salt=None) -> torch.Tensor:
    built = bloom_build_plain(item_hashes, mask, n_bits, n_hashes, salt)
    return unbits(bits(digest) | bits(built), torch.uint32)


def bloom_build(item_hashes: torch.Tensor, mask: torch.Tensor, n_bits: int,
                n_hashes: int, salt=None) -> torch.Tensor:
    """Packed filters ``uint32[N, n_bits // 32]`` from ``uint32[N, M]`` item
    hashes under ``bool[N, M]`` mask (masked-out items set no bits)."""
    assert n_bits % 32 == 0, "n_bits must pack into uint32 words"
    if item_hashes.device.type == "cpu":
        return bloom_build_plain(item_hashes, mask, n_bits, n_hashes, salt)
    return kernels.bloom_build(item_hashes, mask, n_bits, n_hashes, salt)


def bloom_query(words: torch.Tensor, item_hashes: torch.Tensor, n_bits: int,
                n_hashes: int, salt=None) -> torch.Tensor:
    """bool[N, M]: are all of each item's probe bits set in its row's
    ``uint32[N, W]`` filter (``words`` may be a row-strided view)."""
    if item_hashes.device.type == "cpu":
        return bloom_query_plain(words, item_hashes, n_bits, n_hashes, salt)
    return kernels.bloom_query(words, item_hashes, n_bits, n_hashes, salt)


def digest_update(digest: torch.Tensor, item_hashes: torch.Tensor,
                  mask: torch.Tensor, n_bits: int, n_hashes: int,
                  salt=None) -> torch.Tensor:
    """A new ``uint32[N, W]`` digest: ``digest`` with the probe bits of the
    masked ``uint32[N, B]`` items ORed in (``digest | bloom_build(...)``;
    the caller's tensor is not written)."""
    assert n_bits % 32 == 0, "n_bits must pack into uint32 words"
    if item_hashes.device.type == "cpu":
        return digest_update_plain(digest, item_hashes, mask, n_bits,
                                   n_hashes, salt)
    return kernels.digest_update(digest, item_hashes, mask, n_bits,
                                 n_hashes, salt)
