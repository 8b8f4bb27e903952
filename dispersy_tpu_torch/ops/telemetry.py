"""Telemetry ops: exact u64 counter sums, masked histograms and the
flight-recorder append (port of ``dispersy_tpu/ops/telemetry.py``).

The JAX package has no TPU-only form of these ops (no Pallas, no
backend branch), so each is plain PyTorch on both devices.  Values are
u32 carried in int64 (``u32.py``):

- :func:`row_totals_u64` sums the int32 bit views of a [C, N] matrix's
  rows in int64 and adds back 2^32 for each word at or above 2^31: two
  reductions along the contiguous axis, no int64 copy of the matrix
  (the round lays its counters out as rows for this; a sum down the
  columns of an [N, C] matrix is the slower reduction on the card).
  The JAX package sums byte lanes in u32 with explicit carries, which
  is the exact 64-bit sum while ``N * 255 < 2^32``; this one is exact
  while ``N < 2^31``, a larger bound, so the words are the same.
- The histograms count each bucket with a compare against the bucket
  indices and a row sum (masked-out entries take index ``B`` and match
  none).  The JAX package scatter-adds to avoid a ``[B, N]``
  intermediate; on the card a scatter-add of 1M entries into 16 bins
  serialises on its atomics (0.67 ms a histogram at 1M peers, NVIDIA
  H100), where the compare and sum read 16 MB.
"""

from __future__ import annotations

import torch

from dispersy_tpu_torch.u32 import MASK, narrow, wide


def row_totals_u64(v: torch.Tensor) -> torch.Tensor:
    """int64[C]: the exact sum of each row of a [C, N] matrix of u32
    words in their int32 bit views (N < 2^31)."""
    return (v.sum(dim=1, dtype=torch.int64)
            + ((v < 0).sum(dim=1) << 32))


def col_sum_u64(x: torch.Tensor) -> torch.Tensor:
    """u32[2, C]: the exact 64-bit sum of each column of a u32 [N, C]
    matrix (``torch.uint32``), row 0 the low words and row 1 the high
    words."""
    s = row_totals_u64(x.view(torch.int32).t().contiguous())
    return narrow(torch.stack([s & MASK, s >> 32]))


def sum_u64(x: torch.Tensor) -> torch.Tensor:
    """:func:`col_sum_u64` of one vector: u32[2] = (lo, hi)."""
    return col_sum_u64(x[:, None])[:, 0]


def _count(b: torch.Tensor, mask: torch.Tensor, n_buckets: int):
    idx = torch.where(mask, b, n_buckets)
    ar = torch.arange(n_buckets, device=b.device)
    return narrow((ar[:, None] == idx[None, :]).sum(dim=1))


def hist_linear(val: torch.Tensor, mask: torch.Tensor, cap: int,
                n_buckets: int) -> torch.Tensor:
    """u32[B]: masked linear histogram over [0, cap]; the bucket of ``v``
    is ``v * B // (cap + 1)`` (the product wrapping in u32, as in the JAX
    package) clamped to the last bucket."""
    b = (((wide(val) * n_buckets) & MASK) // (cap + 1)).clamp(
        max=n_buckets - 1)
    return _count(b, mask, n_buckets)


def hist_log2(val: torch.Tensor, mask: torch.Tensor,
              n_buckets: int) -> torch.Tensor:
    """u32[B]: masked bit-length histogram; the bucket of ``v`` is
    ``bit_length(v)`` (0 for 0) clamped to the last bucket.  The bit
    length is the exponent ``frexp`` gives a u32 value in float64, where
    every such value is exact (the JAX package smears the bits and counts
    them)."""
    b = torch.frexp(wide(val).to(torch.float64)).exponent.to(torch.int64)
    return _count(b.clamp(max=n_buckets - 1), mask, n_buckets)


def flight_append(ring: torch.Tensor, pos: torch.Tensor,
                  records: torch.Tensor, valid: torch.Tensor):
    """(ring', pos'): the valid rows of ``records`` (u32[R, F]) written
    at consecutive slots ``(pos + rank) % D`` of the u32[D, F] ring, in
    rank order; ``pos`` (u32[1]) counts every record ever written and
    wraps in u32.  Callers keep the valid count within D."""
    depth = ring.shape[0]
    p = wide(pos)
    rank = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    slot = torch.where(valid, ((p + rank) & MASK) % depth, depth)
    buf = torch.cat([wide(ring), torch.zeros_like(wide(ring[:1]))])
    buf.index_copy_(0, slot, wide(records))
    return narrow(buf[:depth]), narrow(p + valid.sum())
