"""The uint32 convention of the port.

PyTorch keeps ``torch.uint32`` as a storage type: on the CPU it has no
``>>``, ``+``, ``<``, ``%``, gather or ``index_put``.  So every plain
computation on u32 values carries them in ``int64`` ("a carrier"), masks
with ``& MASK`` after each wrapping operation and narrows back to
``torch.uint32`` at the state and kernel boundaries.  A u32 value is never
carried in ``int32``: ``EMPTY_U32`` must compare greater than every real
record.  The narrowing goes through an ``int32`` bit view, which every
backend supports.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def wide(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor holding u32 values -> int64 carrier in [0, 2^32).
    A ``torch.uint16`` column widens through its int16 view (zero-extended,
    never sign-extended)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(torch.int64) & MASK
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF
    if x.dtype == torch.int64:
        return x & MASK
    return x.to(torch.int64) & MASK


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 carrier (any value; taken mod 2^32) -> ``torch.uint32``."""
    if x.dtype == torch.uint32:
        return x
    s = ((x.to(torch.int64) + (1 << 31)) & MASK) - (1 << 31)
    return s.to(torch.int32).view(torch.uint32)


def narrow16(x: torch.Tensor) -> torch.Tensor:
    """int64 carrier -> ``torch.uint16``, keeping the low 16 bits (the
    truncating ``astype(uint16)`` of the JAX package)."""
    s = ((x.to(torch.int64) & 0xFFFF) ^ 0x8000) - 0x8000
    return s.to(torch.int16).view(torch.uint16)


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """A record column in another unsigned width (u32, u16 or u8):
    truncating when it narrows, zero-extending when it widens."""
    if x.dtype == dtype:
        return x
    if dtype == torch.uint32:
        return narrow(wide(x))
    if dtype == torch.uint16:
        return narrow16(wide(x))
    return (wide(x) & 0xFF).to(dtype)


_BITS = {torch.uint32: torch.int32, torch.uint16: torch.int16}


def bits(x: torch.Tensor) -> torch.Tensor:
    """A signed view of the same bits (free), for the gather, scatter and
    index operations PyTorch lacks for unsigned words; other dtypes pass
    through.  Equality is preserved, order is not."""
    return x.view(_BITS[x.dtype]) if x.dtype in _BITS else x


def unbits(x: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`bits`: view ``x`` back as ``dtype``."""
    return x.view(dtype) if x.dtype != dtype else x


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for a carrier ``x`` and a u32 constant ``c``,
    in two 16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def zeros(shape, dtype, device) -> torch.Tensor:
    """``torch.zeros`` made through the signed view for the unsigned word
    dtypes, whose fill kernels PyTorch does not build on every device."""
    if dtype in _BITS:
        return torch.zeros(shape, dtype=_BITS[dtype], device=device).view(
            dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def full_u32(shape, value: int, device) -> torch.Tensor:
    """A ``torch.uint32`` tensor filled with ``value``."""
    return narrow(torch.full(shape, value, dtype=torch.int64, device=device))
