"""Ingress-protection ops: admission classes and the token buckets
(port of ``dispersy_tpu/ops/overload.py``).

No TPU-only form exists here: plain PyTorch on every device.  The
refill's fractional part is one float32 ``P_OVERLOAD`` draw per peer.
"""

from __future__ import annotations

import numpy as np
import torch

from dispersy_tpu_torch.config import (CONTROL_PRIORITY, IDENTITY_PRIORITY,
                                       META_AUTHORIZE, META_IDENTITY,
                                       META_MALICIOUS)
from dispersy_tpu_torch.ops import rng


def admission_class(meta: torch.Tensor, n_meta: int,
                    priorities: tuple) -> torch.Tensor:
    """int64 admission class in [0, 255] per wire meta byte (u8): lower
    wins inbox slots under overflow.  User metas ``255 - priority``,
    dispersy-identity ``255 - IDENTITY_PRIORITY``, the rest of the
    control band ``255 - CONTROL_PRIORITY``, anything else 255."""
    m = meta.to(torch.int64)
    prio = torch.tensor(priorities, dtype=torch.int64, device=m.device)
    user = 255 - prio[m.clamp(max=n_meta - 1)]
    is_ident = m == META_IDENTITY
    is_ctrl = (m >= META_AUTHORIZE) & (m <= META_MALICIOUS) & ~is_ident
    return torch.where(
        m < n_meta, user,
        torch.where(is_ident, 255 - IDENTITY_PRIORITY,
                    torch.where(is_ctrl, 255 - CONTROL_PRIORITY, 255)))


def bucket_refill(bucket: torch.Tensor, seed, rnd, idx: torch.Tensor,
                  bucket_rate: float, bucket_depth: int) -> torch.Tensor:
    """int64[N] spendable credit: the u8 balance plus the refill (its
    whole part, and one more where the draw falls below its fraction,
    both taken in float32), clamped at ``bucket_depth``."""
    ratef = np.float32(bucket_rate)
    whole = np.floor(ratef)
    frac = torch.tensor(ratef - whole, dtype=torch.float32,
                        device=bucket.device)
    u = rng.rand_uniform(seed, rnd, idx, rng.P_OVERLOAD)
    refill = int(whole) + (u < frac).to(torch.int64)
    return torch.clamp(bucket.to(torch.int64) + refill, max=bucket_depth)


def bucket_spend(credit: torch.Tensor,
                 n_attempted: torch.Tensor) -> torch.Tensor:
    """u8[N] balance after the round: credit minus the attempts it
    covered (attempts beyond it were shed, not spent)."""
    return (credit - torch.minimum(n_attempted, credit)).to(torch.uint8)
