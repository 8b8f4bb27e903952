"""Counter-based deterministic randomness (port of ``dispersy_tpu/ops/rng.py``).

Every stochastic choice is a pure function of (seed, round, peer,
purpose[, salt]) mixed through :mod:`hashing`, so the port replays the JAX
package's draws exactly.  Values are u32 carried in int64 (``u32.py``).
"""

from __future__ import annotations

import torch

from dispersy_tpu_torch.ops.hashing import combine, fmix32

# Purpose tags: domain separation between independent random streams.
P_CATEGORY = 1
P_SLOT = 2
P_INTRO = 3
P_BOOTSTRAP = 4
P_CHURN = 5
P_LOSS = 6
P_GOSSIP = 7
P_SIGN = 8
P_NAT = 9
P_GE = 10
P_GE_LOSS = 11
P_CORRUPT = 12
P_DUP = 13
P_FLOOD = 14
P_RECOVERY = 15
P_OVERLOAD = 16


def fold_seed(key: torch.Tensor) -> torch.Tensor:
    """u32[2] state key -> one u32 stream seed."""
    return combine(fmix32(key[..., 0]), key[..., 1])


def rand_u32(seed, round_index, peer, purpose: int, salt=0) -> torch.Tensor:
    """Deterministic u32 draw (int64 carrier); broadcasts over peer/salt."""
    h = combine(seed, round_index)
    h = combine(h, purpose)
    h = combine(h, peer)
    return combine(h, salt)


def rand_uniform(seed, round_index, peer, purpose: int,
                 salt=0) -> torch.Tensor:
    """float32 in [0, 1): the exact ``(u >> 8) * 2^-24`` path."""
    u = rand_u32(seed, round_index, peer, purpose, salt)
    return (u >> 8).to(torch.float32) * torch.tensor(
        1.0 / (1 << 24), dtype=torch.float32, device=u.device)
