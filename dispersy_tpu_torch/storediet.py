"""Cadence helpers of the byte-diet store (port of the helpers in
``dispersy_tpu/storediet.py``).

Under ``StoreConfig(staging > 0)`` accepted records land in a staging
buffer, the sorted ring merges only on sync rounds, and the Bloom claim
reads a persistent per-peer digest salted with an epoch.  With
``cohorts > 1`` the sync/compaction round is staggered: peer ``p`` is in
cohort ``p % cohorts``, and one cohort syncs every
``compact_every // cohorts`` rounds.

Every helper takes a host int or an int64 tensor (a u32 carrier, or a
per-peer vector of them).  Sums that the JAX package forms in u32 wrap
here the same way (``& MASK``).  :class:`StoreConfig` itself lives in
:mod:`dispersy_tpu_torch.planes`.
"""

from __future__ import annotations

from dispersy_tpu_torch.u32 import MASK


def epoch_of(cfg, rnd):
    """Cohort 0's Bloom-salt epoch at round ``rnd``: ``rnd //
    compact_every``."""
    return rnd // cfg.store.compact_every


def stagger_of(cfg) -> bool:
    """Is the cohort-staggered cadence on (the diet with ``cohorts > 1``)?"""
    return cfg.store.staging > 0 and cfg.store.cohorts > 1


def cohort_of(cfg, idx):
    """Peer ``idx``'s compaction cohort: ``idx % cohorts``."""
    return idx % cfg.store.cohorts


def cohort_phase(cfg, k):
    """The round within the window on which cohort ``k`` syncs:
    ``compact_every - 1 - k * (compact_every // cohorts)``."""
    c = cfg.store.compact_every
    return c - 1 - k * (c // cfg.store.cohorts)


def active_cohort(cfg, rnd):
    """The cohort that syncs on round ``rnd`` (meaningful where
    :func:`sync_round_of` holds)."""
    c = cfg.store.compact_every
    stride = c // cfg.store.cohorts
    return (c - 1 - rnd % c) // stride


def epoch_of_cohort(cfg, rnd, k):
    """Cohort ``k``'s epoch at round ``rnd``, the compactions it has
    completed: ``(rnd + k * (C // cohorts)) // C`` with the sum in u32."""
    c = cfg.store.compact_every
    return ((rnd + k * (c // cfg.store.cohorts)) & MASK) // c


def sync_round_of(cfg, rnd):
    """Does round ``rnd`` run the sync exchange and compaction for some
    cohort?  Always true without the diet."""
    if cfg.store.staging == 0:
        return True
    stride = cfg.store.compact_every // cfg.store.cohorts
    return (rnd % stride) == stride - 1


def phase_of(cfg, rnd: int) -> str:
    """``engine.step``'s phase for round ``rnd``: ``"sync"`` or
    ``"quiet"``."""
    return "sync" if sync_round_of(cfg, rnd) else "quiet"
