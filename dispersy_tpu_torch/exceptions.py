"""Typed exceptions (a copy of ``dispersy_tpu.exceptions``: the port
imports nothing of the JAX package)."""

from __future__ import annotations


class ConfigError(ValueError):
    """An invalid CommunityConfig (config.py __post_init__)."""


class KernelError(RuntimeError):
    """A hand-written kernel refused its inputs, failed to build or failed
    to launch (kernels/__init__.py)."""


class CheckpointError(ValueError):
    """A checkpoint that cannot be restored: version or config mismatch,
    missing leaves, shape conflicts, a failed CRC or a torn archive
    (checkpoint.py)."""
