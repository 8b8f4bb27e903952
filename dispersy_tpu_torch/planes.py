"""Copies of the plane config dataclasses that ``CommunityConfig`` embeds.

Each mirrors one JAX-package module (same fields, defaults, derived
properties and ``__post_init__`` validation); the port keeps its own
copies because importing any module of ``dispersy_tpu`` pulls in JAX:

- :class:`StoreConfig` — ``dispersy_tpu/storediet.py``
- :class:`FaultModel` — ``dispersy_tpu/faults.py``
- :class:`TelemetryConfig` — ``dispersy_tpu/telemetry.py``
- :class:`TraceConfig` — ``dispersy_tpu/traceplane.py``
- :class:`RecoveryConfig` — ``dispersy_tpu/recovery.py``
- :class:`OverloadConfig` — ``dispersy_tpu/overload.py``
- :class:`ParallelConfig` — ``dispersy_tpu/shardplane.py``

The copies make configs validate, compare and size state exactly as the
JAX package does; the engine runs the fault, recovery, overload and
parallel planes, and refuses telemetry and trace (``engine.check_slice``).
"""

from __future__ import annotations

import dataclasses

from dispersy_tpu_torch.exceptions import ConfigError

# telemetry.py: byte-lane u64 sums are exact only up to this population.
MAX_TELEMETRY_PEERS = (1 << 32) // 255 - 1
# faults.py health-sentinel bits (recovery.NUM_HEALTH_BITS counts them).
NUM_HEALTH_BITS = 4
# traceplane.py channel table width.
NUM_CHANNELS = 4


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Byte-diet store knobs; all defaults = the legacy every-round merge."""
    staging: int = 0
    compact_every: int = 8
    aux_bits: int = 32
    cohorts: int = 1
    cand_bits: int = 32

    def __post_init__(self) -> None:
        if self.staging < 0:
            raise ConfigError("store.staging must be >= 0")
        if self.compact_every < 1:
            raise ConfigError("store.compact_every must be >= 1")
        if self.aux_bits not in (16, 32):
            raise ConfigError("store.aux_bits must be 16 or 32")
        if self.aux_bits != 32 and self.staging == 0:
            raise ConfigError(
                "store.aux_bits narrowing rides the staged store layout "
                "— set store.staging > 0 too")
        if self.cohorts < 1:
            raise ConfigError("store.cohorts must be >= 1")
        if self.cohorts > 1 and self.staging == 0:
            raise ConfigError(
                "store.cohorts staggering rides the staged store layout "
                "— set store.staging > 0 too")
        if self.cohorts > 1 and self.compact_every % self.cohorts:
            raise ConfigError(
                "store.cohorts must divide compact_every: the cohort "
                "phases interleave one sync round every "
                "compact_every/cohorts rounds")
        if self.cand_bits not in (16, 32):
            raise ConfigError("store.cand_bits must be 16 or 32")
        if self.cand_bits != 32 and self.staging == 0:
            raise ConfigError(
                "store.cand_bits narrowing rides the staged store "
                "layout — set store.staging > 0 too")


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Correlated-fault knobs; all defaults = the fault-free round."""
    ge_p_bad: float = 0.0
    ge_p_good: float = 0.0
    ge_loss_good: float = 0.0
    ge_loss_bad: float = 0.0
    partitions: tuple = ()
    dup_rate: float = 0.0
    corrupt_rate: float = 0.0
    flood_senders: tuple = ()
    flood_fanout: int = 0
    health_checks: bool = False
    health_drop_limit: int = 64

    @property
    def ge_enabled(self) -> bool:
        return (self.ge_p_bad > 0.0
                and (self.ge_loss_bad > 0.0 or self.ge_loss_good > 0.0))

    @property
    def flood_enabled(self) -> bool:
        return bool(self.flood_senders) and self.flood_fanout > 0

    @property
    def any_channel(self) -> bool:
        return (self.ge_enabled or bool(self.partitions)
                or self.dup_rate > 0.0 or self.corrupt_rate > 0.0
                or self.flood_enabled)

    def __post_init__(self) -> None:
        for name in ("ge_p_bad", "ge_p_good", "ge_loss_good",
                     "ge_loss_bad", "dup_rate", "corrupt_rate"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ConfigError(f"{name} must be in [0, 1], got {v}")
        if self.ge_p_bad > 0.0 and self.ge_p_good <= 0.0 \
                and self.ge_loss_bad > 0.0:
            raise ConfigError(
                "ge_p_good must be > 0 when ge_p_bad > 0 (an absorbing "
                "bad state is a permanent partition — model that with "
                "`partitions` instead)")
        if (self.ge_loss_bad > 0.0 or self.ge_loss_good > 0.0) \
                and self.ge_p_bad <= 0.0:
            raise ConfigError(
                "ge_loss_* without ge_p_bad > 0 is inert (the channel "
                "never leaves the good state, so the GE loss is never "
                "compiled in): set ge_p_bad too, or use packet_loss for "
                "an i.i.d. loss floor")
        for pair in self.partitions:
            if (len(pair) != 2
                    or any(len(rng_) != 2 for rng_ in pair)):
                raise ConfigError(
                    "each partition entry is ((lo_a, hi_a), (lo_b, "
                    f"hi_b)); got {pair!r}")
            for lo, hi in pair:
                if not (0 <= lo < hi):
                    raise ConfigError(
                        f"partition range ({lo}, {hi}) must satisfy "
                        "0 <= lo < hi")
        if bool(self.flood_senders) != (self.flood_fanout > 0):
            raise ConfigError(
                "flood_senders and flood_fanout enable each other: set "
                "both (the attack) or neither")
        if len(set(self.flood_senders)) != len(self.flood_senders):
            raise ConfigError("flood_senders must be distinct")
        if any(s < 0 for s in self.flood_senders):
            raise ConfigError("flood_senders must be peer indices >= 0")
        if self.health_drop_limit < 1:
            raise ConfigError("health_drop_limit must be >= 1")

    def replace(self, **kw) -> "FaultModel":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Telemetry-plane knobs; all defaults = the telemetry-free round."""
    enabled: bool = False
    history: int = 0
    histograms: bool = False
    hist_buckets: int = 16
    flight_recorder: int = 0
    flight_per_round: int = 4

    def __post_init__(self) -> None:
        if self.history < 0:
            raise ConfigError("telemetry.history must be >= 0")
        if self.flight_recorder < 0:
            raise ConfigError("telemetry.flight_recorder must be >= 0")
        if not self.enabled and (self.history > 0 or self.histograms
                                 or self.flight_recorder > 0):
            raise ConfigError(
                "telemetry.history/histograms/flight_recorder all ride "
                "the fused in-step row — set telemetry.enabled=True too")
        if not (2 <= self.hist_buckets <= 64):
            raise ConfigError("telemetry.hist_buckets must be in [2, 64]")
        if self.flight_recorder > 0:
            if self.flight_per_round < 1:
                raise ConfigError(
                    "telemetry.flight_per_round must be >= 1")
            if self.flight_per_round > self.flight_recorder:
                raise ConfigError(
                    "telemetry.flight_per_round cannot exceed the ring "
                    "depth (one round's records would overwrite each "
                    "other)")

    def replace(self, **kw) -> "TelemetryConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Dissemination-tracing knobs; all defaults = the trace-free round."""
    enabled: bool = False
    tracked_slots: int = 4

    def __post_init__(self) -> None:
        if not (1 <= self.tracked_slots <= 16):
            raise ConfigError(
                f"trace.tracked_slots must be in [1, 16], got "
                f"{self.tracked_slots} (each slot is a u32+u8+u32 "
                "per-peer lineage column)")

    def replace(self, **kw) -> "TraceConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Recovery-plane knobs; all defaults = the recovery-free round."""
    enabled: bool = False
    soft_repair: bool = True
    backoff_limit: int = 6
    backoff_decay: float = 1.0
    quarantine_rounds: int = 32
    requarantine_window: int = 8

    def __post_init__(self) -> None:
        if not (0 <= self.backoff_limit <= 16):
            raise ConfigError(
                f"backoff_limit must be in [0, 16] (a u8 exponent whose "
                f"2^e period must fit u32), got {self.backoff_limit}")
        if not (0.0 <= self.backoff_decay <= 1.0):
            raise ConfigError(
                f"backoff_decay must be in [0, 1], got "
                f"{self.backoff_decay}")
        if self.quarantine_rounds < 0:
            raise ConfigError("quarantine_rounds must be >= 0")
        if self.requarantine_window < 1:
            raise ConfigError(
                "requarantine_window must be >= 1 (the hysteresis "
                "window; a 0-window could never observe a re-latch)")

    def replace(self, **kw) -> "RecoveryConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Ingress-protection knobs; all defaults = the protection-free round."""
    enabled: bool = False
    priority_admission: bool = True
    bucket_rate: float = 8.0
    bucket_depth: int = 32

    def __post_init__(self) -> None:
        if not (1 <= self.bucket_depth <= 255):
            raise ConfigError(
                f"bucket_depth must be in [1, 255] (a u8 credit "
                f"balance), got {self.bucket_depth}")
        if not (0.0 <= self.bucket_rate <= self.bucket_depth):
            raise ConfigError(
                f"bucket_rate must be in [0, bucket_depth="
                f"{self.bucket_depth}], got {self.bucket_rate} (a "
                "refill beyond the burst cap can never land)")

    def replace(self, **kw) -> "OverloadConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Multichip knobs; all defaults = the single-device round."""
    shards: int = 0
    cross_shard_budget: int = 0
    # The JAX package splits its Bloom scatter into row blocks to stay
    # under XLA's 2^31 scatter-index cap; the bits are the same for every
    # value, and the port's build has no such cap, so it reads none.
    scatter_chunks: int = 1

    def __post_init__(self) -> None:
        if self.shards < 0:
            raise ConfigError("parallel.shards must be >= 0")
        if self.cross_shard_budget < 0:
            raise ConfigError("parallel.cross_shard_budget must be >= 0")
        if self.cross_shard_budget > 0 and self.shards <= 1:
            raise ConfigError(
                "parallel.cross_shard_budget caps the cross-shard "
                "exchange — set parallel.shards > 1 too")
        if self.scatter_chunks < 1:
            raise ConfigError("parallel.scatter_chunks must be >= 1")
