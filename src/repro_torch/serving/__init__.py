"""Bucket-batched analog serving (port of ``repro/serving``): shape
buckets, execution tiers (uniform K, per-layer ``PrecisionProfile`` and
digital tiers behind one ``ExecutionTier`` interface and ``TierRegistry``),
precision-tiered scheduling, persistent per-tier decode slot pools
(continuous batching), fault injection, the noise-drift watchdog and the
streaming ``MetricsFeed`` (faults.py, monitor.py), the SLA precision
governor (policy.py), a replicated cluster router with health-checked
failover and hedged dispatch (cluster.py), and the engine tying them to
``models/lm.py`` through the executable cache (cache.py: each step a CUDA
graph on the card)."""
from repro_torch.core.profile import PrecisionProfile
from repro_torch.serving.bucketing import (
    DEFAULT_BATCH_BUCKETS,
    DEFAULT_SEQ_BUCKETS,
    bucket_shape,
    next_bucket,
    pad_to_bucket,
    pool_shape,
)
from repro_torch.serving.cache import ExecutableCache, mesh_fingerprint
from repro_torch.serving.cluster import ClusterGovernor, ClusterRouter, RequestJournalEntry
from repro_torch.serving.engine import Failed, RequestFailure, ServingEngine, TimedOut
from repro_torch.serving.faults import (
    BoundedLog,
    DriftRamp,
    FaultPlan,
    QueueFull,
    ReplicaCrash,
    ReplicaDegraded,
    ReplicaFault,
    ReplicaHang,
    TransientExecutableFault,
)
from repro_torch.serving.monitor import (
    DriftEvent,
    LoadSignals,
    MetricsFeed,
    NoiseDriftWatchdog,
    WatchdogConfig,
    load_signals,
)
from repro_torch.serving.policy import PolicyConfig, PolicyEvent, PrecisionGovernor, TierSpec
from repro_torch.serving.pool import DecodePool, SlotAllocator, SlotRecord
from repro_torch.serving.scheduler import Request, TierScheduler
from repro_torch.serving.tiers import (
    AnalogProfileTier,
    DigitalTier,
    ExecutionTier,
    Int8DigitalTier,
    TierRegistry,
    UniformKTier,
)

__all__ = [
    "AnalogProfileTier",
    "BoundedLog",
    "ClusterGovernor",
    "ClusterRouter",
    "DEFAULT_BATCH_BUCKETS",
    "DEFAULT_SEQ_BUCKETS",
    "DecodePool",
    "DigitalTier",
    "DriftEvent",
    "DriftRamp",
    "ExecutableCache",
    "ExecutionTier",
    "Failed",
    "FaultPlan",
    "Int8DigitalTier",
    "LoadSignals",
    "MetricsFeed",
    "NoiseDriftWatchdog",
    "PolicyConfig",
    "PolicyEvent",
    "PrecisionGovernor",
    "PrecisionProfile",
    "QueueFull",
    "ReplicaCrash",
    "ReplicaDegraded",
    "ReplicaFault",
    "ReplicaHang",
    "Request",
    "RequestFailure",
    "RequestJournalEntry",
    "ServingEngine",
    "SlotAllocator",
    "SlotRecord",
    "TierRegistry",
    "TierScheduler",
    "TierSpec",
    "TimedOut",
    "TransientExecutableFault",
    "UniformKTier",
    "WatchdogConfig",
    "bucket_shape",
    "load_signals",
    "mesh_fingerprint",
    "next_bucket",
    "pad_to_bucket",
    "pool_shape",
]
