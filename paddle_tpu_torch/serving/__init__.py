"""Serving: shape buckets, admission control and the continuous-batching
generation engine."""
from .admission import (AdmissionController, DeadlineExceeded,
                        EngineClosed, RequestRejected)
from .bucketing import next_bucket, seq_buckets
from .engine import (GenerationEngine, GenerationEngineConfig,
                     GenerationStream)

__all__ = ["AdmissionController", "DeadlineExceeded", "EngineClosed",
           "RequestRejected", "next_bucket", "seq_buckets",
           "GenerationEngine", "GenerationEngineConfig", "GenerationStream"]
