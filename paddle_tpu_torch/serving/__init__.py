"""Serving: shape buckets, admission control and the continuous-batching
generation engine."""
from .admission import (AdmissionController, DeadlineExceeded,
                        EngineClosed, RequestRejected)
from .bucketing import (BucketPolicy, ExecutableCache, bucket_shape,
                        next_bucket, pad_batch, seq_buckets)
from .engine import (GenerationEngine, GenerationEngineConfig,
                     GenerationStream)

__all__ = ["AdmissionController", "DeadlineExceeded", "EngineClosed",
           "RequestRejected", "BucketPolicy", "ExecutableCache",
           "bucket_shape", "next_bucket", "pad_batch", "seq_buckets",
           "GenerationEngine", "GenerationEngineConfig", "GenerationStream"]
