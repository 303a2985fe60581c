"""Serving: shape buckets, admission control and the continuous-batching
generation engines (contiguous and paged)."""
from .admission import (PRIORITIES, AdmissionController, DeadlineExceeded,
                        EngineClosed, RequestRejected, priority_rank)
from .bucketing import (BucketPolicy, ExecutableCache, bucket_shape,
                        next_bucket, pad_batch, seq_buckets)
from .engine import (GenerationEngine, GenerationEngineConfig,
                     GenerationStream, PagedGenerationEngine)

__all__ = ["AdmissionController", "DeadlineExceeded", "EngineClosed",
           "RequestRejected", "PRIORITIES", "priority_rank", "BucketPolicy",
           "ExecutableCache", "bucket_shape", "next_bucket", "pad_batch",
           "seq_buckets", "GenerationEngine", "GenerationEngineConfig",
           "GenerationStream", "PagedGenerationEngine"]
