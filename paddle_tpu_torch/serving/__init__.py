"""Serving: shape buckets, admission control, the continuous-batching
generation engines (contiguous and paged) and their HTTP frontend."""
from .admission import (PRIORITIES, AdmissionController, DeadlineExceeded,
                        DrainRateEstimator, EngineClosed, QuotaWatcher,
                        RequestRejected, TenantQuotaTable, priority_rank)
from .bucketing import (BucketPolicy, ExecutableCache, bucket_shape,
                        next_bucket, pad_batch, seq_buckets)
from .engine import (GenerationEngine, GenerationEngineConfig,
                     GenerationStream, PagedGenerationEngine)
from .server import ServingServer, serve

__all__ = ["AdmissionController", "DeadlineExceeded", "DrainRateEstimator",
           "EngineClosed", "QuotaWatcher", "RequestRejected",
           "TenantQuotaTable", "PRIORITIES", "priority_rank", "BucketPolicy",
           "ExecutableCache", "bucket_shape", "next_bucket", "pad_batch",
           "seq_buckets", "GenerationEngine", "GenerationEngineConfig",
           "GenerationStream", "PagedGenerationEngine", "ServingServer",
           "serve"]
