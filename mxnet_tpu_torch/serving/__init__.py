"""Generative serving of the port: paged KV cache, bucket planner and
the prefill/decode engine.  ``ModelServer``, the batcher and the fleet
are later slices."""
from .kvcache import CacheExhausted, KVCacheConfig, PagedKVCache  # noqa: F401
from .buckets import BucketPlan, plan_buckets                      # noqa: F401
from .generate import GenerationEngine, TokenStream, generation_mats  # noqa: F401
