"""Serving of the port: the in-process batching model server.

The port of ``mxnet_tpu/serving`` less the fleet: the offline bucket
planner (:mod:`.buckets`), the continuous batcher (:mod:`.batcher`: a
bounded queue, a scheduler thread and two FIFO pipeline workers, with
structured 429/503 backpressure), the block-paged KV cache
(:mod:`.kvcache`), the prefill/decode engine and its batcher entry
(:mod:`.generate`), ``serve`` telemetry (:mod:`.telemetry`) and
:class:`ModelServer` (:mod:`.server`), which serves Symbol models
(``add_model``) and generative LMs (``add_generative_model``) side by
side.  The multi-replica fleet is a later slice (``ROADMAP.md``).
"""
from __future__ import annotations

from .buckets import (BucketPlan, bucket_for, model_matmul_dims,
                      parse_buckets, parse_histogram, plan_buckets,
                      plan_cost, pow2_buckets, request_waste)
from .batcher import ContinuousBatcher, Future, Request, ServerBusy
from .kvcache import CacheExhausted, KVCacheConfig, PagedKVCache
from .generate import (GenerationEngine, GenerativeEntry, TokenStream,
                       generation_mats)
from .server import ModelServer, checkpoint_files
from .telemetry import (emit_batch, serve_report, fleet_report,
                        set_fleet_context)

__all__ = [
    "BucketPlan", "bucket_for", "model_matmul_dims", "parse_buckets",
    "parse_histogram", "plan_buckets", "plan_cost", "pow2_buckets",
    "request_waste",
    "ContinuousBatcher", "Future", "Request", "ServerBusy",
    "CacheExhausted", "KVCacheConfig", "PagedKVCache",
    "GenerationEngine", "GenerativeEntry", "TokenStream",
    "generation_mats",
    "ModelServer", "checkpoint_files",
    "emit_batch", "serve_report", "fleet_report", "set_fleet_context",
]
