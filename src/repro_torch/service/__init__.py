"""Continuous-batching compression service (DESIGN.md §8).

The serving layer over the paper's chunked compressor: many independent
compress *and* decompress jobs are multiplexed into the same fixed-shape
(B,) decode steps of one jitted model program. When a chunk-stream
finishes, its slot is refilled from a priority queue instead of waiting
for the rest of its group — the lever that the chunk-independence of the
format (§5.4) makes safe and that the per-slot cache positions
(models/*, serve/engine.reset_slots) make bit-exact.

    service = CompressionService(predictor, slots=16, chunk_size=256,
                                 topk=48)
    h1 = service.submit_compress(tokens_a)
    h2 = service.submit_compress(tokens_b, priority=-1)   # jumps the queue
    h3 = service.submit_decompress(blob_c)
    blob_a, stats = h1.result()       # drives the scheduler as needed
    tokens_c = h3.result()

Containers written by the service are version 4 (seekable index footer +
xxh64 checksums), v5 with routing, or v6 when a job declares context
(``submit_compress(shared_prefix=..., context_window=W)``); it decodes
v2–v6 archives from any writer. Shared-prefix jobs reuse one prefilled
KV prefix through a radix prefix cache (``RadixPrefixCache``).
"""
from .api import CompressionService, ServiceError
from .prefix_cache import RadixPrefixCache
from .scheduler import SchedulerStats, SlotScheduler
from .session import ChunkTask, Job, JobHandle

__all__ = ["CompressionService", "ServiceError", "SlotScheduler",
           "SchedulerStats", "ChunkTask", "Job", "JobHandle",
           "RadixPrefixCache"]
