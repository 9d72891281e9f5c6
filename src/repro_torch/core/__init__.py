"""Core of the paper's contribution: LLM next-token prediction as the
probability model for lossless entropy coding (arithmetic or rANS)."""
from .ac import ArithmeticDecoder, ArithmeticEncoder, uniform_cdf
from .baselines import (BYTE_CODECS, available_byte_codecs, compress_bytes,
                        decompress_bytes)
from .cdf import (coding_cost_bits, logits_to_cdf, pmf_to_cdf,
                  quantize_pmf, topk_quantized)
from .checksum import xxh64
from .compressor import (CODEC_IDS, CODEC_NAMES, FALLBACK_CODEC_IDS,
                         RECIPE_CARRY, RECIPE_NONE, RECIPE_SHARED,
                         VERSION_V3, VERSION_V4, VERSION_V5, VERSION_V6,
                         ChunkEntry, CompressionStats, ContainerError,
                         ContainerInfo, LLMCompressor, PredictorAdapter,
                         assign_context_recipes, container_is_model_free,
                         context_budget,
                         decompress_model_free, decompress_range_model_free,
                         parse_container, read_header, read_index,
                         recipe_context, write_container)
from .draft import ConstantDraft, DraftProposer, OracleDraft, SuffixDraft
from .rans import BatchedRansDecoder, BatchedRansEncoder, SlotRansEncoder
from .router import (ROUTE_AUTO, ROUTE_LLM, CodecRouter, RouteDecision,
                     RouterConfig, pack_tokens, unpack_tokens)

__all__ = [
    "ArithmeticDecoder", "ArithmeticEncoder", "uniform_cdf",
    "BatchedRansDecoder", "BatchedRansEncoder", "SlotRansEncoder",
    "BYTE_CODECS", "available_byte_codecs", "compress_bytes",
    "decompress_bytes",
    "coding_cost_bits", "logits_to_cdf", "pmf_to_cdf", "quantize_pmf",
    "topk_quantized", "xxh64",
    "CODEC_IDS", "CODEC_NAMES", "FALLBACK_CODEC_IDS",
    "RECIPE_CARRY", "RECIPE_NONE", "RECIPE_SHARED",
    "VERSION_V3", "VERSION_V4", "VERSION_V5", "VERSION_V6",
    "ChunkEntry", "CompressionStats", "ContainerError", "ContainerInfo",
    "LLMCompressor", "PredictorAdapter",
    "assign_context_recipes", "container_is_model_free",
    "context_budget",
    "decompress_model_free", "decompress_range_model_free",
    "recipe_context",
    "ConstantDraft", "DraftProposer", "OracleDraft", "SuffixDraft",
    "ROUTE_AUTO", "ROUTE_LLM", "CodecRouter", "RouteDecision",
    "RouterConfig", "pack_tokens", "unpack_tokens",
    "parse_container", "read_header", "read_index", "write_container",
]
