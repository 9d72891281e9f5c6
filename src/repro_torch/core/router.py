"""Adaptive per-chunk codec routing (DESIGN.md §11).

The paper's 20× compression holds only on text the predictor itself
could have generated; on human or cross-model text the LLM path degrades
sharply — below gzip in the adversarial cases (Llamazip's training-set
detection and "The Statistical Signature of LLMs" are exactly this
signal, PAPERS.md). The router closes that loop: per chunk, estimate
model fit from early cross-entropy and fall back to a dictionary codec
(zstd/lzma) or raw store when the LLM path would lose, so routed
compression never loses to the best fallback on any input. The chosen
codec is recorded per chunk in the v5 container's index footer
(core/compressor.py), so decode never guesses — the recorded tag is the
routing decision, bit-exact by construction.

Division of labour:

* this module owns the *policy*: the probe heuristic, fallback-codec
  selection, and the token<->byte packing fallback streams use. It deals
  in codec **names**; container codec *ids* belong to the container
  layer (``compressor.CODEC_NAMES``), which keeps this module free of
  wire-format knowledge (and free of import cycles).
* ``core/baselines.py`` owns the fallback byte codecs themselves
  (``compress_bytes``/``decompress_bytes``).
* ``core/compressor.py`` and ``service/`` own the mechanism: where the
  probe runs, which chunks enter the model batch, and the final
  realized-size comparison after an LLM encode.

Routing is encode-side only and advisory until written: a sloppy probe
can cost ratio, never correctness — the decoder reconstructs each chunk
with the codec named by its tag, and the entropy-coded chunks still
carry the exact-CDF guarantee of the LLM path.

Fallback stream layout (the per-chunk bytes a fallback codec tag
selects):  ``u8 token_width (1|2|4) || codec payload``, where the
payload is ``compress_bytes(codec, tokens packed little-endian at
token_width bytes each)``. The width is chosen per chunk from the
chunk's max token id, so byte-tokenized data (vocab 258, tokens < 256
in practice) packs at 1 byte/token and raw store of random bytes costs
~8 bits/token, not 16.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .baselines import available_byte_codecs, compress_bytes, decompress_bytes
from .cdf import full_logits, to_numpy

#: routes that run the LLM entropy path for every chunk
ROUTE_LLM = "llm"
#: probe-and-compare adaptive routing
ROUTE_AUTO = "auto"


def pack_tokens(tokens: np.ndarray) -> tuple[int, bytes]:
    """Pack a token vector into little-endian fixed-width bytes; returns
    ``(width, packed)``. Width is the smallest of 1/2/4 bytes that holds
    the chunk's max token id."""
    tokens = np.asarray(tokens)
    hi = int(tokens.max(initial=0))
    if hi < (1 << 8):
        width, dt = 1, np.uint8
    elif hi < (1 << 16):
        width, dt = 2, np.dtype("<u2")
    else:
        width, dt = 4, np.dtype("<u4")
    return width, tokens.astype(dt).tobytes()


def unpack_tokens(packed: bytes, width: int, n_tokens: int,
                  vocab: int) -> np.ndarray:
    """Inverse of ``pack_tokens``. Validates length and token range —
    a crafted stream must fail loudly, never decode out-of-vocab ids."""
    if width not in (1, 2, 4):
        raise ValueError(f"corrupt fallback stream: token width {width}")
    if len(packed) != width * n_tokens:
        raise ValueError(
            f"corrupt fallback stream: {len(packed)} payload bytes for "
            f"{n_tokens} tokens at width {width}")
    dt = {1: np.uint8, 2: np.dtype("<u2"), 4: np.dtype("<u4")}[width]
    toks = np.frombuffer(packed, dtype=dt).astype(np.int32)
    if toks.size and int(toks.max()) >= vocab:
        raise ValueError(
            f"corrupt fallback stream: token id {int(toks.max())} "
            f">= vocab {vocab}")
    return toks


@dataclass
class RouterConfig:
    """Routing policy knobs.

    * ``fallbacks`` — candidate fallback codec names in preference order;
      None means every available codec (zstd when the optional
      ``zstandard`` package is importable, always lzma and raw).
    * ``probe_tokens`` — positions of early cross-entropy the probe
      scores before deciding whether a chunk enters the model batch.
    * ``skip_margin`` — the LLM path is skipped only when its estimated
      bits exceed ``margin ×`` the fallback's realized bits, where
      ``margin`` starts at ``skip_margin`` and — with
      ``adaptive_margin`` — is updated per traffic class from
      probe-vs-realized history (see ``CodecRouter.observe``). > 1 is
      conservative: a borderline chunk still gets the LLM encode plus
      the final realized-size comparison, so probe noise costs model
      time, not ratio.
    * ``adaptive_margin`` / ``margin_floor`` / ``margin_ceil`` /
      ``margin_alpha`` — the calibration loop: when realized LLM bits
      run hotter than the probe estimated (the probe flatters the
      model — adversarial traffic whose tail degrades after the probed
      prefix), the effective margin shrinks toward ``margin_floor`` so
      such chunks skip sooner; when realized bits run cooler
      (predictable traffic the early-CE probe under-credits), it grows
      toward ``margin_ceil``. ``margin_alpha`` is the EMA step. The
      floor is a safety clamp: the margin never drops below it, so a
      burst of bad luck cannot lock the router out of the LLM path.
    """
    fallbacks: tuple | None = None
    probe_tokens: int = 32
    skip_margin: float = 1.25
    adaptive_margin: bool = True
    margin_floor: float = 1.05
    margin_ceil: float = 2.0
    margin_alpha: float = 0.25


@dataclass
class RouteDecision:
    """One chunk's routing record (diagnostics; the wire carries only
    the final codec tag)."""
    codec: str                  # final codec name
    fallback_bytes: int         # realized best-fallback stream size
    llm_bits_est: float = -1.0  # probe estimate (-1: no probe ran)
    flipped: bool = False       # LLM encode ran but fallback won


class CodecRouter:
    """Per-chunk codec selection policy.

    Decisions are per-chunk and order-independent, but the router keeps
    one piece of *calibration* state: a per-traffic-class EMA of the
    realized-vs-estimated LLM bit ratio, fed by ``observe`` after each
    LLM encode and consumed by ``margin_for``. Calibration only tunes
    the probe's skip threshold — it can cost model time, never
    correctness (the final realized-size flip still runs on every
    LLM-encoded chunk, and decode follows the recorded tags)."""

    def __init__(self, config: RouterConfig | None = None):
        self.config = config or RouterConfig()
        # traffic class -> EMA of (realized llm bits / probe estimate)
        self._calibration: dict[str, float] = {}

    @staticmethod
    def traffic_class(est_bits: float, fallback_bytes: int) -> str:
        """Coarse traffic class from the probe's own signals: how the
        estimated LLM cost compares to the realized fallback. Classes
        keep calibration from mixing regimes — the probe's bias on
        model-friendly text says nothing about its bias on adversarial
        bytes."""
        fb_bits = 8.0 * max(1, fallback_bytes)
        r = est_bits / fb_bits
        if r < 0.75:
            return "predictable"
        if r < 1.5:
            return "borderline"
        return "adversarial"

    def margin_for(self, cls: str) -> float:
        """Effective skip margin for a traffic class: the configured
        ``skip_margin`` divided by the class's realized/estimated ratio
        (estimates running hot shrink the margin — skip sooner),
        clamped to [margin_floor, margin_ceil]."""
        cfg = self.config
        rho = self._calibration.get(cls)
        if not cfg.adaptive_margin or rho is None:
            return cfg.skip_margin
        return float(np.clip(cfg.skip_margin / rho, cfg.margin_floor,
                             cfg.margin_ceil))

    def observe(self, est_bits: float, llm_bits: float,
                fallback_bytes: int) -> None:
        """Feed one probe-vs-realized observation (an LLM-encoded
        chunk's probe estimate and realized code length) into the
        class's calibration EMA. Chunks that skipped the model have no
        realized LLM size and are never observed — the estimate is the
        only thing being calibrated."""
        if est_bits <= 0 or llm_bits <= 0:
            return
        cls = self.traffic_class(est_bits, fallback_bytes)
        rho = llm_bits / est_bits
        old = self._calibration.get(cls)
        a = self.config.margin_alpha
        self._calibration[cls] = rho if old is None \
            else (1.0 - a) * old + a * rho

    def fallback_candidates(self) -> list[str]:
        """Usable fallback codec names, honouring the configured
        preference list and current zstd availability."""
        avail = available_byte_codecs()
        want = self.config.fallbacks
        if want is None:
            return avail
        names = [n for n in want if n in avail]
        if not names:
            raise ValueError(
                f"no configured fallback codec is available "
                f"(wanted {list(want)}, available {avail})")
        return names

    def best_fallback(self, tokens: np.ndarray) -> tuple[str, bytes]:
        """Realized best fallback stream for a chunk's tokens: every
        candidate codec actually runs and the smallest stream wins (raw
        store is always a candidate, so the result can never exceed
        packed size + 1 width byte)."""
        width, packed = pack_tokens(tokens)
        best_name, best = None, None
        for name in {*self.fallback_candidates(), "raw"}:
            blob = compress_bytes(name, packed)
            if best is None or len(blob) < len(best) \
                    or (len(blob) == len(best) and name < best_name):
                best_name, best = name, blob
        return best_name, bytes([width]) + best

    def skip_llm(self, est_bits: float, fallback_stream: bytes) -> bool:
        """True when the probe estimate says the LLM path would lose by
        more than the (class-calibrated) safety margin — the chunk then
        skips the model entirely (the service never gives it a slot)."""
        margin = self.margin_for(
            self.traffic_class(est_bits, len(fallback_stream)))
        return est_bits > margin * 8.0 * len(fallback_stream)

    @staticmethod
    def decode_fallback(codec_name: str, stream: bytes, n_tokens: int,
                        vocab: int) -> np.ndarray:
        """Decode one fallback chunk stream back to tokens. Raises
        ValueError on any structural problem (the container layer wraps
        this into ContainerError)."""
        if len(stream) < 2:
            raise ValueError(
                f"corrupt fallback stream: {len(stream)} bytes cannot "
                f"code {n_tokens} tokens")
        try:
            packed = decompress_bytes(codec_name, stream[1:])
        except ValueError:
            raise
        except Exception as e:     # zstd/lzma backend errors
            raise ValueError(f"corrupt {codec_name} fallback stream: {e}")
        return unpack_tokens(packed, stream[0], n_tokens, vocab)


def route_chunks(router: CodecRouter, predictor, chunks: np.ndarray,
                 valid: np.ndarray, llm_codec: str,
                 auto: bool) -> tuple[list[RouteDecision], list]:
    """Shared encode-side routing pass (the grouped compressor and the
    service scheduler both call this, so their policies cannot drift).

    Realizes the best fallback stream for every chunk, then — in auto
    mode — runs ONE prefill probe over the first ``probe_tokens``
    positions of all chunks and marks each chunk either ``llm_codec``
    (enter the model batch; the realized-size comparison still happens
    after encode) or its fallback codec name (skip the model entirely).
    Returns ``(decisions, fallback_streams)`` with ``fallback_streams[i]
    = (codec_name, stream)``."""
    from repro_torch.obs import trace as _trace
    n_chunks = chunks.shape[0] if len(chunks) else 0
    with _trace.span("router.fallback"):
        fb = [router.best_fallback(chunks[i, :int(valid[i])])
              for i in range(n_chunks)]
    if not auto:
        return [RouteDecision(name, len(s)) for name, s in fb], fb
    if not n_chunks:
        return [], fb
    with _trace.span("router.probe"):
        P = min(router.config.probe_tokens, chunks.shape[1])
        # the port's predictor returns device logits: one host copy here
        # (a mesh predictor's gathered: the estimate reads every id)
        logits = to_numpy(full_logits(
            predictor.score_chunks(chunks[:, :P])))
        est = estimate_chunk_bits(logits, chunks, valid, P)
    return [RouteDecision(name if router.skip_llm(float(est[i]), s)
                          else llm_codec, len(s), float(est[i]))
            for i, (name, s) in enumerate(fb)], fb


def estimate_chunk_bits(logits: np.ndarray, tokens: np.ndarray,
                        valid: np.ndarray,
                        probe: int) -> np.ndarray:
    """Early-cross-entropy probe: given teacher-forced logits for the
    first ``probe`` positions of each chunk (``logits[:, t]`` predicts
    ``tokens[:, t]``), return the per-chunk *whole-chunk* LLM bit
    estimate — mean scored bits/token extrapolated to ``valid`` tokens.

    The probe is advisory (the decision is recorded in the container,
    decode never re-runs it), so prefill-scored logits are fine here
    even though the exact encode scores through the decode program."""
    logits = np.asarray(logits, np.float64)
    tokens = np.asarray(tokens, np.int64)
    valid = np.asarray(valid, np.int64)
    P = min(probe, logits.shape[1])
    lp = logits[:, :P]
    lp = lp - lp.max(axis=-1, keepdims=True)
    lse = np.log(np.exp(lp).sum(axis=-1))
    tok_lp = np.take_along_axis(lp, tokens[:, :P, None], axis=-1)[..., 0]
    scored = np.minimum(valid, P)
    m = np.arange(P)[None, :] < scored[:, None]
    bits = ((lse - tok_lp) * m).sum(axis=1) / np.log(2.0)
    per_tok = bits / np.maximum(scored, 1)
    return per_tok * valid
