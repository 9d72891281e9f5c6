"""Serving engine: lock-step decode over the port's models.

``ModelPredictor`` implements the compressor's ``PredictorAdapter``
(core/compressor.py) over a dense model in PyTorch, as the JAX package's
``serve/engine.py`` does over its model zoo:

  * ``begin_decode`` — a fresh per-lane KV cache; with a ``prefix``, the
    cache consumes [BOS, prefix[:, :-1]] by replaying the decode step,
    so it is bit-identical to the same steps taken one by one;
  * ``decode_step`` — one token for every lane. The logits come back as
    a **device tensor** (B, V): the CDF kernels read them on the card,
    and only the small (ids, cdf) tables cross to the host;
  * ``reset_slots`` / ``set_decode_len`` — the continuous-batching
    scheduler's slot refill and cache geometry.

The BOS convention: the model input for chunk tokens x_0..x_{C-1} is
[BOS, x_0, .., x_{C-2}], so logits[t] parameterizes P(x_t | x_<t) with a
fresh context per chunk — the paper's chunked setup (§5.4).

Not ported yet (they raise ``NotImplementedError``): ``score_chunks``
(teacher-forced prefill; needs the flash-attention kernel),
``verify_steps``/``rollback`` (speculative decode) and
``snapshot_slot``/``restore_slot`` (the radix prefix cache).

Determinism: TF32 matrix products are switched off explicitly
(``torch.backends.cuda.matmul.allow_tf32 = False``), and bf16 products
keep fp32 reductions, so a lane's logits depend on its own cache and
input only, at a fixed batch size; the kernels reduce in a fixed order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import api as model_api


class ModelPredictor:
    """PredictorAdapter over the port's models (one device)."""

    def __init__(self, params, cfg: ModelConfig, *, bos_id: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full fp32 products and fp32 reductions for bf16 products,
            # set explicitly rather than trusted to defaults
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = False
        model_api.module_for(cfg)           # refuses unported families
        self.params = params
        self.cfg = cfg
        self.vocab_size = cfg.vocab_size
        self.bos_id = bos_id if bos_id is not None else cfg.vocab_size - 1
        self._decode_max_len = 1024

    @classmethod
    def random_init(cls, cfg: ModelConfig, *, seed: int = 0, device=None,
                    **kw) -> "ModelPredictor":
        """A predictor with random weights made from ``seed`` directly on
        ``device`` (the card unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        return cls(model_api.init_params(cfg, seed, dev), cfg, device=dev,
                   **kw)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)

    @torch.no_grad()
    def _decode(self, cache, prev: torch.Tensor):
        logits, cache = model_api.decode_step(self.params, self.cfg, cache,
                                              prev)
        return logits[..., :self.cfg.vocab_size], cache

    # --------------------------------------------------- PredictorAdapter
    def begin_decode(self, batch: int, prefix: np.ndarray | None = None):
        """Fresh decode cache for ``batch`` lanes. With ``prefix`` (B, P)
        or (P,), the cache has consumed [BOS, prefix[:, :-1]] through the
        decode step itself (bit-identical to sequential decode_step
        calls); the caller feeds prefix[:, -1] as the first decode_step
        input."""
        cache = model_api.init_cache(self.cfg, batch, self._decode_max_len,
                                     device=self.device)
        if prefix is not None:
            prefix = np.asarray(prefix, np.int64)
            if prefix.ndim == 1:
                prefix = np.broadcast_to(prefix[None],
                                         (batch, prefix.shape[0]))
            inp = np.concatenate(
                [np.full((batch, 1), self.bos_id, np.int64),
                 prefix[:, :-1]], axis=1)
            with obs.span("model.prefill"):
                for t in range(inp.shape[1]):
                    _, cache = self._decode(cache, self._tokens(inp[:, t]))
        return cache

    def set_decode_len(self, n: int):
        self._decode_max_len = int(n)

    def decode_step(self, state, prev_tokens: np.ndarray):
        with obs.span("model.decode_step"):
            return self._decode(state, self._tokens(prev_tokens))

    @torch.no_grad()
    def reset_slots(self, state, mask: np.ndarray):
        """Reset the cache lanes selected by ``mask`` (B,) bool to a fresh
        context (pos 0, K/V zeroed) without touching the other lanes —
        the slot-refill primitive of the continuous-batching scheduler.
        In place; zeroing K/V is hygiene (the per-lane length already
        hides stale entries)."""
        with obs.span("model.reset_slots"):
            lanes = torch.as_tensor(np.nonzero(np.asarray(mask, bool))[0],
                                    device=self.device)
            if lanes.numel():
                state["k"][:, lanes] = 0
                state["v"][:, lanes] = 0
                state["pos"][lanes] = 0
            return state

    # ------------------------------------------------- not ported yet
    def score_chunks(self, tokens, prefix=None):
        raise NotImplementedError(
            "score_chunks (teacher-forced prefill scoring: exact=False, the "
            "router probe, scored context) needs the flash-attention kernel "
            "and is not ported yet")

    def verify_steps(self, state, seq):
        raise NotImplementedError(
            "verify_steps (speculative decode) is not ported yet")

    def rollback(self, snapshots, accepted):
        raise NotImplementedError(
            "rollback (speculative decode) is not ported yet")

    def snapshot_slot(self, state, lane: int):
        raise NotImplementedError(
            "snapshot_slot (radix prefix cache) is not ported yet")

    def restore_slot(self, state, snapshot, mask):
        raise NotImplementedError(
            "restore_slot (radix prefix cache) is not ported yet")
