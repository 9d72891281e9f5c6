"""Serving engine: lock-step decode over the port's models.

``ModelPredictor`` implements the compressor's ``PredictorAdapter``
(core/compressor.py) over the port's models (dense, moe, ssm and hybrid) in
PyTorch, as the JAX package's ``serve/engine.py`` does over its model
zoo:

  * ``score_chunks`` — one teacher-forced ``forward`` over (B, C) chunks,
    fresh or under a scored ``prefix`` (the router probe, ``exact=False``
    and scored context). Its logits come back as a **device tensor**
    (B, C, V), as ``decode_step``'s do;
  * ``begin_decode`` — a fresh per-lane cache (K/V for the dense family:
    int8 with per-row scales under ``kv_cache_dtype="int8"``, a ring of
    min(max_len, W) slots under a sliding window W; conv and SSM state
    for the ssm family; both for the hybrid: the states of its SSD layers
    and K/V per application of its shared block); with a ``prefix``, the
    cache consumes [BOS, prefix[:, :-1]] by replaying the decode step, so
    it is bit-identical to the same steps taken one by one;
  * ``decode_step`` — one token for every lane. The logits come back as
    a **device tensor** (B, V): the CDF kernels read them on the card,
    and only the small (ids, cdf) tables cross to the host;
  * ``verify_steps`` / ``rollback`` — speculative decode: T steps in one
    program, and each lane rewound, in place, to the state after the
    inputs it accepted;
  * ``snapshot_slot`` / ``restore_slot`` — one lane copied out, and
    written back into masked lanes in place (the radix prefix cache);
  * ``reset_slots`` / ``set_decode_len`` — the continuous-batching
    scheduler's slot refill and cache geometry;
  * ``generate`` — autoregressive sampling through ``decode_step`` (the
    LLM-generated corpora of the paper's experiments).

On the card every decode step is the replay of a captured CUDA graph
(``serve/graphs.py``), the counterpart of the JAX engine's jitted step:
``decode_step``, the prefill of ``begin_decode(prefix=...)`` and, T steps
to a graph, ``verify_steps``. Their outputs live in the graphs' static
buffers and the next call on the same cache overwrites them. Every call
here writes the cache in place, so its leaves keep their storage, which
the graphs need. On the CPU the same step runs eagerly.

The BOS convention: the model input for chunk tokens x_0..x_{C-1} is
[BOS, x_0, .., x_{C-2}], so logits[t] parameterizes P(x_t | x_<t) with a
fresh context per chunk — the paper's chunked setup (§5.4).

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
from . import graphs


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
        self._programs = None if self.device.type == "cpu" else \
            graphs.DecodePrograms(self._init_cache, self._step_body,
                                  model_api.rollback_leaves(cfg),
                                  self.device, model_api.ring_leaves(cfg))

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

    def _init_cache(self, batch: int, max_len: int) -> dict:
        return model_api.init_cache(self.cfg, batch, max_len,
                                    device=self.device)

    def _step_body(self, cache, prev: torch.Tensor) -> torch.Tensor:
        """The decode step's body: the cache advanced in place, logits
        (B, V) returned. What the card captures, and what the CPU runs."""
        logits, _ = model_api.decode_step(self.params, self.cfg, cache, prev)
        return logits[..., :self.cfg.vocab_size]

    @torch.no_grad()
    def _step(self, state, prev) -> torch.Tensor:
        if self._programs is None:
            return self._step_body(state, self._tokens(prev))
        return self._programs.step(state, prev)

    @torch.no_grad()
    def _eager_decode_step(self, state, prev_tokens: np.ndarray):
        """``decode_step`` run eagerly on any device, for holding the
        captured step against it (the card tests, ``chip_smoke.py``):
        (logits (B, V), state), the state advanced in place."""
        return self._step_body(state, self._tokens(prev_tokens)), state

    # --------------------------------------------------- PredictorAdapter
    @torch.no_grad()
    def score_chunks(self, tokens, prefix=None) -> torch.Tensor:
        """Teacher-forced logits (B, C, V) for (B, C) chunks: the model
        input is [BOS, x_0 .. x_{C-2}], so logits[:, t] predicts x_t. With
        ``prefix`` (B, P) or (P,), the input is [BOS, prefix, x_0 ..
        x_{C-2}] and only the last C positions come back — position t is
        scored given [prefix, x_<t] (the v6 scored-context form). A device
        tensor, as ``decode_step`` returns."""
        with obs.span("model.score"):
            tokens = np.asarray(tokens, np.int64)
            B = tokens.shape[0]
            parts = [np.full((B, 1), self.bos_id, np.int64)]
            P = 0
            if prefix is not None:
                prefix = np.asarray(prefix, np.int64)
                if prefix.ndim == 1:
                    prefix = np.broadcast_to(prefix[None],
                                             (B, prefix.shape[0]))
                P = prefix.shape[1]
                parts.append(prefix)
            inp = np.concatenate(parts + [tokens[:, :-1]], axis=1)
            logits = model_api.forward(self.params, self.cfg,
                                       {"tokens": self._tokens(inp)})
            return logits[:, P:, :self.cfg.vocab_size]

    def begin_decode(self, batch: int, prefix: np.ndarray | None = None):
        """Fresh decode cache for ``batch`` lanes. With ``prefix`` (B, P)
        or (P,), the cache has consumed [BOS, prefix[:, :-1]] through the
        decode step itself (bit-identical to sequential decode_step
        calls); the caller feeds prefix[:, -1] as the first decode_step
        input. On the card a cache that no caller holds any longer is
        handed out again, zeroed in place, with the graphs captured over
        it. In a ring cache (a sliding window W) the prefill wraps as the
        steps would: a prefix longer than the ring's S slots leaves only
        its last S positions in the cache, which is what the next steps
        attend."""
        cache = self._init_cache(batch, self._decode_max_len) \
            if self._programs is None else \
            self._programs.fresh_cache(batch, self._decode_max_len)
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
                    self._step(cache, inp[:, t])
        return cache

    def set_decode_len(self, n: int):
        self._decode_max_len = int(n)

    def decode_step(self, state, prev_tokens: np.ndarray):
        """One step of every lane: (logits (B, V), state), the state
        advanced in place. On the card the logits are the captured step's
        static output: the next call on this state overwrites them."""
        with obs.span("model.decode_step"):
            logits = self._step(state, prev_tokens)
            if self._programs is not None \
                    and obs.timeline.active() is not None:
                # a recorded timeline counts the device's time of the step
                # as model time: wait for it inside the span
                torch.cuda.current_stream(self.device).synchronize()
            return logits, state

    @torch.no_grad()
    def verify_steps(self, state, seq: np.ndarray):
        """Speculative-decode verify program: seq (B, T) -- column 0 is
        each lane's previous token, columns 1..T-1 its drafted
        continuation -- through T decode steps, on the card in one
        captured graph. Returns (logits (B, T, V), bit-identical to T
        ``decode_step`` calls, and the opaque snapshots ``rollback``
        takes). The state has consumed all T inputs; on the card the
        logits and snapshots are static and the next verify overwrites
        them."""
        with obs.span("model.verify"):
            seq = np.asarray(seq, np.int64)
            if self._programs is not None:
                return self._programs.verify(state, seq)
            logits, snaps, rows = graphs.verify_body(
                self._step_body, state, self._tokens(seq.T),
                model_api.rollback_leaves(self.cfg),
                model_api.ring_leaves(self.cfg))
            return logits, graphs.Snapshots(state, snaps, rows)

    @torch.no_grad()
    def rollback(self, snapshots, accepted: np.ndarray):
        """Rewind each lane, in place, to the state after it consumed
        ``accepted[b]`` of the last verify's inputs (0 = before them).
        Dense lanes rewind ``pos``: in a linear cache, bf16 or int8, K/V
        rows past it are hidden and overwritten. A ring cache (a sliding
        window) that has wrapped hides nothing, so the slots of the
        rejected steps also take back the rows (K/V, and their scales in
        an int8 ring) that the verify copied before its first step. ssm
        and hybrid lanes also take back their conv and SSM state. Returns
        the state."""
        with obs.span("model.rollback"):
            return graphs.rollback(snapshots, accepted)

    @torch.no_grad()
    def snapshot_slot(self, state, lane: int) -> dict:
        """Copies of lane ``lane`` of every cache leaf: the value a radix
        prefix cache stores for a prefilled shared prefix. Leaves are
        (L, B, ...) with the lane on axis 1 (K/V, an int8 cache's
        ``k_scale``/``v_scale``, a ring whole, conv and SSM state); ``pos``
        is (B,). The live cache is untouched."""
        with obs.span("model.snapshot_slot"):
            return {name: (leaf[lane] if name == "pos" else
                           leaf[:, lane]).clone()
                    for name, leaf in state.items()}

    @torch.no_grad()
    def restore_slot(self, state, snapshot: dict, mask: np.ndarray):
        """Write ``snapshot`` (from ``snapshot_slot``) into every cache lane
        selected by ``mask`` (B,) bool, in place -- the prefix-cache-hit
        path that replaces re-prefilling those lanes. Every leaf the
        snapshot holds is written, scales and ring slots included, so a
        restored lane equals a cold prefill bit for bit. Returns the same
        state."""
        with obs.span("model.restore_slot"):
            lanes = torch.as_tensor(np.nonzero(np.asarray(mask, bool))[0],
                                    device=self.device)
            if lanes.numel():
                for name, leaf in state.items():
                    if name == "pos":
                        leaf[lanes] = snapshot[name]
                    else:
                        leaf[:, lanes] = snapshot[name].unsqueeze(1)
            return state

    @torch.no_grad()
    def reset_slots(self, state, mask: np.ndarray):
        """Reset the cache lanes selected by ``mask`` (B,) bool to a fresh
        context without touching the other lanes — the slot-refill
        primitive of the continuous-batching scheduler. In place: ``pos``
        returns to 0 and every other cache leaf, (L, B, ...) with the lane
        on axis 1, is zeroed. For an SSM the conv and recurrent state
        MUST be zeroed (they are the context); for attention, zeroing K/V
        is hygiene (the per-lane length already hides stale entries); the
        hybrid has both."""
        with obs.span("model.reset_slots"):
            lanes = torch.as_tensor(np.nonzero(np.asarray(mask, bool))[0],
                                    device=self.device)
            if lanes.numel():
                for name, leaf in state.items():
                    if name == "pos":
                        leaf[lanes] = 0
                    else:
                        leaf[:, lanes] = 0
            return state

    # ----------------------------------------------------------- sampling
    def generate(self, n_tokens: int, batch: int = 1, *, temperature=1.0,
                 top_k: int = 0, seed: int = 0, prompt=None,
                 vocab_limit: int = 0) -> np.ndarray:
        """Autoregressive sampling -> (batch, n_tokens) int32, as the JAX
        engine's ``generate``: BOS, then ``prompt`` ((P,) shared or
        (batch, P) per row) fed token by token, then ``n_tokens`` samples
        at ``temperature``; ``top_k > 0`` samples among the k largest
        logits, ``vocab_limit > 0`` among ids < vocab_limit (256 for raw
        bytes, without PAD and BOS). Every step goes through
        ``decode_step`` (on the card a replay of the captured step), and
        each step samples before the next one overwrites the logits.

        Sampling is the Gumbel-max trick with uniforms from a
        ``torch.Generator`` on the predictor's device seeded from
        ``seed``: the same seed on the same device gives the same tokens;
        the JAX package draws from another generator, so only
        near-greedy sampling (a temperature near 0) agrees across the
        two."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        plen = 0 if prompt is None else np.asarray(prompt).shape[-1]
        self.set_decode_len(max(n_tokens, 16) + plen)
        cache = self.begin_decode(batch)
        prev = np.full((batch,), self.bos_id, np.int64)
        if prompt is not None:
            prompt = np.asarray(prompt, np.int64)
            if prompt.ndim == 1:                    # shared prompt
                prompt = np.tile(prompt, (batch, 1))
            for t in range(prompt.shape[1]):
                self.decode_step(cache, prev)
                prev = prompt[:, t]
        out = np.zeros((batch, n_tokens), np.int32)
        for t in range(n_tokens):
            logits, _ = self.decode_step(cache, prev)
            with torch.no_grad():
                lg = logits.float() / max(temperature, 1e-4)
                if vocab_limit:
                    lg[:, vocab_limit:] = -1e30
                idx = None
                if top_k:
                    lg, idx = torch.topk(lg, top_k, dim=-1)
                u = torch.rand(lg.shape, generator=gen, device=self.device)
                tok = torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)
                if idx is not None:
                    tok = idx.gather(1, tok[:, None])[:, 0]
            prev = tok.cpu().numpy().astype(np.int64)
            out[:, t] = prev
        return out
