"""Speculative decompression through the port's engine, on the CPU.

The entropy decoder, not the draft, decides every token, so speculative
decode (``LLMCompressor(draft_k=K)``: a self-draft, one ``verify_steps``
program over K + 1 positions, ``rollback`` of each lane to what it
accepted) must give exactly the lock-step decoder's output for every
proposer: the suffix self-draft, one that is always wrong, and an oracle.
The cases of ``tests/test_speculative.py``, on the port's
``ModelPredictor`` (tiny dense, moe, ssm and hybrid configs, random weights
from seed 0) instead of a lookup-table predictor: both coded alphabets,
an escape-heavy top-k stream, ragged tails, the AC codec (which ignores
the draft) and empty inputs. On predictable text an oracle draft issues
at most half the model programs of lock-step decode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.configs import mamba2_130m as pmamba  # noqa: E402
from repro_torch.configs import qwen3_1_7b as pqwen  # noqa: E402
from repro_torch.configs import qwen3_moe_235b_a22b as pqmoe  # noqa: E402
from repro_torch.configs import zamba2_7b as pzamba  # noqa: E402
from repro_torch.core import LLMCompressor  # noqa: E402
from repro_torch.core.draft import ConstantDraft, OracleDraft  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402

CFGS = {"dense": pbase.tiny_variant(pqwen.CONFIG),
        "ssm": pbase.tiny_variant(pmamba.CONFIG),
        "hybrid": pbase.tiny_variant(pzamba.CONFIG, n_layers=5),
        "moe": pbase.tiny_variant(pqmoe.CONFIG)}


class CountingPredictor(ModelPredictor):
    """The port's predictor, counting decode_step and verify programs."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.n_decode = self.n_verify = 0

    def decode_step(self, state, prev_tokens):
        self.n_decode += 1
        return super().decode_step(state, prev_tokens)

    def verify_steps(self, state, seq):
        self.n_verify += 1
        return super().verify_steps(state, seq)


_PREDS = {}


def _pred(family="dense") -> CountingPredictor:
    if family not in _PREDS:
        _PREDS[family] = CountingPredictor.random_init(CFGS[family], seed=0,
                                                       device="cpu")
    pred = _PREDS[family]
    pred.n_decode = pred.n_verify = 0
    return pred


def _predictable_tokens(pred, n, q=0.9, seed=11):
    """Follow the model's one-step argmax table (the most likely byte
    after each id, from a fresh context) with probability q, else a
    random byte: compressible, and draftable, since iterating a table
    falls into cycles (``tests/test_speculative.py`` does the same with
    its lookup table)."""
    V = pred.vocab_size
    pred.set_decode_len(2)
    lg, _ = pred.decode_step(pred.begin_decode(V), np.arange(V))
    table = lg[:, :256].argmax(-1).numpy()
    rng = np.random.default_rng(seed)
    toks = np.zeros(n, np.int32)
    prev = pred.bos_id
    for i in range(n):
        prev = int(table[prev]) if rng.random() < q \
            else int(rng.integers(0, 256))
        toks[i] = prev
    return toks


def _round_trip(pred, toks, spec_kw, **kw):
    comp = LLMCompressor(pred, chunk_size=32, decode_batch=4, **kw)
    blob, _ = comp.compress(toks)
    assert np.array_equal(comp.decompress(blob), toks)
    spec = LLMCompressor(pred, chunk_size=32, decode_batch=4, **kw,
                         **spec_kw)
    assert np.array_equal(spec.decompress(blob), toks)
    return blob


@pytest.mark.parametrize("topk", [8, 0])
@pytest.mark.parametrize("draft_k", [1, 3, 5])
def test_spec_equals_lockstep(topk, draft_k):
    pred = _pred()
    _round_trip(pred, _predictable_tokens(pred, 300), dict(draft_k=draft_k),
                topk=topk)


@pytest.mark.parametrize("family", sorted(CFGS))
def test_spec_equals_lockstep_both_families(family):
    pred = _pred(family)
    toks = np.random.default_rng(3).integers(0, 250, 120).astype(np.int32)
    comp = LLMCompressor(pred, chunk_size=24, topk=16, decode_batch=4)
    blob, _ = comp.compress(toks)
    assert np.array_equal(comp.decompress(blob), toks)
    spec = LLMCompressor(pred, chunk_size=24, topk=16, decode_batch=4,
                         draft_k=3)
    assert np.array_equal(spec.decompress(blob), toks)
    assert pred.n_verify > 0


@pytest.mark.parametrize("topk", [8, 0])
def test_adversarial_always_wrong_draft(topk):
    """A proposer that never matches costs rounds, never correctness."""
    pred = _pred()
    _round_trip(pred, _predictable_tokens(pred, 200),
                dict(draft_k=4, draft=ConstantDraft(pred.vocab_size - 1)),
                topk=topk)


def test_oracle_draft_accepts_everything():
    """A perfect proposer has every draft accepted: ceil(C / (K+1))
    verify programs per group and no lock-step tail, at most half the
    lock-step decoder's programs."""
    pred = _pred()
    C, B, K = 32, 4, 4
    toks = _predictable_tokens(pred, 512)
    comp = LLMCompressor(pred, chunk_size=C, topk=8, decode_batch=B)
    blob, _ = comp.compress(toks)
    pred.n_decode = pred.n_verify = 0
    comp.decompress(blob)
    lock_calls = pred.n_decode
    spec = LLMCompressor(pred, chunk_size=C, topk=8, decode_batch=B,
                         draft_k=K, draft=OracleDraft(toks, C))
    pred.n_decode = pred.n_verify = 0
    assert np.array_equal(spec.decompress(blob), toks)
    spec_calls = pred.n_decode + pred.n_verify
    groups = toks.size // (C * B)
    assert lock_calls == C * groups
    assert spec_calls <= -(-C // (K + 1)) * groups + 1
    assert spec_calls * 2 <= lock_calls


def test_suffix_draft_beats_lockstep_programs_on_predictable_text():
    pred = _pred()
    toks = _predictable_tokens(pred, 1024, q=0.95)
    comp = LLMCompressor(pred, chunk_size=64, topk=8, decode_batch=4)
    blob, _ = comp.compress(toks)
    pred.n_decode = pred.n_verify = 0
    comp.decompress(blob)
    lock_calls = pred.n_decode
    spec = LLMCompressor(pred, chunk_size=64, topk=8, decode_batch=4,
                         draft_k=4)
    pred.n_decode = pred.n_verify = 0
    assert np.array_equal(spec.decompress(blob), toks)
    assert pred.n_decode + pred.n_verify < lock_calls


def test_escape_heavy_topk_stream():
    """topk=2 over uniform bytes: most tokens escape, and every escape is
    decoded inside the speculative accept loop."""
    pred = _pred()
    toks = np.random.default_rng(5).integers(0, 256, 300).astype(np.int32)
    _round_trip(pred, toks, dict(draft_k=3), topk=2)


@pytest.mark.parametrize("n", [1, 7, 31, 33, 65, 97])
def test_spec_ragged_tail_and_tiny_inputs(n):
    """Lane masks at chunk boundaries: sizes that end mid-chunk, a single
    token, fewer chunks than lanes."""
    pred = _pred()
    _round_trip(pred, _predictable_tokens(pred, n, seed=n),
                dict(draft_k=4), topk=8)


def test_ac_codec_ignores_draft():
    pred = _pred()
    _round_trip(pred, _predictable_tokens(pred, 100), dict(draft_k=4),
                topk=8, codec="ac")
    assert pred.n_verify == 0


class Exploding(ModelPredictor):
    def score_chunks(self, tokens, prefix=None):
        raise AssertionError("model called for empty input")

    def decode_step(self, state, prev):
        raise AssertionError("model called for empty input")

    def verify_steps(self, state, seq):
        raise AssertionError("model called for empty input")


def test_empty_input_roundtrip():
    """Zero tokens: a zero-chunk container and an empty array back, with
    no model program on either side."""
    pred = Exploding.random_init(CFGS["dense"], seed=0, device="cpu")
    for kw in (dict(topk=8), dict(topk=0), dict(codec="ac"),
               dict(topk=8, draft_k=4), dict(container_version=4)):
        comp = LLMCompressor(pred, chunk_size=32, decode_batch=4, **kw)
        blob, stats = comp.compress(np.zeros(0, np.int32))
        assert stats.n_tokens == 0
        out = comp.decompress(blob)
        assert out.size == 0 and out.dtype == np.int32


def test_empty_input_via_service():
    svc = CompressionService(_pred(), slots=4, chunk_size=16, topk=8,
                             device="cpu")
    blob, stats = svc.submit_compress(np.zeros(0, np.int32)).result()
    assert stats.n_tokens == 0
    out = svc.submit_decompress(blob).result()
    assert out.size == 0 and out.dtype == np.int32
