"""The port's teacher-forced scoring path against the JAX package's.

``from_jax`` converts ``repro.models.schema.init_params`` trees, so both
packages compute the same function. Held on the CPU, fp32:

* ``forward`` on the tiny ``qwen3-1.7b`` variant (2 layers, d=64,
  qk-norm, GQA), with and without a sliding window;
* ``ModelPredictor.score_chunks``, fresh and under a ``prefix`` given as
  (B, P) and as (P,), and against the port's own decode program;
* the router's early cross-entropy probe (``route_chunks(auto=True)``):
  equal per-chunk decisions and close estimates;
* routed round trips through ``CompressionService`` and ``llmc-torch``.

Logits agree to atol/rtol 1e-4 (XLA and PyTorch multiply and sum in other
orders; the decode tests of ``test_torch_model.py`` use the same bound);
the port's scoring and its decode program, which differ only in
reduction order, agree to atol 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402

from helpers import golden_self_tokens  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import llava_next_34b as jllava  # noqa: E402
from repro.configs import paper_predictors as jpp  # noqa: E402
from repro.configs import qwen3_1_7b as jqwen  # noqa: E402
from repro.core import router as jrouter  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve.engine import ModelPredictor as JPredictor  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.configs import llava_next_34b as pllava  # noqa: E402
from repro_torch.configs import paper_predictors as ppp  # noqa: E402
from repro_torch.configs import qwen3_1_7b as pqwen  # noqa: E402
from repro_torch.core import LLMCompressor, read_header, read_index  # noqa
from repro_torch.core import router as prouter  # noqa: E402
from repro_torch.data.synthetic import human_like  # noqa: E402
from repro_torch.data.tokenizer import encode  # noqa: E402
from repro_torch.models import api, schema  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402
from repro_torch.train.prep import train_predictor  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
QWEN = {None: (jbase.tiny_variant(jqwen.CONFIG),
               pbase.tiny_variant(pqwen.CONFIG)),
        16: (jbase.tiny_variant(jqwen.CONFIG, sliding_window=16),
             pbase.tiny_variant(pqwen.CONFIG, sliding_window=16))}


def _pair(jcfg, pcfg, seed=0):
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    pnp = jax.tree_util.tree_map(
        np.asarray, jschema.init_params(jcfg, jax.random.PRNGKey(seed)))
    return pnp, schema.from_jax(pnp)


@pytest.mark.parametrize("window", [None, 16])
def test_forward_matches_jax(window):
    jcfg, pcfg = QWEN[window]
    assert pcfg.n_layers == 2 and pcfg.d_model == 64
    pnp, params = _pair(jcfg, pcfg)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (3, 40)).astype(np.int32)
    want = jax.jit(lambda p, t: jtf.forward(p, jcfg, {"tokens": t}))(
        pnp, toks)
    got = api.forward(params, pcfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (3, 40, pcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_accepts_a_window_that_decode_refuses():
    """forward takes the sliding window. The decode cache, which refused
    it until the ring was ported, is now a ring of min(max_len, W) slots
    (held against JAX in tests/test_torch_cache_variants.py). The vlm
    image prefix of forward, refused until it was ported, matches JAX's
    (more in tests/test_torch_vlm.py); the dense family ignores
    ``img_embeds``, as JAX's does."""
    _, pcfg = QWEN[16]
    params = schema.init_params(pcfg, seed=0)
    api.forward(params, pcfg, {"tokens": torch.zeros((1, 4), dtype=int)})
    assert api.init_cache(pcfg, 1, 8)["k"].shape[2] == 8
    assert api.init_cache(pcfg, 1, 40)["k"].shape[2] == 16
    assert api.ring_leaves(pcfg) == ("k", "v")
    toks = torch.zeros((1, 4), dtype=int)
    img = torch.zeros((1, 2, 64))
    assert torch.equal(api.forward(params, pcfg, {"tokens": toks}),
                       api.forward(params, pcfg, {"tokens": toks,
                                                  "img_embeds": img}))
    jcfg = jbase.tiny_variant(jllava.CONFIG, sliding_window=16)
    vcfg = pbase.tiny_variant(pllava.CONFIG, sliding_window=16)
    pnp, vparams = _pair(jcfg, vcfg, seed=1)
    rng = np.random.default_rng(2)
    vt = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    vi = rng.normal(size=(2, jcfg.n_img_tokens, 64)).astype(np.float32)
    want = jax.jit(lambda p, t, i: jtf.forward(
        p, jcfg, {"tokens": t, "img_embeds": i}))(pnp, vt, vi)
    got = api.forward(vparams, vcfg, {"tokens": torch.from_numpy(vt).long(),
                                      "img_embeds": torch.from_numpy(vi)})
    assert got.shape == (2, 12, vcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def predictors():
    """The tiny qwen3 variant in both packages, on the same weights."""
    jcfg, pcfg = QWEN[None]
    pnp, params = _pair(jcfg, pcfg, seed=2)
    return JPredictor(pnp, jcfg), ModelPredictor(params, pcfg, device="cpu")


@pytest.mark.parametrize("prefix", ["none", "per-lane", "shared"])
def test_score_chunks_matches_jax(predictors, prefix):
    jpred, pred = predictors
    rng = np.random.default_rng(3)
    toks = rng.integers(0, pred.vocab_size, (4, 24)).astype(np.int32)
    pre = {"none": None,
           "per-lane": rng.integers(0, pred.vocab_size, (4, 7)),
           "shared": rng.integers(0, pred.vocab_size, (9,))}[prefix]
    if pre is not None:
        pre = pre.astype(np.int32)
    want = jpred.score_chunks(toks, prefix=pre) if pre is not None \
        else jpred.score_chunks(toks)
    got = pred.score_chunks(toks, prefix=pre)
    assert isinstance(got, torch.Tensor)
    assert got.shape == (4, 24, pred.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("prefix", [False, True])
def test_score_chunks_matches_own_decode_program(prefix):
    """Teacher-forced scoring equals the decode program's logits for the
    same chunks: fresh ([BOS, x_<t]) and after begin_decode(prefix)."""
    pred = ModelPredictor.random_init(ppp.PRED_TINY, seed=4, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, pred.vocab_size, (3, 20))
    pre = rng.integers(0, pred.vocab_size, (3, 6)) if prefix else None
    scored = pred.score_chunks(toks, prefix=pre)
    state = pred.begin_decode(3, prefix=pre)
    prev = pre[:, -1] if prefix else np.full(3, pred.bos_id)
    steps = []
    for t in range(toks.shape[1]):
        lg, state = pred.decode_step(state, prev)
        steps.append(lg)
        prev = toks[:, t]
    np.testing.assert_allclose(scored.numpy(),
                               torch.stack(steps, 1).numpy(), atol=1e-4)


def _mixed_tokens(seed=0):
    """Text, random bytes and a long run of one byte: each fallback and
    the model path have a reason to win some chunk."""
    rng = np.random.default_rng(seed)
    return np.concatenate([encode(human_like("wiki", 700, seed=seed)),
                           rng.integers(0, 256, 400),
                           np.full(300, 65)]).astype(np.int32)


def test_router_probe_decisions_match_jax():
    jcfg, pcfg = jpp.PRED_TINY, ppp.PRED_TINY
    pnp, params = _pair(jcfg, pcfg, seed=6)
    toks = _mixed_tokens()
    C = 64
    n = -(-toks.size // C)
    chunks = np.zeros((n, C), np.int32)
    chunks.ravel()[:toks.size] = toks
    valid = np.minimum(C, toks.size - C * np.arange(n))
    jd, jfb = jrouter.route_chunks(jrouter.CodecRouter(), JPredictor(
        pnp, jcfg), chunks, valid, "rans", auto=True)
    pd, pfb = prouter.route_chunks(prouter.CodecRouter(), ModelPredictor(
        params, pcfg, device="cpu"), chunks, valid, "rans", auto=True)
    assert [d.codec for d in pd] == [d.codec for d in jd]
    assert {d.codec for d in pd} >= {"rans", "lzma"}
    assert pfb == jfb
    np.testing.assert_allclose([d.llm_bits_est for d in pd],
                               [d.llm_bits_est for d in jd], rtol=1e-5)


@pytest.mark.parametrize("route", ["auto", "zstd", "lzma", "raw"])
def test_routed_service_round_trip(route):
    pred = ModelPredictor.random_init(ppp.PRED_TINY, seed=7, device="cpu")
    toks = _mixed_tokens(1)
    if route == "zstd":
        pytest.importorskip("zstandard")
    svc = CompressionService(pred, slots=4, chunk_size=64, topk=16,
                             route=route, device="cpu")
    blob, _ = svc.submit_compress(toks).result()
    info = read_index(blob, read_header(blob))
    assert info.version == 5
    codecs = {e.codec_name for e in info.entries}
    if route == "auto":
        assert len(codecs) > 1
    else:                 # raw store stays the router's safety net
        assert route in codecs and codecs <= {route, "raw"}
    back = CompressionService(pred, slots=4, chunk_size=64, topk=16,
                              device="cpu").submit_decompress(blob).result()
    assert np.array_equal(back, toks)


def test_prefill_scored_estimate_close_to_exact():
    """compress(exact=False) scores through score_chunks: its container
    codes the same tokens within a few bytes of the exact one."""
    pred = ModelPredictor.random_init(ppp.PRED_TINY, seed=8, device="cpu")
    toks = golden_self_tokens(200, seed=3, vocab=256)
    comp = LLMCompressor(pred, chunk_size=32, topk=16, decode_batch=4)
    exact, s_exact = comp.compress(toks)
    est, s_est = comp.compress(toks, exact=False)
    assert abs(len(est) - len(exact)) <= 0.02 * len(exact)
    assert s_est.ideal_bits == pytest.approx(s_exact.ideal_bits, rel=1e-4)
    assert np.array_equal(comp.decompress(exact), toks)


def test_cli_route_auto_round_trip(tmp_path, capsys, monkeypatch):
    # pred-* predictors are trained at first use: a short recipe put in a
    # cache of the test's own, which the CLI loads
    cache = tmp_path / "cache"
    monkeypatch.setenv("REPRO_TORCH_CACHE", str(cache))
    train_predictor("pred-tiny", steps=3, device="cpu", cache_dir=cache)
    src, arc, back = (tmp_path / "in.bin", tmp_path / "in.llmc",
                      tmp_path / "back.bin")
    src.write_bytes(_mixed_tokens(2).astype(np.uint8).tobytes())
    common = ["--predictor", "pred-tiny", "--device", "cpu", "--slots", "4"]
    assert cli.main(["compress", str(src), str(arc), "--route", "auto",
                     "--chunk", "64", "--topk", "16"] + common) == 0
    assert read_header(arc.read_bytes()).version == 5
    assert cli.main(["decompress", str(arc), str(back)] + common) == 0
    assert back.read_bytes() == src.read_bytes()
    with pytest.raises(SystemExit):
        cli.main(["compress", str(src), str(arc), "--route", "auto",
                  "--codec", "ac"] + common)
