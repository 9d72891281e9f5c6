"""The port's vlm family (llava-next) against the JAX package's, on the CPU.

The tiny ``llava-next-34b`` variant of both packages (2 layers, d=64,
GQA 4/2, 8 image tokens, fp32), weights made by the JAX package and
carried across by ``from_jax``, image embeddings and tokens from numpy
seeds. The vlm is the dense model with an image prefix in ``forward``:
``img_embeds`` (B, n_img, D) before the token embeddings, positions over
the whole sequence, the image positions dropped after the final norm.
Held:

* the config and parameter count against the reference's;
* ``forward`` with ``img_embeds`` under both ``attn_impl`` against the
  JAX ``forward`` (atol/rtol 1e-4, as ``tests/test_torch_score.py``
  holds the dense forward), and the image seen to move the text logits;
* ``ModelPredictor.score_chunks`` with ``img_embeds``, fresh and under a
  prefix, against the JAX ``ModelPredictor`` (same tolerance);
* ``loss_fn`` with ``img_embeds`` against the JAX ``loss_fn`` composed
  without a mesh (rtol 1e-5, as ``tests/test_torch_train.py``);
* an image batch that is not the tokens' raising ``ValueError`` (the JAX
  package raises in its concatenate);
* the decode program, which reads no image (nor does the JAX one): the
  same logits with and without ``img_embeds``, an exact round trip.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import llava_next_34b as jllava  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve.engine import ModelPredictor as JPredictor  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.configs import llava_next_34b as pllava  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import LLMCompressor  # noqa: E402
from repro_torch.models import api, schema  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402

JCFG = jbase.tiny_variant(jllava.CONFIG)
PCFG = pbase.tiny_variant(pllava.CONFIG)
TOL = dict(atol=1e-4, rtol=1e-4)
T = torch.from_numpy


@pytest.fixture(scope="module")
def weights():
    pnp = jax.tree_util.tree_map(
        np.asarray, jschema.init_params(JCFG, jax.random.PRNGKey(4)))
    return pnp, schema.from_jax(pnp)


def _img(batch, seed=0):
    return np.random.default_rng(seed).normal(
        size=(batch, JCFG.n_img_tokens, JCFG.d_model)).astype(np.float32)


def _toks(shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, shape).astype(np.int32)


def test_config_matches_the_reference():
    assert dataclasses.asdict(PCFG) == dataclasses.asdict(JCFG)
    assert dataclasses.asdict(pllava.CONFIG) == dataclasses.asdict(
        jllava.CONFIG)
    assert get_config("llava-next-34b") == pllava.CONFIG
    assert schema.count_params(pllava.CONFIG) == jschema.count_params(
        jllava.CONFIG)
    assert (pllava.CONFIG.padded_heads, pllava.CONFIG.padded_kv_heads) == \
        (64, 8)


@pytest.mark.parametrize("attn_impl", ["flash", "masked"])
def test_forward_with_image_matches_jax(weights, attn_impl):
    pnp, params = weights
    img, toks = _img(3), _toks((3, 20))
    want = jax.jit(lambda p, i, t: jtf.forward(
        p, JCFG, {"tokens": t, "img_embeds": i}))(pnp, img, toks)
    batch = {"tokens": T(toks.astype(np.int64)), "img_embeds": T(img)}
    got = api.forward(params, PCFG, batch, attn_impl=attn_impl)
    assert got.shape == (3, 20, PCFG.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    hidden = api.forward(params, PCFG, batch, attn_impl=attn_impl,
                         return_hidden=True)
    assert hidden.shape == (3, 20, PCFG.d_model)
    plain = api.forward(params, PCFG, {"tokens": batch["tokens"]},
                        attn_impl=attn_impl)
    assert float((plain - got).abs().max()) > 1e-2    # the image is seen


@pytest.mark.parametrize("prefix", [None, "per-lane", "shared"])
def test_score_chunks_with_image_matches_jax(weights, prefix):
    pnp, params = weights
    img = _img(4, seed=2)
    jpred = JPredictor(pnp, JCFG, extra_batch={"img_embeds": img})
    ppred = ModelPredictor(params, PCFG, extra_batch={"img_embeds": img},
                           device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (4, 24)).astype(np.int32)
    pre = {None: None, "per-lane": rng.integers(0, 256, (4, 7)),
           "shared": rng.integers(0, 256, (9,))}[prefix]
    pre = None if pre is None else pre.astype(np.int32)
    want = jpred.score_chunks(toks) if pre is None \
        else jpred.score_chunks(toks, prefix=pre)
    got = ppred.score_chunks(toks, prefix=pre)
    assert got.shape == (4, 24, PCFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("loss_block", [0, 8])
def test_loss_with_image_matches_jax(weights, loss_block):
    pnp, params = weights
    img, toks = _img(2, seed=5), _toks((2, 17), seed=6)
    want = jax.value_and_grad(japi.loss_fn)(
        pnp, JCFG, {"tokens": jnp.asarray(toks), "img_embeds": img},
        attn_impl="masked", loss_block=loss_block)[0]
    with torch.no_grad():
        got = api.loss_fn(params, PCFG, {"tokens": T(toks.astype(np.int64)),
                                         "img_embeds": T(img)},
                          loss_block=loss_block)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_mismatched_image_batch_raises(weights):
    pnp, params = weights
    img, toks = _img(1), _toks((4, 8))
    with pytest.raises(ValueError, match="img_embeds"):
        api.forward(params, PCFG, {"tokens": T(toks.astype(np.int64)),
                                   "img_embeds": T(img)})
    with pytest.raises(ValueError, match="img_embeds"):
        ModelPredictor(params, PCFG, extra_batch={"img_embeds": img},
                       device="cpu").score_chunks(toks)
    with pytest.raises(Exception):              # the reference's refusal
        JPredictor(pnp, JCFG, extra_batch={"img_embeds": img}).score_chunks(
            toks)


def test_decode_program_reads_no_image(weights):
    """The vlm decode step is the dense one: the same logits with and
    without img_embeds, equal to the JAX decode program's, and an exact
    archive (coded by the decode program) round-trips."""
    pnp, params = weights
    with_img = ModelPredictor(params, PCFG,
                              extra_batch={"img_embeds": _img(3)},
                              device="cpu")
    plain = ModelPredictor(params, PCFG, device="cpu")
    jpred = JPredictor(pnp, JCFG, extra_batch={"img_embeds": _img(3)})
    toks = _toks((3, 10), seed=7) % 256
    states = []
    for p in (with_img, plain, jpred):
        p.set_decode_len(16)
        states.append(p.begin_decode(3))
    for t in range(toks.shape[1]):
        a, _ = with_img.decode_step(states[0], toks[:, t])
        b, _ = plain.decode_step(states[1], toks[:, t])
        j, states[2] = jpred.decode_step(states[2], toks[:, t])
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), j, **TOL)
    data = np.random.default_rng(8).integers(0, 256, 150).astype(np.int32)
    comp = LLMCompressor(with_img, chunk_size=32, topk=8, decode_batch=3)
    blob, _ = comp.compress(data)
    assert np.array_equal(LLMCompressor(plain, chunk_size=32, topk=8,
                                        decode_batch=3).decompress(blob),
                          data)
