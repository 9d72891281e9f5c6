"""The paper's system end to end on the card (``tests/test_system.py``'s
four checks, at its sizes, through the port): ``pred-small`` trained by
the recipe of ``train/prep.py`` on the card, "LLM text" generated with
it, compressed losslessly.

* 4096 bytes of its own wiki text: a byte-identical round trip, a ratio
  above gzip's and above 2 (the paper's headline claim, micro-scale);
* chunk 128 codes better than chunk 16 (paper §5.4);
* its own text is more compressible than human text with
  out-of-distribution words (paper Fig 9);
* ``compress(exact=False)`` (teacher-forced scoring) within 2% of the
  exact decode-path size.

Every test is marked ``cuda`` and skips without a card; on the machine
with the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_system.py

The predictor and the texts go to a temporary cache, trained once per
run of this file. This file imports no JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import LLMCompressor  # noqa: E402
from repro_torch.core.baselines import gzip_ratio  # noqa: E402
from repro_torch.data.synthetic import human_like_ood  # noqa: E402
from repro_torch.data.tokenizer import encode  # noqa: E402
from repro_torch.train import prep  # noqa: E402


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (training on the card)")
    cache = tmp_path_factory.mktemp("torch_cache")
    pred = prep.predictor("pred-small", device="cuda", cache_dir=cache)

    def corpus(n_bytes, seed):
        return prep.llm_dataset("wiki", n_bytes, gen_model="pred-small",
                                seed=seed, device="cuda", cache_dir=cache)
    return pred, corpus


@pytest.mark.cuda
def test_end_to_end_llm_compression(trained):
    pred, corpus = trained
    raw = corpus(4096, 7)
    data = encode(raw)
    comp = LLMCompressor(pred, chunk_size=64, topk=32, decode_batch=16)
    blob, _ = comp.compress(data)
    assert np.array_equal(comp.decompress(blob), data), "LOSSLESS VIOLATION"
    ratio, gz = len(raw) / len(blob), gzip_ratio(raw)
    assert ratio > gz, (ratio, gz)
    assert ratio > 2.0, ratio


@pytest.mark.cuda
def test_chunk_size_improves_ratio(trained):
    pred, corpus = trained
    data = encode(corpus(3072, 3))
    r = {}
    for c in (16, 128):
        blob, _ = LLMCompressor(pred, chunk_size=c, topk=32,
                                decode_batch=16).compress(data)
        r[c] = data.size / len(blob)
    assert r[128] > r[16], r


@pytest.mark.cuda
def test_own_text_more_compressible_than_human(trained):
    pred, corpus = trained
    own = encode(corpus(3072, 5))
    human = encode(human_like_ood("wiki", 3072, seed=99))
    comp = LLMCompressor(pred, chunk_size=64, topk=32, decode_batch=16)
    r_own = own.size / len(comp.compress(own)[0])
    r_hum = human.size / len(comp.compress(human)[0])
    assert r_own > r_hum, (r_own, r_hum)


@pytest.mark.cuda
def test_prefill_estimate_close_to_exact(trained):
    pred, corpus = trained
    data = encode(corpus(2048, 11))
    comp = LLMCompressor(pred, chunk_size=64, topk=32, decode_batch=8)
    exact, _ = comp.compress(data, exact=True)
    est, _ = comp.compress(data, exact=False)
    assert abs(len(est) - len(exact)) / len(exact) < 0.02
