"""The port's slice as a whole on the CPU: predictor, service, CLI.

* A JAX ``ModelPredictor`` and the port's, on converted weights, see the
  same chunks: per-step top-k ids equal (a near tie of JAX logits may be
  ordered either way) and CDFs within one quantum, also on the text that
  puts a near tie into the top 48.
* The port's service round trip is lossless, its bytes equal the port's
  grouped-path bytes, chunks decode on other lanes, and ``--topk 0``
  (full-vocabulary CDF) round-trips.
* ``llmc-torch compress`` -> ``decompress`` (tiny config, ``--device
  cpu``) is byte-identical.

Container bytes *between* the packages may differ: the engine is part of
the coding geometry (ROADMAP).
"""
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402

from repro.configs import paper_predictors as jpp  # noqa: E402
from repro.core import cdf as jcdf  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.serve.engine import ModelPredictor as JaxPredictor  # noqa: E402
from repro_torch.cli import main as cli_main  # noqa: E402
from repro_torch.train.prep import train_predictor  # noqa: E402
from repro_torch.configs import paper_predictors as ppp  # noqa: E402
from repro_torch.core import LLMCompressor  # noqa: E402
from repro_torch.core import cdf  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.tokenizer import decode, encode  # noqa: E402
from repro_torch.models import schema  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402

CFG_J, CFG_P = jpp.PRED_TINY, ppp.PRED_TINY


@pytest.fixture(scope="module")
def predictors():
    pnp = jax.tree_util.tree_map(
        np.asarray, jschema.init_params(CFG_J, jax.random.PRNGKey(4)))
    return (JaxPredictor(pnp, CFG_J),
            ModelPredictor(schema.from_jax(pnp), CFG_P, device="cpu"))


@pytest.fixture(scope="module")
def port_pred():
    return ModelPredictor.random_init(CFG_P, seed=0, device="cpu")


def _text(n, seed=1, domain="wiki"):
    return encode(synthetic.human_like(domain, n, seed=seed))


LOGIT_ATOL = 1e-4


def _assert_same_topk(jl, k, ids_p, cdf_p, ids_j, cdf_j):
    """The port's top-k CDF rows against JAX's, row by row. Ids come in
    JAX's order, except inside a run of ids whose JAX logits lie within
    ``LOGIT_ATOL`` (the logits' own tolerance) of their neighbour's: the
    two packages may order a near tie either way, so inside a run the
    id sets match. Each id's interval width (its quantized probability)
    is within one quantum of JAX's, and so is every CDF point that does
    not fall strictly inside a run."""
    for r in range(ids_j.shape[0]):
        lj = jl[r, ids_j[r]]
        starts = np.r_[0, np.nonzero(np.abs(np.diff(lj)) > LOGIT_ATOL)[0]
                       + 1, k]
        for a, b in zip(starts[:-1], starts[1:]):
            assert set(ids_p[r, a:b]) == set(ids_j[r, a:b]), (r, a, b)
        wj = dict(zip(ids_j[r].tolist(), np.diff(cdf_j[r])[:k]))
        wp = dict(zip(ids_p[r].tolist(), np.diff(cdf_p[r])[:k]))
        assert all(abs(int(wp[i]) - int(wj[i])) <= 1 for i in wj), r
        edge = np.zeros(k + 2, bool)
        edge[starts] = True
        edge[k + 1] = True
        assert np.abs(cdf_p[r, edge] - cdf_j[r, edge]).max() <= 1, r


def _same_cdfs(predictors, k, chunks):
    """Both predictors decode ``chunks`` (B, C) step by step; returns the
    number of near ties (adjacent top-k JAX logits within LOGIT_ATOL)."""
    jpred, ppred = predictors
    B, C = chunks.shape
    for pred in predictors:
        pred.set_decode_len(C)
    js, ps = jpred.begin_decode(B), ppred.begin_decode(B)
    prev = np.full(B, jpred.bos_id, np.int32)
    assert ppred.bos_id == jpred.bos_id and ppred.vocab_size == 258
    ties = 0
    for t in range(C):
        jl, js = jpred.decode_step(js, prev)
        pl, ps = ppred.decode_step(ps, prev)
        assert isinstance(pl, torch.Tensor) and pl.shape == jl.shape
        np.testing.assert_allclose(pl.numpy(), jl, atol=LOGIT_ATOL,
                                   rtol=1e-4)
        ids_j, cdf_j = (np.asarray(a) for a in jcdf.topk_cdf_jit(jl, k, 16))
        ids_p, cdf_p = (cdf.to_numpy(a) for a in cdf.topk_cdf(pl, k, 16))
        _assert_same_topk(jl, k, ids_p, cdf_p, ids_j, cdf_j)
        ties += int((np.abs(np.diff(np.take_along_axis(jl, ids_j, 1)))
                     <= LOGIT_ATOL).sum())
        prev = chunks[:, t]
    return ties


@pytest.mark.parametrize("k", [8, 48])
def test_predictors_give_the_same_cdfs(predictors, k):
    _same_cdfs(predictors, k, _text(3 * 12, seed=2).reshape(3, 12))


def test_predictors_give_the_same_cdfs_at_a_near_tie(predictors,
                                                     monkeypatch):
    """The text ``human_like`` draws when ``hash('wiki') % 2**16`` is 173:
    at step 8, lane 0, ids 187 and 145 sit at top-48 positions 37-38 with
    JAX logits 2.4e-7 apart, which the port rounds to one value."""
    monkeypatch.setattr(synthetic, "hash", lambda s: 173, raising=False)
    assert _same_cdfs(predictors, 48,
                      _text(3 * 12, seed=2).reshape(3, 12)) >= 1


def test_service_round_trip_other_lanes_and_grouped_bytes(port_pred):
    toks = [_text(150, seed=3), _text(90, seed=4, domain="code"),
            _text(40, seed=5, domain="math")]
    svc = CompressionService(port_pred, slots=4, chunk_size=16, topk=8,
                             device="cpu")
    blobs = [h.result()[0] for h in [svc.submit_compress(t) for t in toks]]
    # decompress in another order: chunks land on other lanes
    handles = {i: svc.submit_decompress(blobs[i]) for i in (2, 0, 1)}
    for i, t in enumerate(toks):
        assert np.array_equal(handles[i].result(), t)
    # the service writes exactly what the grouped compressor writes at
    # the same lane count (v4, recorded encode batch)
    comp = LLMCompressor(port_pred, chunk_size=16, topk=8, decode_batch=4,
                         container_version=4)
    assert comp.compress(toks[0])[0] == blobs[0]
    assert np.array_equal(comp.decompress(blobs[0]), toks[0])


def test_service_full_vocab_round_trip(port_pred):
    toks = _text(100, seed=6)
    svc = CompressionService(port_pred, slots=4, chunk_size=16, topk=0,
                             device="cpu")
    blob, _ = svc.submit_compress(toks).result()
    assert np.array_equal(svc.submit_decompress(blob).result(), toks)
    comp = LLMCompressor(port_pred, chunk_size=16, topk=0, decode_batch=4,
                         container_version=4)
    assert comp.compress(toks)[0] == blob


def test_grouped_ac_codec_round_trip(port_pred):
    toks = _text(60, seed=7)
    comp = LLMCompressor(port_pred, chunk_size=16, topk=8, decode_batch=4,
                         codec="ac")
    blob, stats = comp.compress(toks)
    assert stats.ideal_bits > 0
    assert np.array_equal(comp.decompress(blob), toks)


def test_cli_round_trip(tmp_path, capsys, monkeypatch, caplog):
    # pred-* predictors are trained at first use: a short recipe put in a
    # cache of the test's own, which both commands load
    caplog.set_level(logging.INFO, logger="repro")    # prep logs via obs
    cache = tmp_path / "cache"
    monkeypatch.setenv("REPRO_TORCH_CACHE", str(cache))
    train_predictor("pred-tiny", steps=3, device="cpu", cache_dir=cache)
    capsys.readouterr()
    caplog.clear()
    src = tmp_path / "in.txt"
    src.write_bytes(synthetic.human_like("novel", 200, seed=8))
    arc, back = tmp_path / "in.llmc", tmp_path / "back.txt"
    common = ["--predictor", "pred-tiny", "--device", "cpu", "--slots", "4"]
    assert cli_main(["compress", str(src), str(arc), "--chunk", "32",
                     *common]) == 0
    assert cli_main(["decompress", str(arc), str(back), *common]) == 0
    assert back.read_bytes() == src.read_bytes()
    assert cli_main(["info", str(arc)]) == 0
    out = capsys.readouterr()
    assert "LLMC v4" in out.out and "UNTRAINED" not in out.err
    assert "training" not in caplog.text
    assert caplog.text.count("loaded") == 2
    assert decode(encode(src.read_bytes())) == src.read_bytes()
