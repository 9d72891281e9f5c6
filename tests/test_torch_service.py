"""The port's slice as a whole on the CPU: predictor, service, CLI.

* A JAX ``ModelPredictor`` and the port's, on converted weights, see the
  same chunks: per-step top-k ids equal and CDFs within one quantum.
* The port's service round trip is lossless, its bytes equal the port's
  grouped-path bytes, chunks decode on other lanes, and ``--topk 0``
  (full-vocabulary CDF) round-trips.
* ``llmc-torch compress`` -> ``decompress`` (tiny config, ``--device
  cpu``) is byte-identical.

Container bytes *between* the packages may differ: the engine is part of
the coding geometry (ROADMAP).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import paper_predictors as jpp  # noqa: E402
from repro.core import cdf as jcdf  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.serve.engine import ModelPredictor as JaxPredictor  # noqa: E402
from repro_torch.cli import main as cli_main  # noqa: E402
from repro_torch.configs import paper_predictors as ppp  # noqa: E402
from repro_torch.core import LLMCompressor  # noqa: E402
from repro_torch.core import cdf  # noqa: E402
from repro_torch.data.synthetic import human_like  # noqa: E402
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
    return encode(human_like(domain, n, seed=seed))


@pytest.mark.parametrize("k", [8, 48])
def test_predictors_give_the_same_cdfs(predictors, k):
    jpred, ppred = predictors
    B, C = 3, 12
    chunks = _text(B * C, seed=2).reshape(B, C)
    for pred in predictors:
        pred.set_decode_len(C)
    js, ps = jpred.begin_decode(B), ppred.begin_decode(B)
    prev = np.full(B, jpred.bos_id, np.int32)
    assert ppred.bos_id == jpred.bos_id and ppred.vocab_size == 258
    for t in range(C):
        jl, js = jpred.decode_step(js, prev)
        pl, ps = ppred.decode_step(ps, prev)
        assert isinstance(pl, torch.Tensor) and pl.shape == jl.shape
        np.testing.assert_allclose(pl.numpy(), jl, atol=1e-4, rtol=1e-4)
        ids_j, cdf_j = (np.asarray(a) for a in jcdf.topk_cdf_jit(jl, k, 16))
        ids_p, cdf_p = (cdf.to_numpy(a) for a in cdf.topk_cdf(pl, k, 16))
        assert np.array_equal(ids_p, ids_j)
        assert np.abs(cdf_p - cdf_j).max() <= 1
        prev = chunks[:, t]


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


def test_cli_round_trip(tmp_path, capsys):
    src = tmp_path / "in.txt"
    src.write_bytes(human_like("novel", 200, seed=8))
    arc, back = tmp_path / "in.llmc", tmp_path / "back.txt"
    common = ["--predictor", "pred-tiny", "--device", "cpu", "--slots", "4"]
    assert cli_main(["compress", str(src), str(arc), "--chunk", "32",
                     *common]) == 0
    assert cli_main(["decompress", str(arc), str(back), *common]) == 0
    assert back.read_bytes() == src.read_bytes()
    assert cli_main(["info", str(arc)]) == 0
    out = capsys.readouterr()
    assert "LLMC v4" in out.out and "UNTRAINED" in out.err
    assert decode(encode(src.read_bytes())) == src.read_bytes()
