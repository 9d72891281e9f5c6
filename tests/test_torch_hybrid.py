"""The port's hybrid family (zamba2) against the JAX package's, on the CPU.

Two tiny fp32 configs: ``tests/helpers.py``'s ``tiny("hybrid")`` (3 SSD
layers, the shared block after each) and one with a trailing SSD layer
(5 layers in groups of 2: two applications, then layer 4), the shape of
zamba2-7b's 81 = 6 x 13 + 3. Weights are made by the JAX package and
carried across by ``from_jax``; inputs come from numpy seeds. Held:

* the schema (leaf names, shapes, inits) and the parameter count against
  ``repro.models.schema``, at tiny width and at zamba2-7b's (no weights);
* ``forward`` and 12 ``decode_step``s against ``repro.models.hybrid``:
  atol 2e-4, as ``tests/test_torch_ssm.py`` holds mamba2; the cache
  leaves have the reference's shapes and agree to the same tolerance;
* inside the port, bit for bit: a reset lane against a fresh cache
  (every leaf), and a ``CompressionService`` round trip with chunks
  refilled onto other lanes; ``score_chunks`` against the port's own
  decode program within 1e-4 (they differ in the order of sums only);
* ``llmc-torch`` compress / decompress with ``_predictor`` patched to the
  tiny hybrid.

Verify/rollback, prefill, snapshot/restore, the shared-prefix service
and speculative decode run the hybrid as a third family in
``tests/test_torch_engine.py`` and ``tests/test_torch_speculative.py``;
``tests/test_torch_geometry.py`` holds the kernels' launch geometry at
zamba2-7b's shapes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402

from helpers import tiny  # noqa: E402
from repro.configs import zamba2_7b as jzamba  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro_torch import cli as pcli  # noqa: E402
from repro_torch.configs import zamba2_7b as pzamba  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.synthetic import human_like  # noqa: E402
from repro_torch.data.tokenizer import encode  # noqa: E402
from repro_torch.models import api, hybrid, schema  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402

JCFGS = {"tiny": tiny("hybrid"),
         "trailing": tiny("hybrid", n_layers=5, hybrid_ssm_per_block=2)}
T = torch.from_numpy


def _pcfg(name):
    return ModelConfig(**dataclasses.asdict(JCFGS[name]))


@pytest.fixture(scope="module", params=sorted(JCFGS))
def weights(request):
    """(name, JAX params as numpy, the port's params) on one config."""
    jcfg = JCFGS[request.param]
    pnp = jax.tree_util.tree_map(
        np.asarray, jschema.init_params(jcfg, jax.random.PRNGKey(3)))
    return request.param, pnp, schema.from_jax(pnp)


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jschema.Leaf))[0]
    return {tuple(k.key for k in path): (leaf.shape, leaf.init)
            for path, leaf in flat}


@pytest.mark.parametrize("name", sorted(JCFGS))
def test_schema_and_init_match_the_reference(name):
    jcfg, pcfg = JCFGS[name], _pcfg(name)
    pleaves = {path: (leaf.shape, leaf.init)
               for path, leaf in schema._leaves_sorted(schema.schema(pcfg))}
    assert pleaves == _leaves(jschema.schema(jcfg))
    params = schema.init_params(pcfg, seed=0)
    jparams = jschema.init_params(jcfg, jax.random.PRNGKey(0))
    assert {p: tuple(v.shape) for p, v in _flat(params)} == {
        p: tuple(v.shape) for p, v in _flat(jparams)}
    assert list(schema._leaves_sorted(schema.schema(pcfg)))[-1][0][0] == \
        "shared_attn"                       # drawn last


def _flat(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def test_zamba2_7b_config_matches_the_reference():
    assert dataclasses.asdict(pzamba.CONFIG) == dataclasses.asdict(
        jzamba.CONFIG)
    assert get_config("zamba2-7b") == pzamba.CONFIG
    assert schema.count_params(pzamba.CONFIG) == jschema.count_params(
        jzamba.CONFIG)
    assert hybrid.n_applications(pzamba.CONFIG) == 6
    order = hybrid.block_order(pzamba.CONFIG)
    assert [i for k, i in order if k == "ssm"] == list(range(81))
    assert [p for p, (k, _) in enumerate(order) if k == "attn"] == [
        13, 27, 41, 55, 69, 83]             # 3 trailing SSD layers
    assert _leaves(jschema.schema(jzamba.CONFIG)) == {
        path: (leaf.shape, leaf.init) for path, leaf in
        schema._leaves_sorted(schema.schema(pzamba.CONFIG))}


def test_forward_matches_jax(weights):
    name, pnp, params = weights
    jcfg, pcfg = JCFGS[name], _pcfg(name)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)   # 2.5 chunks of 8
    want = jax.jit(lambda p, t: jhybrid.forward(p, jcfg, {"tokens": t}))(
        pnp, toks)
    got = api.forward(params, pcfg, {"tokens": T(toks.astype(np.int64))})
    assert got.shape == (2, 20, pcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    hidden = api.forward(params, pcfg, {"tokens": T(toks.astype(np.int64))},
                         return_hidden=True)
    assert hidden.shape == (2, 20, pcfg.d_model)


def test_decode_steps_match_jax(weights):
    name, pnp, params = weights
    jcfg, pcfg = JCFGS[name], _pcfg(name)
    B, S = 3, 12
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t: jhybrid.decode_step(p, jcfg, c, t))
    jc = jhybrid.init_cache(jcfg, B, S)
    pc = api.init_cache(pcfg, B, S)
    assert {k: tuple(v.shape) for k, v in pc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    for t in range(S):
        jl, jc = jstep(pnp, jc, toks[:, t])
        pl, pc = api.decode_step(params, pcfg, pc, T(toks[:, t].astype(
            np.int64)))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-4)
    for leaf in ("conv", "state", "k", "v"):
        np.testing.assert_allclose(pc[leaf].numpy(), np.asarray(jc[leaf]),
                                   atol=2e-4)
    assert pc["pos"].tolist() == [S] * B


@pytest.fixture(scope="module")
def pred():
    return ModelPredictor.random_init(_pcfg("trailing"), seed=0,
                                      device="cpu")


def _steps(pred, state, toks):
    out = []
    for t in range(toks.shape[1]):
        lg, state = pred.decode_step(state, toks[:, t])
        out.append(lg.clone())
    return torch.stack(out, 1), state


def test_reset_lane_equals_fresh_cache(pred):
    """A refilled lane carries nothing of the job before it: every leaf
    of it is zero after the reset (K/V and the SSD states), its logits
    are those of a fresh cache bit for bit, and the other lanes keep
    theirs."""
    B = 3
    pred.set_decode_len(16)
    rng = np.random.default_rng(4)
    old, new = (rng.integers(0, 256, (B, n)) for n in (9, 6))
    state = _steps(pred, pred.begin_decode(B), old)[1]
    keep = {k: v.clone() for k, v in state.items()}
    state = pred.reset_slots(state, np.array([False, True, False]))
    for name in ("conv", "state", "k", "v"):
        assert bool((state[name][:, 1] == 0).all())
        assert torch.equal(state[name][:, [0, 2]], keep[name][:, [0, 2]])
    assert state["pos"].tolist() == [9, 0, 9]
    got = _steps(pred, state, new)[0]
    want = _steps(pred, pred.begin_decode(B), new)[0]
    assert torch.equal(got[1], want[1])


def test_score_chunks_matches_decode_program(pred):
    B, C, P = 3, 20, 5
    rng = np.random.default_rng(6)
    chunks, prefix = rng.integers(0, 256, (B, C)), rng.integers(0, 256,
                                                               (B, P))
    pred.set_decode_len(C + P + 1)
    for pre in (None, prefix):
        scored = pred.score_chunks(chunks, prefix=pre)
        state = pred.begin_decode(B, prefix=pre)
        first = np.full((B, 1), pred.bos_id) if pre is None else pre[:, -1:]
        decoded = _steps(pred, state, np.concatenate(
            [first, chunks[:, :-1]], 1))[0]
        assert scored.shape == (B, C, pred.vocab_size)
        np.testing.assert_allclose(scored.numpy(), decoded.numpy(),
                                   atol=1e-4)


def test_service_round_trip_refills_other_lanes(pred):
    toks = [encode(human_like("wiki", 150, seed=3)),
            encode(human_like("code", 90, seed=4)),
            encode(human_like("math", 40, seed=5))]
    kw = dict(slots=2, chunk_size=16, topk=8, device="cpu")
    svc = CompressionService(pred, **kw)
    blobs = [h.result()[0] for h in [svc.submit_compress(t) for t in toks]]
    svc = CompressionService(pred, **kw)
    handles = {i: svc.submit_decompress(blobs[i]) for i in (2, 0, 1)}
    for i, t in enumerate(toks):
        assert np.array_equal(handles[i].result(), t)


def test_cli_round_trip(tmp_path, monkeypatch, pred):
    monkeypatch.setattr(pcli, "_predictor", lambda args: pred)
    src = tmp_path / "in.txt"
    src.write_bytes(human_like("novel", 100, seed=8)[:100])
    arc, back = tmp_path / "in.llmc", tmp_path / "back.txt"
    common = ["--predictor", "zamba2-7b", "--device", "cpu", "--slots",
              "2"]
    assert pcli.main(["compress", str(src), str(arc), "--chunk", "32",
                      *common]) == 0
    assert pcli.main(["decompress", str(arc), str(back), *common]) == 0
    assert back.read_bytes() == src.read_bytes()
