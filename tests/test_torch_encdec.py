"""The port's encdec family (whisper) against the JAX package's, on the CPU.

``tests/helpers.py``'s ``tiny("encdec")`` (2 encoder and 2 decoder
layers, d=64, GQA 4/2, fp32) with ``max_source_len`` 32, fed frames of 8
positions as the JAX package's own tests feed them: the cross cache is
sized from the frames. Weights are made by the JAX package and carried
across by ``from_jax``; inputs come from numpy seeds. Held:

* the schema (leaf names, shapes, inits) and the parameter count against
  ``repro.models.schema``, at tiny width and at whisper-large-v3's;
* ``sinusoidal``, ``encode``, ``precompute_cross_kv``, ``forward`` (frames
  of batch 1 and of batch B) and a decode loop against
  ``repro.models.encdec``: atol 1e-5 for the encoder's function alone
  (one fp32 program against another, differing in the order of sums),
  2e-4 for logits, as ``tests/test_torch_hybrid.py`` holds its model;
  the decode loop also against the port's own teacher-forced forward
  within 2e-4 (``tests/test_models.py``'s check);
* ``ModelPredictor.score_chunks``, fresh and under a prefix, against the
  JAX ``ModelPredictor`` with the same frames: atol/rtol 1e-4, as
  ``tests/test_torch_score.py`` holds the dense family;
* inside the port, bit for bit or byte for byte: an exact-mode
  ``LLMCompressor`` round trip with frames of batch 1; the service round
  trip with more jobs than slots (lanes refilled); speculative decode
  against lock-step; ``reset_slots``, ``snapshot_slot``, ``restore_slot``
  and ``rollback`` leaving the cross K/V as they were, and a snapshot
  holding none of their bytes; a reset lane against a fresh cache; every
  engine call keeping each leaf's storage;
* frames whose batch is neither 1 nor the lanes' refused, and a
  predictor without frames refused; training through the scoring
  forward (the prefill kernel has no backward) refused, where
  ``loss_fn``'s forward trains (``tests/test_torch_train_families.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402

from helpers import tiny  # noqa: E402
from repro.configs import whisper_large_v3 as jwhisper  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.serve.engine import ModelPredictor as JPredictor  # noqa: E402
from repro_torch import cli as pcli  # noqa: E402
from repro_torch.configs import whisper_large_v3 as pwhisper  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import LLMCompressor  # noqa: E402
from repro_torch.data.synthetic import human_like  # noqa: E402
from repro_torch.data.tokenizer import encode as tok_encode  # noqa: E402
from repro_torch.models import api, encdec, schema  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402
from repro_torch.train.optimizer import tree_map  # noqa: E402

JCFG = tiny("encdec", vocab_size=258, max_source_len=32)
PCFG = ModelConfig(**dataclasses.asdict(JCFG))
SE = 8                                      # frames shorter than 32
ENC_TOL = dict(atol=1e-5, rtol=0)
LOGIT_TOL = dict(atol=2e-4, rtol=0)
SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
T = torch.from_numpy


def _frames(batch, seed=0, n=SE):
    return np.random.default_rng(seed).normal(
        size=(batch, n, JCFG.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    pnp = jax.tree_util.tree_map(
        np.asarray, jschema.init_params(JCFG, jax.random.PRNGKey(3)))
    return pnp, schema.from_jax(pnp)


@pytest.fixture(scope="module")
def pred(weights):
    return ModelPredictor(weights[1], PCFG,
                          extra_batch={"frames": _frames(1)}, device="cpu")


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jschema.Leaf))[0]
    return {tuple(k.key for k in path): (leaf.shape, leaf.init)
            for path, leaf in flat}


@pytest.mark.parametrize("which", ["tiny", "whisper-large-v3"])
def test_schema_and_count_match_the_reference(which):
    jcfg = JCFG if which == "tiny" else jwhisper.CONFIG
    pcfg = PCFG if which == "tiny" else pwhisper.CONFIG
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert {path: (leaf.shape, leaf.init) for path, leaf in
            schema._leaves_sorted(schema.schema(pcfg))} == _leaves(
                jschema.schema(jcfg))
    assert schema.count_params(pcfg) == jschema.count_params(jcfg)
    if which != "tiny":
        assert get_config("whisper-large-v3") == pcfg
        assert (pcfg.padded_heads, pcfg.padded_kv_heads, pcfg.head_dim,
                pcfg.padded_vocab) == (32, 32, 64, 51968)


@pytest.mark.parametrize("S,D", [(8, 64), (1500, 1280), (7, 6)])
def test_sinusoidal_matches_jax(S, D):
    np.testing.assert_array_equal(encdec.sinusoidal(S, D).numpy(),
                                  np.asarray(jencdec.sinusoidal(S, D)))


def test_encode_and_cross_kv_match_jax(weights):
    pnp, params = weights
    fr = _frames(2, seed=1)
    want = jax.jit(lambda p, f: jencdec.encode(p, JCFG, f))(pnp, fr)
    np.testing.assert_allclose(encdec.encode(params, PCFG, T(fr)).numpy(),
                               np.asarray(want), **ENC_TOL)
    jk, jv = jax.jit(lambda p, f: jencdec.precompute_cross_kv(p, JCFG, f))(
        pnp, fr)
    pk, pv = encdec.precompute_cross_kv(params, PCFG, T(fr))
    assert pk.shape == (JCFG.n_layers, 2, SE, JCFG.padded_kv_heads,
                        JCFG.head_dim)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jk), **ENC_TOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), **ENC_TOL)


@pytest.mark.parametrize("frames_batch", [1, 3])
@pytest.mark.parametrize("attn_impl", ["flash", "masked"])
def test_forward_matches_jax(weights, frames_batch, attn_impl):
    pnp, params = weights
    toks = np.random.default_rng(2).integers(0, 258, (3, 12)).astype(
        np.int32)
    fr = _frames(frames_batch, seed=frames_batch)
    want = jax.jit(lambda p, f, t: jencdec.forward(
        p, JCFG, {"frames": f, "tokens": t}))(pnp, fr, toks)
    got = api.forward(params, PCFG, {"frames": T(fr),
                                     "tokens": T(toks.astype(np.int64))},
                      attn_impl=attn_impl)
    assert got.shape == (3, 12, PCFG.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_decode_loop_matches_jax_and_own_forward(weights):
    pnp, params = weights
    B, S = 3, 12
    toks = np.random.default_rng(4).integers(0, 258, (B, S)).astype(
        np.int32)
    fr = _frames(B, seed=5)
    jc = jencdec.init_cache(JCFG, B, S, source_len=SE)
    jc["xk"], jc["xv"] = jencdec.precompute_cross_kv(pnp, JCFG, fr)
    jstep = jax.jit(lambda p, c, t: jencdec.decode_step(p, JCFG, c, t))
    pc = api.init_cache(PCFG, B, S, source_len=SE)
    assert {k: tuple(v.shape) for k, v in pc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    encdec.write_cross_kv(params, PCFG, pc["xk"], pc["xv"], T(fr))
    steps = []
    for t in range(S):
        jl, jc = jstep(pnp, jc, toks[:, t])
        pl, pc = api.decode_step(params, PCFG, pc, T(toks[:, t].astype(
            np.int64)))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
        steps.append(pl)
    for leaf in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(pc[leaf].numpy(), np.asarray(jc[leaf]),
                                   **LOGIT_TOL)
    assert pc["pos"].tolist() == [S] * B
    forced = api.forward(params, PCFG, {"frames": T(fr),
                                        "tokens": T(toks.astype(np.int64))})
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               forced.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("prefix", [None, "per-lane", "shared"])
@pytest.mark.parametrize("frames_batch", [1, 4])
def test_score_chunks_matches_jax(weights, prefix, frames_batch):
    pnp, params = weights
    fr = _frames(frames_batch, seed=6)
    jpred = JPredictor(pnp, JCFG, extra_batch={"frames": fr})
    ppred = ModelPredictor(params, PCFG, extra_batch={"frames": fr},
                           device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, (4, 20)).astype(np.int32)
    pre = {None: None, "per-lane": rng.integers(0, 256, (4, 6)),
           "shared": rng.integers(0, 256, (9,))}[prefix]
    pre = None if pre is None else pre.astype(np.int32)
    want = jpred.score_chunks(toks) if pre is None \
        else jpred.score_chunks(toks, prefix=pre)
    got = ppred.score_chunks(toks, prefix=pre)
    assert got.shape == (4, 20, PCFG.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)


def _steps(pred, state, toks):
    out = []
    for t in range(toks.shape[1]):
        lg, state = pred.decode_step(state, toks[:, t])
        out.append(lg.clone())
    return torch.stack(out, 1), state


@pytest.mark.parametrize("frames_batch", [1, 3])
def test_decode_program_matches_jax_predictor(weights, frames_batch):
    """begin_decode writes the cross K/V from the predictor's frames: the
    JAX engine's decode program on the same frames (broadcast from batch
    1, or one per lane), step by step."""
    pnp, params = weights
    fr = _frames(frames_batch, seed=8)
    jpred = JPredictor(pnp, JCFG, extra_batch={"frames": fr})
    ppred = ModelPredictor(params, PCFG, extra_batch={"frames": fr},
                           device="cpu")
    for p in (jpred, ppred):
        p.set_decode_len(16)
    toks = np.random.default_rng(9).integers(0, 256, (3, 10))
    js, ps = jpred.begin_decode(3), ppred.begin_decode(3)
    assert tuple(ps["xk"].shape[1:3]) == (frames_batch, SE)
    for t in range(toks.shape[1]):
        jl, js = jpred.decode_step(js, toks[:, t].astype(np.int32))
        pl, ps = ppred.decode_step(ps, toks[:, t])
        np.testing.assert_allclose(pl.numpy(), jl, **SCORE_TOL)


def test_score_chunks_matches_own_decode_program(pred):
    B, C, P = 3, 16, 5
    rng = np.random.default_rng(10)
    chunks, prefix = rng.integers(0, 256, (B, C)), rng.integers(0, 256,
                                                               (B, P))
    pred.set_decode_len(C + P + 1)
    for pre in (None, prefix):
        scored = pred.score_chunks(chunks, prefix=pre)
        state = pred.begin_decode(B, prefix=pre)
        first = np.full((B, 1), pred.bos_id) if pre is None else pre[:, -1:]
        decoded = _steps(pred, state, np.concatenate(
            [first, chunks[:, :-1]], 1))[0]
        np.testing.assert_allclose(scored.numpy(), decoded.numpy(),
                                   atol=1e-4)


def test_exact_round_trip_with_frames_of_batch_one(pred):
    toks = tok_encode(human_like("wiki", 200, seed=12))
    comp = LLMCompressor(pred, chunk_size=32, topk=8, decode_batch=4)
    blob, _ = comp.compress(toks)
    assert np.array_equal(comp.decompress(blob), toks)
    # another grouping of the chunks decodes the same bytes
    assert np.array_equal(LLMCompressor(pred, chunk_size=32, topk=8,
                                        decode_batch=4).decompress(blob),
                          toks)


def test_service_round_trip_refills_lanes(pred):
    toks = [tok_encode(human_like("wiki", 150, seed=3)),
            tok_encode(human_like("code", 90, seed=4)),
            tok_encode(human_like("math", 40, seed=5))]
    kw = dict(slots=2, chunk_size=16, topk=8, device="cpu")
    svc = CompressionService(pred, **kw)
    blobs = [h.result()[0] for h in [svc.submit_compress(t) for t in toks]]
    svc = CompressionService(pred, **kw)
    handles = {i: svc.submit_decompress(blobs[i]) for i in (2, 0, 1)}
    for i, t in enumerate(toks):
        assert np.array_equal(handles[i].result(), t)


def test_speculative_equals_lockstep(pred):
    toks = np.random.default_rng(13).integers(0, 250, 120).astype(np.int32)
    comp = LLMCompressor(pred, chunk_size=24, topk=16, decode_batch=4)
    blob, _ = comp.compress(toks)
    spec = LLMCompressor(pred, chunk_size=24, topk=16, decode_batch=4,
                         draft_k=3)
    assert np.array_equal(spec.decompress(blob), toks)


def test_lane_calls_leave_the_cross_cache_alone(pred):
    """reset_slots, snapshot_slot, restore_slot and rollback write the
    per-lane leaves only: the cross K/V stay the frames' bit for bit, and
    a snapshot holds none of their bytes; every call keeps each leaf's
    storage."""
    B = 3
    pred.set_decode_len(24)
    state = pred.begin_decode(B, prefix=np.array([4, 5, 6]))
    cross = {k: state[k].clone() for k in ("xk", "xv")}
    ptrs = {k: v.untyped_storage().data_ptr() for k, v in state.items()}
    _steps(pred, state, np.random.default_rng(14).integers(0, 256, (B, 4)))
    snap = pred.snapshot_slot(state, 1)
    assert set(snap) == {"k", "v", "pos"}
    assert api.conditioning_leaves(PCFG) == ("xk", "xv")
    calls = [
        lambda s: pred.reset_slots(s, np.array([True, False, True])),
        lambda s: pred.restore_slot(s, snap, np.array([True, False, False])),
        lambda s: pred.rollback(pred.verify_steps(
            s, np.random.default_rng(15).integers(0, 256, (B, 4)))[1],
            np.array([0, 2, 4])),
        lambda s: pred.decode_step(s, np.array([1, 2, 3]))[1],
    ]
    for call in calls:
        assert call(state) is state
        for k, v in cross.items():
            assert torch.equal(state[k], v), k
        assert {k: v.untyped_storage().data_ptr()
                for k, v in state.items()} == ptrs


def test_reset_lane_equals_fresh_cache(pred):
    """A refilled lane attends the frames, not zeros: its logits are a
    fresh cache's bit for bit, and the other lanes keep their state."""
    B = 3
    pred.set_decode_len(16)
    rng = np.random.default_rng(16)
    old, new = rng.integers(0, 256, (B, 9)), rng.integers(0, 256, (B, 6))
    state = _steps(pred, pred.begin_decode(B), old)[1]
    keep = {k: v.clone() for k, v in state.items()}
    pred.reset_slots(state, np.array([False, True, False]))
    for name in ("k", "v"):
        assert bool((state[name][:, 1] == 0).all())
        assert torch.equal(state[name][:, [0, 2]], keep[name][:, [0, 2]])
    assert state["pos"].tolist() == [9, 0, 9]
    got = _steps(pred, state, new)[0]
    want = _steps(pred, pred.begin_decode(B), new)[0]
    assert torch.equal(got[1], want[1])


def test_frames_of_the_full_source_length(weights):
    """Frames as long as max_source_len (32) size the cross cache so."""
    ppred = ModelPredictor(weights[1], PCFG,
                           extra_batch={"frames": _frames(1, n=32)},
                           device="cpu")
    ppred.set_decode_len(8)
    assert ppred.begin_decode(2)["xk"].shape[2] == 32


def test_frames_batch_neither_one_nor_the_lanes_is_refused(weights):
    ppred = ModelPredictor(weights[1], PCFG,
                           extra_batch={"frames": _frames(2)}, device="cpu")
    ppred.set_decode_len(8)
    with pytest.raises(ValueError, match="frames of batch 2"):
        ppred.begin_decode(3)
    with pytest.raises(ValueError, match="frames of batch 2"):
        ppred.score_chunks(np.zeros((3, 8), np.int64))
    assert ppred.begin_decode(2)["xk"].shape[1] == 2
    with pytest.raises(ValueError, match="frames"):
        ModelPredictor(weights[1], PCFG, device="cpu")


def test_random_init_draws_frames_from_the_seed():
    a = ModelPredictor.random_init(PCFG, seed=3, device="cpu")
    b = ModelPredictor.random_init(PCFG, seed=3, device="cpu")
    assert a.extra_batch["frames"].shape == (1, 32, PCFG.d_model)
    assert torch.equal(a.extra_batch["frames"], b.extra_batch["frames"])
    assert torch.equal(a.score_chunks(np.ones((2, 8), np.int64)),
                       b.score_chunks(np.ones((2, 8), np.int64)))


def _grad_weights(weights):
    return tree_map(lambda w: w.detach().requires_grad_(True), weights[1])


def _frames_batch():
    return {"tokens": torch.zeros((1, 8), dtype=torch.int64),
            "frames": T(_frames(1))}


def test_training_is_refused_with_its_roadmap_item(weights):
    """Training through the scoring forward (the prefill kernel, which has
    no backward) is refused, and the refusal names the forward that
    trains (``models.api.TRAIN_FORWARD``)."""
    with pytest.raises(RuntimeError, match="no backward.*TRAIN_FORWARD"):
        api.forward(_grad_weights(weights), PCFG, _frames_batch())


def test_loss_fn_trains_through_the_training_forward(weights):
    loss = api.loss_fn(_grad_weights(weights), PCFG, _frames_batch())
    assert loss.requires_grad


def test_cli_round_trip(tmp_path, monkeypatch, pred):
    monkeypatch.setattr(pcli, "_predictor", lambda args: pred)
    src = tmp_path / "in.txt"
    src.write_bytes(human_like("novel", 100, seed=8)[:100])
    arc, back = tmp_path / "in.llmc", tmp_path / "back.txt"
    common = ["--predictor", "whisper-large-v3", "--device", "cpu",
              "--slots", "2"]
    assert pcli.main(["compress", str(src), str(arc), "--chunk", "32",
                      *common]) == 0
    assert pcli.main(["decompress", str(arc), str(back), *common]) == 0
    assert back.read_bytes() == src.read_bytes()
