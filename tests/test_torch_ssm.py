"""The port's ssm family (mamba2) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Held, in fp32:

* the plain ``ssd_intra`` (what ``ops.ssd_intra`` runs on a CPU tensor)
  against the Pallas ``ssd_intra`` in interpret mode and against
  ``ssd_intra_ref``, at the shapes of ``tests/test_kernels.py`` and at a
  ragged Q: atol 1e-4, as there;
* ``ssd_chunked`` against the reference's, with S not a chunk multiple,
  S below one chunk, and an entering state: atol 1e-4;
* the tiny mamba2 ``forward`` and a run of ``decode_step``s against
  ``repro.models.mamba2`` on weights carried across by ``from_jax``:
  atol 2e-4, as ``tests/test_models.py`` holds decode against forward;
* inside the port, bit for bit: a reset lane against a fresh cache
  (``conv`` and ``state`` included), a prefix prefill against the same
  steps one by one, and a ``CompressionService`` round trip with chunks
  refilled onto other lanes; ``score_chunks`` against the port's own
  decode program within atol 1e-4 (they differ in the order of sums
  only);
* in bf16 at full width (4 of the 24 layers), the port's forward and
  decode programs sit no further apart than the reference's own do: a
  random SSM amplifies rounding from layer to layer, so the two
  programs' logits differ by far more than bf16's ulp in both packages,
  and chip_smoke.py holds this model's scoring against an fp32 twin.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import mamba2_130m as jmamba  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_intra as jssd_intra  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro_torch.cli import main as cli_main  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.configs import mamba2_130m as pmamba  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.synthetic import human_like  # noqa: E402
from repro_torch.data.tokenizer import encode  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api, mamba2, schema  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402

JCFG = jbase.tiny_variant(jmamba.CONFIG)
PCFG = pbase.tiny_variant(pmamba.CONFIG)
T = torch.from_numpy


def _ssd_inputs(seed, B, Q, H, P, N):
    """The inputs of tests/test_kernels.py::test_ssd_intra, from numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(B, Q, H, P), rng.uniform(0.05, 0.8, (B, Q, H)).astype(
        np.float32), (-rng.uniform(0.3, 2.0, (H,))).astype(np.float32),
        f(B, Q, N), f(B, Q, N))


@pytest.mark.parametrize("B,Q,H,P,N", [
    (2, 16, 3, 8, 4), (1, 32, 2, 16, 8), (2, 64, 4, 8, 16),
    (1, 128, 2, 32, 32), (3, 23, 2, 8, 4),       # the last: a ragged Q
])
def test_plain_ssd_intra_matches_pallas_and_ref(B, Q, H, P, N):
    args = _ssd_inputs(Q + P, B, Q, H, P, N)
    y, s = ops.ssd_intra(*(T(a) for a in args))
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, Q, H, P) and s.shape == (B, H, P, N)
    ja = [jnp.asarray(a) for a in args]
    for want in (jssd_intra(*ja, interpret=True), jref.ssd_intra_ref(*ja)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]),
                                   atol=1e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(want[1]),
                                   atol=1e-4)


@pytest.mark.parametrize("S,chunk,init", [(40, 16, False), (37, 8, True),
                                          (10, 16, True)])
def test_ssd_chunked_matches_jax(S, chunk, init):
    B, H, P, N = 2, 3, 8, 5
    x, dt, A, Bm, Cm = _ssd_inputs(S, B, S, H, P, N)
    s0 = np.random.default_rng(S).normal(size=(B, H, P, N)).astype(
        np.float32) if init else None
    y, fin = mamba2.ssd_chunked(T(x), T(dt), T(A), T(Bm), T(Cm),
                                chunk=chunk,
                                initial_state=None if s0 is None else T(s0))
    jy, jfin = jm2.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk,
        initial_state=None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,chunk", [(16, 16), (11, 16), (1, 8), (40, 64)])
def test_fresh_single_chunk_skips_the_inter_chunk_part_bit_for_bit(
        S, chunk, dtype):
    """With no entering state and one chunk, ssd_chunked returns the
    kernel's y and state as they are; the general path, given an explicit
    zero entering state, computes the same bits the long way."""
    B, H, P, N = 2, 3, 8, 5
    x, dt, A, Bm, Cm = (T(a) for a in _ssd_inputs(S + chunk, B, S, H, P,
                                                     N))
    x, dt, Bm, Cm = (t.to(dtype) for t in (x, dt, Bm, Cm))
    y, fin = mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    zero = torch.zeros((B, H, P, N), dtype=dtype)
    y0, fin0 = mamba2.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk,
                                  initial_state=zero)
    assert y.dtype == fin.dtype == dtype
    assert torch.equal(y, y0) and torch.equal(fin, fin0)


@pytest.fixture(scope="module")
def weights():
    """Tiny mamba2 (2 layers, d=64, N=16, P=16, chunk 16) in both
    packages, on the same weights."""
    assert dataclasses.asdict(JCFG) == dataclasses.asdict(PCFG)
    pnp = jax.tree_util.tree_map(
        np.asarray, jschema.init_params(JCFG, jax.random.PRNGKey(3)))
    return pnp, schema.from_jax(pnp)


def test_schema_and_init_match_the_reference():
    jflat = jax.tree_util.tree_flatten_with_path(
        jschema.schema(JCFG), is_leaf=lambda x: isinstance(x, jschema.Leaf))
    jleaves = {tuple(k.key for k in path): (leaf.shape, leaf.init)
               for path, leaf in jflat[0]}
    pleaves = {path: (leaf.shape, leaf.init)
               for path, leaf in schema._leaves_sorted(schema.schema(PCFG))}
    assert pleaves == jleaves
    assert schema.count_params(pmamba.CONFIG) == jschema.count_params(
        jmamba.CONFIG)
    p = schema.init_params(PCFG, seed=0)["layers"]
    A = torch.exp(p["A_log"])
    assert bool((A >= 1).all()) and bool((A < 16).all())
    assert 0.3 < p["conv_w"].std().item() < 0.7      # 1 / sqrt(4)
    assert get_config("mamba2-130m") == pmamba.CONFIG


def test_forward_matches_jax(weights):
    pnp, params = weights
    toks = np.random.default_rng(1).integers(
        0, JCFG.vocab_size, (2, 40)).astype(np.int32)   # 2.5 chunks
    want = jax.jit(lambda p, t: jm2.forward(p, JCFG, {"tokens": t}))(
        pnp, toks)
    got = api.forward(params, PCFG, {"tokens": T(toks.astype(np.int64))})
    assert got.shape == (2, 40, PCFG.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_decode_steps_match_jax(weights):
    pnp, params = weights
    B, S = 3, 12
    toks = np.random.default_rng(2).integers(
        0, JCFG.vocab_size, (B, S)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t: jm2.decode_step(p, JCFG, c, t))
    jc = jm2.init_cache(JCFG, B, S)
    pc = api.init_cache(PCFG, B, S)
    for t in range(S):
        jl, jc = jstep(pnp, jc, toks[:, t])
        pl, pc = api.decode_step(params, PCFG, pc, T(toks[:, t].astype(
            np.int64)))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=2e-4)
    for name in ("conv", "state"):
        np.testing.assert_allclose(pc[name].numpy(), np.asarray(jc[name]),
                                   atol=2e-4)
    assert pc["pos"].tolist() == [S] * B


@pytest.fixture(scope="module")
def pred():
    return ModelPredictor.random_init(PCFG, seed=0, device="cpu")


def _steps(pred, state, toks):
    out = []
    for t in range(toks.shape[1]):
        lg, state = pred.decode_step(state, toks[:, t])
        out.append(lg)
    return torch.stack(out, 1), state


def test_reset_lane_equals_fresh_cache(pred):
    """A refilled lane carries nothing of the job before it: its conv and
    SSM state are zero after the reset, and its logits are those of a
    fresh cache, bit for bit; the other lanes are untouched."""
    B = 3
    rng = np.random.default_rng(4)
    old, new = (rng.integers(0, 256, (B, n)) for n in (9, 6))
    state = _steps(pred, pred.begin_decode(B), old)[1]
    keep = {k: v.clone() for k, v in state.items()}
    state = pred.reset_slots(state, np.array([False, True, False]))
    for name in ("conv", "state"):
        assert bool((state[name][:, 1] == 0).all())
        assert torch.equal(state[name][:, [0, 2]], keep[name][:, [0, 2]])
    assert state["pos"].tolist() == [9, 0, 9]
    got = _steps(pred, state, new)[0]
    want = _steps(pred, pred.begin_decode(B), new)[0]
    assert torch.equal(got[1], want[1])


def test_prefix_prefill_equals_sequential_steps(pred):
    B, P = 2, 7
    prefix = np.random.default_rng(5).integers(0, 256, (B, P))
    a = pred.begin_decode(B, prefix=prefix)
    b = pred.begin_decode(B)
    inp = np.concatenate([np.full((B, 1), pred.bos_id), prefix[:, :-1]], 1)
    b = _steps(pred, b, inp)[1]
    for name in ("conv", "state", "pos"):
        assert torch.equal(a[name], b[name])


def test_score_chunks_matches_decode_program(pred):
    B, C, P = 3, 20, 5
    rng = np.random.default_rng(6)
    chunks, prefix = rng.integers(0, 256, (B, C)), rng.integers(0, 256,
                                                               (B, P))
    for pre in (None, prefix):
        scored = pred.score_chunks(chunks, prefix=pre)
        state = pred.begin_decode(B, prefix=pre)
        first = np.full((B, 1), pred.bos_id) if pre is None else pre[:, -1:]
        decoded = _steps(pred, state, np.concatenate(
            [first, chunks[:, :-1]], 1))[0]
        assert scored.shape == (B, C, PCFG.vocab_size)
        np.testing.assert_allclose(scored.numpy(), decoded.numpy(),
                                   atol=1e-4)


def test_service_round_trip_refills_other_lanes(pred):
    toks = [encode(human_like("wiki", 150, seed=3)),
            encode(human_like("code", 90, seed=4)),
            encode(human_like("math", 40, seed=5))]
    svc = CompressionService(pred, slots=2, chunk_size=16, topk=8,
                             device="cpu")
    blobs = [h.result()[0] for h in [svc.submit_compress(t) for t in toks]]
    svc = CompressionService(pred, slots=2, chunk_size=16, topk=8,
                             device="cpu")
    handles = {i: svc.submit_decompress(blobs[i]) for i in (2, 0, 1)}
    for i, t in enumerate(toks):
        assert np.array_equal(handles[i].result(), t)


def test_cli_round_trip_full_width(tmp_path):
    """``llmc-torch --predictor mamba2-130m`` on the CPU: the full-width
    config (24 layers, d=768, V=50280, bf16), one small chunk."""
    src = tmp_path / "in.txt"
    src.write_bytes(human_like("novel", 40, seed=8)[:40])
    arc, back = tmp_path / "in.llmc", tmp_path / "back.txt"
    common = ["--predictor", "mamba2-130m", "--device", "cpu",
              "--slots", "2"]
    assert cli_main(["compress", str(src), str(arc), "--chunk", "32",
                     *common]) == 0
    assert cli_main(["decompress", str(arc), str(back), *common]) == 0
    assert back.read_bytes() == src.read_bytes()


def test_bf16_programs_drift_no_further_than_the_reference():
    jcfg = jmamba.CONFIG.with_(n_layers=4)
    pcfg = pmamba.CONFIG.with_(n_layers=4)
    pnp = jax.tree_util.tree_map(
        np.asarray, jschema.init_params(jcfg, jax.random.PRNGKey(0)))
    params = schema.from_jax(pnp)
    B, S, V = 2, 48, jcfg.vocab_size
    toks = np.random.default_rng(0).integers(0, 256, (B, S)).astype(
        np.int32)
    jf = jax.jit(lambda p, t: jm2.forward(p, jcfg, {"tokens": t}))(pnp, toks)
    jstep = jax.jit(lambda p, c, t: jm2.decode_step(p, jcfg, c, t))
    jc, jd = jm2.init_cache(jcfg, B, S), []
    for t in range(S):
        lg, jc = jstep(pnp, jc, toks[:, t])
        jd.append(np.asarray(lg, np.float32))
    pf = api.forward(params, pcfg, {"tokens": T(toks.astype(np.int64))})
    pc, pd = api.init_cache(pcfg, B, S), []
    for t in range(S):
        lg, pc = api.decode_step(params, pcfg, pc,
                                 T(toks[:, t].astype(np.int64)))
        pd.append(lg.float().numpy())
    gap = lambda f, d: np.abs(np.asarray(f, np.float32)[..., :V]  # noqa
                              - np.stack(d, 1)[..., :V])
    ref_gap, port_gap = gap(jf, jd), gap(pf.float().numpy(), pd)
    assert ref_gap.mean() > 0.05            # far above an fp32 rounding
    assert port_gap.mean() <= 1.5 * ref_gap.mean()
    assert port_gap.max() <= 1.5 * ref_gap.max()
