"""The port's moe family (granite-moe, qwen3-moe) against the JAX
package's, on the CPU.

Two tiny fp32 configs: ``tests/helpers.py``'s ``tiny("moe")`` (4
experts, top 2) and qwen3-moe's ``tiny_variant`` with qk-norm, 8 experts
top 4 and 16 q-heads over 1 kv-head (G = 16, the group qwen3-moe-235b-a22b
gives the decode kernel). Weights are made by the JAX package and carried
across by ``from_jax``; inputs come from numpy seeds. Held:

* the schema (leaf names, shapes, inits) and the parameter count against
  ``repro.models.schema``, at tiny width and at both published widths
  (no weights);
* ``forward`` and 12 ``decode_step``s against ``repro.models.moe``
  (``dropless=True``): atol/rtol 1e-4, the dense family's tolerance
  (``tests/test_torch_model.py``); the K/V cache to the same;
* the dispatch grouping changes nothing (``tests/test_models.py``'s
  dropless group invariance, ragged last group included) and scoring's
  group size is a function of the config alone; a planted
  router tie picks JAX's experts in JAX's order (the lower id first),
  and each piece of the dispatch (``route``, ``rank_within_expert``)
  equals JAX's;
* inside the port, bit for bit: a lane's logits whatever the other lanes
  hold (permuted or replaced), a reset lane against a fresh cache, and a
  ``CompressionService`` round trip with chunks refilled onto other
  lanes; ``score_chunks`` against the port's own decode program within
  1e-4 (the two differ in the order of sums only);
* ``llmc-torch`` compress / decompress with ``_predictor`` patched to the
  tiny moe; an int8 KV cache refused, and training refused.

Verify/rollback, prefill, snapshot/restore, the shared-prefix service
and speculative decode run the moe family as a fourth family in
``tests/test_torch_engine.py`` and ``tests/test_torch_speculative.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import tiny  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import granite_moe_1b_a400m as jgranite  # noqa: E402
from repro.configs import qwen3_moe_235b_a22b as jqmoe  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro_torch import cli as pcli  # noqa: E402
from repro_torch.configs import granite_moe_1b_a400m as pgranite  # noqa: E402
from repro_torch.configs import qwen3_moe_235b_a22b as pqmoe  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.synthetic import human_like  # noqa: E402
from repro_torch.data.tokenizer import encode  # noqa: E402
from repro_torch.models import api, moe, schema  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402

JCFGS = {"tiny": tiny("moe"),
         "qwen3-moe": jbase.tiny_variant(jqmoe.CONFIG, n_experts=8, top_k=4,
                                         n_heads=16, n_kv_heads=1)}
TOL = dict(atol=1e-4, rtol=1e-4)
T = torch.from_numpy


def _pcfg(name):
    return ModelConfig(**dataclasses.asdict(JCFGS[name]))


def _jparams(jcfg, seed=3):
    return jax.tree_util.tree_map(
        np.asarray, jschema.init_params(jcfg, jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module", params=sorted(JCFGS))
def weights(request):
    """(name, JAX params as numpy, the port's params) on one config."""
    pnp = _jparams(JCFGS[request.param])
    return request.param, pnp, schema.from_jax(pnp)


def _leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jschema.Leaf))[0]
    return {tuple(k.key for k in path): (leaf.shape, leaf.axes, leaf.init,
                                         leaf.scale)
            for path, leaf in flat}


def _pleaves(cfg):
    return {path: (leaf.shape, leaf.axes, leaf.init, leaf.scale)
            for path, leaf in schema._leaves_sorted(schema.schema(cfg))}


@pytest.mark.parametrize("name", sorted(JCFGS))
def test_schema_and_init_match_the_reference(name):
    jcfg, pcfg = JCFGS[name], _pcfg(name)
    assert _pleaves(pcfg) == _leaves(jschema.schema(jcfg))
    params = schema.init_params(pcfg, seed=0)
    E, D, F = pcfg.n_experts, pcfg.d_model, pcfg.d_ff
    lay = params["layers"]
    assert tuple(lay["router"].shape) == (pcfg.n_layers, D, E)
    assert tuple(lay["we_down"].shape) == (pcfg.n_layers, E, F, D)
    for leaf, fan in (("router", D), ("we_gate", D), ("we_up", D),
                      ("we_down", F)):      # normal over sqrt(fan-in)
        assert abs(lay[leaf].std().item() * np.sqrt(fan) - 1) < 0.15, leaf
    assert schema.count_params(pcfg) == jschema.count_params(jcfg)


@pytest.mark.parametrize("pmod,jmod", [(pgranite, jgranite), (pqmoe, jqmoe)])
def test_published_configs_match_the_reference(pmod, jmod):
    """Both configs as the JAX package has them, with the same schema and
    parameter count at full width and depth (no weights made)."""
    assert dataclasses.asdict(pmod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert get_config(pmod.CONFIG.name) == pmod.CONFIG
    assert _pleaves(pmod.CONFIG) == _leaves(jschema.schema(jmod.CONFIG))
    assert schema.count_params(pmod.CONFIG) == jschema.count_params(
        jmod.CONFIG)


def test_published_widths():
    g, q = pgranite.CONFIG, pqmoe.CONFIG
    assert (g.padded_heads, g.padded_kv_heads, g.head_dim) == (16, 8, 64)
    assert (q.padded_heads, q.padded_kv_heads, q.head_dim) == (64, 4, 128)
    assert q.q_per_kv == 16                 # the decode kernel's G
    assert round(schema.count_params(g) / 1e9, 2) == 1.39
    assert round(schema.count_params(q.with_(n_layers=4)) / 1e9, 1) == 11.2


def test_scoring_dispatch_groups_are_static():
    """Scoring's dispatch group is a function of the config alone: the
    most tokens whose (E, C, D) buffer fits DISPATCH_BYTES (1 GiB)."""
    q, g = pqmoe.CONFIG, pgranite.CONFIG
    assert moe.group_size(q) == 1024
    assert moe.group_size(q.with_(dtype="float32")) == 512
    assert moe.group_size(g) == 16384       # 16 x 160 tokens in one
    for cfg in (q, g):
        assert moe.group_size(cfg) * cfg.n_experts * cfg.d_model * 2 \
            == moe.DISPATCH_BYTES


def test_forward_matches_jax(weights):
    name, pnp, params = weights
    jcfg, pcfg = JCFGS[name], _pcfg(name)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    want = jax.jit(lambda p, t: jmoe.forward(p, jcfg, {"tokens": t},
                                             dropless=True))(pnp, toks)
    got = api.forward(params, pcfg, {"tokens": T(toks.astype(np.int64))})
    assert got.shape == (2, 20, pcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    hidden = api.forward(params, pcfg, {"tokens": T(toks.astype(np.int64))},
                         return_hidden=True)
    assert hidden.shape == (2, 20, pcfg.d_model)


def test_decode_steps_match_jax(weights):
    name, pnp, params = weights
    jcfg, pcfg = JCFGS[name], _pcfg(name)
    B, S = 3, 12
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t: jmoe.decode_step(p, jcfg, c, t,
                                                     dropless=True))
    jc = jmoe.init_cache(jcfg, B, S)
    pc = api.init_cache(pcfg, B, S)
    assert {k: tuple(v.shape) for k, v in pc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    for t in range(S):
        jl, jc = jstep(pnp, jc, toks[:, t])
        pl, pc = api.decode_step(params, pcfg, pc, T(toks[:, t].astype(
            np.int64)))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(pc[leaf].numpy(), np.asarray(jc[leaf]),
                                   **TOL)
    assert pc["pos"].tolist() == [S] * B


@pytest.mark.parametrize("group", [16, 24])
def test_dropless_group_invariance(group):
    """Dropless dispatch does not depend on the dispatch grouping (the
    lossless-serving requirement; ``tests/test_models.py``), a ragged last
    group included (64 tokens in groups of 24)."""
    pcfg = _pcfg("tiny")
    params = schema.init_params(pcfg, seed=0)
    toks = T(np.random.default_rng(1).integers(0, 257, (2, 32)))
    a = api.forward(params, pcfg, {"tokens": toks}, dispatch_group=0)
    b = api.forward(params, pcfg, {"tokens": toks}, dispatch_group=group)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def _route_inputs(seed, T_, D, E):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T_, D)).astype(np.float32)
    w = rng.normal(size=(D, E)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("tie", ["columns", "zero"])
def test_router_ties_pick_jax_experts_in_jax_order(tie):
    """Equal router logits (here planted: experts 1, 2 and 5 share one
    router column, or every column is zero so that all E experts tie)
    select the lower expert ids first, in the order ``jax.lax.top_k``
    gives them, with JAX's weights."""
    x, w = _route_inputs(4, 40, 16, 8)
    if tie == "columns":
        w[:, 2] = w[:, 1]
        w[:, 5] = w[:, 1]
    else:
        w[:] = 0.0
    jw, je = jmoe._route(jnp.asarray(x), jnp.asarray(w), 4)
    pw, pe = moe.route(T(x), T(w), 4)
    assert np.array_equal(pe.numpy(), np.asarray(je))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=1e-6)
    if tie == "zero":
        assert (pe.numpy() == np.arange(4)).all()
        return
    split = 0
    for row in pe.tolist():                 # the lower ids, in order
        picked = [e for e in row if e in (1, 2, 5)]
        assert picked == [1, 2, 5][:len(picked)]
        split += len(picked) in (1, 2)      # the top k cut the tie
    assert split


def test_planted_tie_decodes_as_jax():
    """The whole model with tied router columns in every layer (experts
    0 and 3 of 4) against JAX's decode steps."""
    jcfg, pcfg = JCFGS["tiny"], _pcfg("tiny")
    pnp = _jparams(jcfg, seed=5)
    router = np.array(pnp["layers"]["router"])
    router[..., 3] = router[..., 0]
    pnp["layers"]["router"] = router
    params = schema.from_jax(pnp)
    B, S = 4, 6
    toks = np.random.default_rng(6).integers(0, 257, (B, S)).astype(np.int32)
    jc, pc = jmoe.init_cache(jcfg, B, S), api.init_cache(pcfg, B, S)
    for t in range(S):
        jl, jc = jmoe.decode_step(pnp, jcfg, jc, toks[:, t], dropless=True)
        pl, pc = api.decode_step(params, pcfg, pc,
                                 T(toks[:, t].astype(np.int64)))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("Tk,E", [(24, 4), (128, 32), (64, 128)])
def test_rank_within_expert_matches_jax(Tk, E):
    fe = np.random.default_rng(Tk).integers(0, E, Tk)
    want = np.asarray(jmoe._rank_within_expert(jnp.asarray(fe), E))
    got = moe.rank_within_expert(T(fe), E).numpy()
    assert np.array_equal(got, want)
    # each expert's ranks are 0..n-1 in arrival order: no two (token,
    # slot)s share a buffer row
    assert len(set(zip(fe.tolist(), got.tolist()))) == Tk


@pytest.fixture(scope="module")
def pred():
    return ModelPredictor.random_init(_pcfg("qwen3-moe"), seed=0,
                                      device="cpu")


def _steps(pred, state, toks):
    out = []
    for t in range(toks.shape[1]):
        lg, state = pred.decode_step(state, toks[:, t])
        out.append(lg.clone())
    return torch.stack(out, 1), state


def test_a_lane_does_not_depend_on_the_other_lanes(pred):
    """Bit for bit: a lane's logits are the same whatever the other lanes
    of the step hold -- their tokens permuted or replaced, which moves
    where the lane's tokens land in each expert's buffer -- and a sequence
    gives the same logits on whichever lane it runs."""
    B, n = 8, 8
    pred.set_decode_len(16)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 256, (B, n))
    base = _steps(pred, pred.begin_decode(B), toks)[0]
    perm = np.concatenate([[0], 1 + np.roll(np.arange(B - 1), 3)])
    got = _steps(pred, pred.begin_decode(B), toks[perm])[0]
    assert torch.equal(got, base[perm])
    for lane in (0, 5):
        other = rng.integers(0, 256, (B, n))
        other[lane] = toks[lane]
        got = _steps(pred, pred.begin_decode(B), other)[0]
        assert torch.equal(got[lane], base[lane])
    moved = np.roll(np.arange(B), 2)
    got = _steps(pred, pred.begin_decode(B), toks[moved])[0]
    assert torch.equal(got, base[moved])


def test_reset_lane_equals_fresh_cache(pred):
    B = 3
    pred.set_decode_len(16)
    rng = np.random.default_rng(4)
    old, new = (rng.integers(0, 256, (B, n)) for n in (9, 6))
    state = _steps(pred, pred.begin_decode(B), old)[1]
    keep = {k: v.clone() for k, v in state.items()}
    state = pred.reset_slots(state, np.array([False, True, False]))
    for name in ("k", "v"):
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
    common = ["--predictor", "granite-moe-1b-a400m", "--device", "cpu",
              "--slots", "2"]
    assert pcli.main(["compress", str(src), str(arc), "--chunk", "32",
                      *common]) == 0
    assert pcli.main(["decompress", str(arc), str(back), *common]) == 0
    assert back.read_bytes() == src.read_bytes()


def test_int8_cache_and_training_are_refused():
    pcfg = _pcfg("tiny")
    with pytest.raises(NotImplementedError, match="no scales"):
        api.init_cache(pcfg.with_(kv_cache_dtype="int8"), 2, 8)
    params = schema.init_params(pcfg, seed=0)
    with pytest.raises(NotImplementedError, match="capacity-dropped"):
        api.loss_fn(params, pcfg, {"tokens": torch.zeros((1, 8),
                                                         dtype=torch.long)})
    assert api.rollback_leaves(pcfg) == ("pos",)
    assert api.ring_leaves(pcfg) == ()
