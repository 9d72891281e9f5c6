"""The port's dense model against the JAX package's, on the same weights.

``from_jax`` converts ``repro.models.schema.init_params`` trees for
``pred-tiny`` and a tiny qwen3 variant (qk-norm, GQA). Then 16 decode
steps with ragged per-lane positions run through
``repro.models.transformer.decode_step`` and the port's; logits agree to
atol/rtol 1e-4 in fp32 (XLA on the CPU and PyTorch multiply in other
orders). Inside the port a reset lane must equal a fresh cache bit for
bit.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import paper_predictors as jpp  # noqa: E402
from repro.configs import qwen3_1_7b as jqwen  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.configs import paper_predictors as ppp  # noqa: E402
from repro_torch.configs import qwen3_1_7b as pqwen  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import api, schema, transformer  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402

CFGS = {
    "pred-tiny": (jpp.PRED_TINY, ppp.PRED_TINY),
    "qwen3-tiny": (jbase.tiny_variant(jqwen.CONFIG),
                   pbase.tiny_variant(pqwen.CONFIG)),
}


def _pair(name):
    jcfg, pcfg = CFGS[name]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def _jax_params_np(jcfg, seed=0):
    params = jschema.init_params(jcfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_decode_steps_match_jax(name):
    jcfg, pcfg = _pair(name)
    pnp = _jax_params_np(jcfg)
    params = schema.from_jax(pnp)
    B, S, steps = 4, 32, 16
    start = np.array([0, 3, 7, 1], np.int32)          # ragged lanes
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (steps, B)).astype(np.int32)
    jcache = jtf.init_cache(jcfg, B, S)
    jcache["pos"] = jnp.asarray(start)
    pcache = transformer.init_cache(pcfg, B, S)
    pcache["pos"] = torch.from_numpy(start.copy())
    jstep = jax.jit(partial(jtf.decode_step, cfg=jcfg))
    for t in range(steps):
        jl, jcache = jstep(pnp, cache=jcache, prev_tokens=jnp.asarray(
            toks[t]))
        pl, pcache = transformer.decode_step(params, pcfg, pcache,
                                             torch.from_numpy(toks[t]))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    assert np.array_equal(pcache["pos"].numpy(), np.asarray(jcache["pos"]))
    np.testing.assert_allclose(pcache["k"].numpy(),
                               np.asarray(jcache["k"]), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_from_jax_keeps_names_layouts_and_dtypes(name):
    jcfg, pcfg = _pair(name)
    pnp = _jax_params_np(jcfg)
    params = schema.from_jax(pnp)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(pnp)[0])
    assert len(flat_j) == len(list(schema._leaves_sorted(
        schema.schema(pcfg))))
    for path, leaf in schema._leaves_sorted(schema.schema(pcfg)):
        t = params
        a = pnp
        for key in path:
            t, a = t[key], a[key]
        assert tuple(t.shape) == leaf.shape == a.shape
        assert np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_init_params_matches_schema_shapes_and_scales(name):
    jcfg, pcfg = _pair(name)
    params = schema.init_params(pcfg, seed=3)
    jabs = jschema.abstract_params(jcfg)
    flat = dict(jax.tree_util.tree_flatten_with_path(jabs)[0])
    for path, leaf in schema._leaves_sorted(schema.schema(pcfg)):
        t = params
        for key in path:
            t = t[key]
        jp = tuple(jax.tree_util.DictKey(k) for k in path)
        assert tuple(t.shape) == flat[jp].shape
        assert t.dtype == transformer.torch_dtype(pcfg.dtype)
        if leaf.init == "ones":
            assert bool((t == 1).all())
        elif t.numel() > 1000:
            assert float(t.float().std()) == pytest.approx(leaf.scale,
                                                           rel=0.1)
    again = schema.init_params(pcfg, seed=3)
    assert torch.equal(again["layers"]["wq"], params["layers"]["wq"])
    assert schema.count_params(pcfg) == jschema.count_params(jcfg)


def test_reset_lane_equals_fresh_cache_bitwise():
    cfg = ppp.PRED_TINY
    pred = ModelPredictor.random_init(cfg, seed=5, device="cpu")
    pred.set_decode_len(24)
    rng = np.random.default_rng(2)
    B = 3
    state = pred.begin_decode(B)
    for _ in range(7):
        _, state = pred.decode_step(state, rng.integers(0, 256, B))
    mask = np.array([False, True, False])
    state = pred.reset_slots(state, mask)
    assert state["pos"].tolist()[1] == 0
    fresh = pred.begin_decode(B)
    seq = rng.integers(0, 256, (5, B))
    for t in range(5):
        la, state = pred.decode_step(state, seq[t])
        lb, fresh = pred.decode_step(fresh, seq[t])
        assert torch.equal(la[1], lb[1])
        assert not torch.equal(la[0], lb[0])


def test_prefix_prefill_equals_sequential_steps():
    cfg = ppp.PRED_TINY
    pred = ModelPredictor.random_init(cfg, seed=6, device="cpu")
    pred.set_decode_len(16)
    prefix = np.array([[5, 9, 11, 2], [7, 7, 1, 0]], np.int32)
    st = pred.begin_decode(2, prefix=prefix)
    la, _ = pred.decode_step(st, prefix[:, -1])
    seq = pred.begin_decode(2)
    prev = np.full(2, pred.bos_id)
    for t in range(prefix.shape[1]):
        _, seq = pred.decode_step(seq, prev)
        prev = prefix[:, t]
    lb, _ = pred.decode_step(seq, prev)
    assert torch.equal(la, lb)


def test_padded_vocab_is_masked_and_sliced():
    cfg = pbase.tiny_variant(pqwen.CONFIG, vocab_size=250,
                             vocab_pad_multiple=64)
    assert cfg.padded_vocab == 256
    params = schema.init_params(cfg, seed=0)
    cache = api.init_cache(cfg, 2, 8)
    logits, _ = api.decode_step(params, cfg, cache, torch.tensor([1, 2]))
    assert logits.shape == (2, 256)
    assert bool((logits[:, 250:] == transformer.NEG_INF).all())
    pred = ModelPredictor(params, cfg, device="cpu")
    lg, _ = pred.decode_step(pred.begin_decode(2), np.array([1, 2]))
    assert lg.shape == (2, 250)


def test_registry_resolves_predictors_and_configs():
    assert get_config("pred-base") is ppp.PRED_BASE
    assert get_config("qwen3-1.7b") == pqwen.CONFIG
    assert get_config("qwen3_1_7b").vocab_size == 151936
    with pytest.raises(KeyError):
        get_config("no-such-model")
