"""The dense decode cache's two variants, and the three dense configs that
came with them, against the JAX package on the CPU.

* ``kv_cache_dtype="int8"``: K/V quantized on write (``_quant_kv``, one
  fp16 scale per lane, position and kv-head), dequantized as the int8
  decode-attention kernel reads them. Port decode logits within
  atol/rtol 2**-8 of JAX's int8 decode on the same weights
  (``from_jax``). XLA and PyTorch multiply in other orders (fp32 caches
  agree to 1e-4, as in ``test_torch_model.py``), and a last-bit
  difference of a K/V value can carry it across an int8 rounding
  boundary (one quantum: 1/127 of its row's largest |value|) or its
  scale across an fp16 one (one ulp, 2**-10 relative); on these configs
  that moves a logit by up to 1.3e-3. So the int8 rows agree but for a
  few entries one quantum apart, the scales within one fp16 ulp.
* The sliding-window ring (window 16): over 40 positions, more than 2 W,
  the port's ring decode within 1e-4 of JAX's ``_ring_attention`` decode
  and of the port's own windowed teacher-forced ``forward``.
* ``h2o-danube-3-4b``, ``deepseek-7b`` and ``qwen3-14b``: the registry's
  widths, and tiny variants that keep each one's trait (JAX's
  ``tiny_variant`` would erase it): the window and a head width that is
  a multiple of 8 and not of 16; MHA; more heads than a multiple of the
  padding, with qk-norm. Forward and decode within 1e-4 of JAX's.
* The plain int8 attention equals dequantize-then-attend bit for bit,
  and its dequantized cache equals JAX's ``_dequant_kv(...).astype``.
* Inside the port, bit for bit: verify + rollback across the ring's wrap
  against lock-step, cache leaves included; speculative decompression
  (T = 5, drafts rejected) across the wrap against lock-step; a prefix-
  cache restore against a cold prefill; compress against decompress
  through the service.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import deepseek_7b as jdeep  # noqa: E402
from repro.configs import h2o_danube_3_4b as jh2o  # noqa: E402
from repro.configs import qwen3_14b as jq14  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.configs import deepseek_7b as pdeep  # noqa: E402
from repro_torch.configs import h2o_danube_3_4b as ph2o  # noqa: E402
from repro_torch.configs import qwen3_14b as pq14  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import LLMCompressor  # noqa: E402
from repro_torch.core.draft import ConstantDraft  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.tokenizer import encode  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import api, schema, transformer  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402

import torch_threads  # noqa: E402,F401  (caps torch's threads)

#: each config's tiny variant, overridden to keep its trait
TRAITS = {
    # the window, and hd 24: a multiple of 8, not of 16 (h2o's 120)
    "h2o-danube-3-4b": (jh2o.CONFIG, ph2o.CONFIG, dict(d_head=24)),
    # MHA: n_kv_heads == n_heads
    "deepseek-7b": (jdeep.CONFIG, pdeep.CONFIG, dict(n_kv_heads=4)),
    # 5 heads padded to 8 (qwen3-14b: 40 to 48), qk-norm, G = 4
    "qwen3-14b": (jq14.CONFIG, pq14.CONFIG,
                  dict(n_heads=5, n_kv_heads=2, head_pad_multiple=4)),
}
NAMES = sorted(TRAITS)
W = 16                                   # the tiny variants' window


def _pair(name, **kw):
    jc, pc, trait = TRAITS[name]
    jcfg = jbase.tiny_variant(jc, **trait, **kw)
    pcfg = pbase.tiny_variant(pc, **trait, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def _ring(**kw):
    return _pair("h2o-danube-3-4b", **kw)[1]


def _jax_params(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jschema.init_params(jcfg, jax.random.PRNGKey(seed)))


# ---------------------------------------------------------- the configs
@pytest.mark.parametrize("name", NAMES)
def test_registry_resolves_the_published_widths(name):
    jc, pc, _ = TRAITS[name]
    assert get_config(name) is pc
    assert get_config(name.replace("-", "_").replace(".", "_")) is pc
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    want = {"h2o-danube-3-4b": (32, 8, 120, 4096, 32000),
            "deepseek-7b": (32, 32, 128, None, 102400),
            "qwen3-14b": (48, 8, 128, None, 151936)}[name]
    assert (pc.padded_heads, pc.padded_kv_heads, pc.head_dim,
            pc.sliding_window, pc.vocab_size) == want


@pytest.mark.parametrize("name", NAMES)
def test_tiny_variants_keep_the_trait(name):
    cfg = _pair(name)[1]
    if name == "h2o-danube-3-4b":
        assert cfg.sliding_window == W
        assert cfg.head_dim % 8 == 0 and cfg.head_dim % 16
    elif name == "deepseek-7b":
        assert cfg.n_kv_heads == cfg.n_heads and cfg.q_per_kv == 1
    else:
        assert cfg.qk_norm and cfg.n_heads % cfg.head_pad_multiple
        assert cfg.padded_heads > cfg.n_heads and cfg.q_per_kv > 1


@pytest.mark.parametrize("name", NAMES)
def test_tiny_forward_matches_jax(name):
    """Teacher-forced logits over 40 tokens (past the window for h2o)."""
    jcfg, pcfg = _pair(name)
    pnp = _jax_params(jcfg)
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    want = jtf.forward(pnp, jcfg, {"tokens": jnp.asarray(toks)})
    got = api.forward(schema.from_jax(pnp), pcfg,
                      {"tokens": torch.from_numpy(toks.astype(np.int64))})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def _decode_both(jcfg, pcfg, B=3, S=64, steps=40, start=(0, 3, 7)):
    """``steps`` decode steps of both packages from ragged positions,
    logits held to 1e-4 (2**-8 with an int8 cache); both caches."""
    pnp = _jax_params(jcfg)
    params = schema.from_jax(pnp)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (steps, B)).astype(np.int32)
    jc = jtf.init_cache(jcfg, B, S)
    jc["pos"] = jnp.asarray(np.array(start, np.int32))
    pc = transformer.init_cache(pcfg, B, S)
    pc["pos"] = torch.tensor(start, dtype=torch.int32)
    jstep = jax.jit(partial(jtf.decode_step, cfg=jcfg))
    tol = 2 ** -8 if pcfg.kv_cache_dtype == "int8" else 1e-4
    for t in range(steps):
        jl, jc = jstep(pnp, cache=jc, prev_tokens=jnp.asarray(toks[t]))
        pl, pc = transformer.decode_step(params, pcfg, pc,
                                         torch.from_numpy(toks[t]))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=tol)
    return jc, pc


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_tiny_decode_matches_jax(name, kv):
    """40 steps from ragged positions 0, 3 and 7: h2o's ring of 16 slots
    wraps two to three times; the int8 cache holds JAX's int8 rows but for
    at most 1 in 500 entries one quantum apart, and scales within one
    fp16 ulp."""
    jcfg, pcfg = _pair(name, kv_cache_dtype=kv)
    jc, pc = _decode_both(jcfg, pcfg)
    assert pc.keys() == jc.keys()
    assert pc["k"].shape[2] == (W if pcfg.sliding_window else 64)
    assert np.array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    for k in ("k", "v"):
        if kv == "int8":
            assert pc[k].dtype == torch.int8
            d = np.abs(pc[k].numpy().astype(np.int32)
                       - np.asarray(jc[k]).astype(np.int32))
            assert d.max() <= 1 and d.mean() <= 1 / 500
            a = pc[f"{k}_scale"].numpy()
            b = np.asarray(jc[f"{k}_scale"])
            np.testing.assert_allclose(a, b, rtol=2 ** -10, atol=0)
        else:
            np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]),
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("max_len", [16, 64])
def test_ring_decode_matches_windowed_forward(max_len):
    """The ring (16 slots whether the cache asks for 16 or 64 positions)
    decoding 40 tokens gives the logits of the port's teacher-forced
    forward under the same window."""
    cfg = _ring()
    params = schema.init_params(cfg, seed=4)
    toks = np.random.default_rng(5).integers(0, 256, (2, 40))
    want = api.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    cache = api.init_cache(cfg, 2, max_len)
    assert cache["k"].shape[2] == W
    for t in range(toks.shape[1]):
        lg, cache = api.decode_step(params, cfg, cache,
                                    torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(lg.numpy(), want[:, t].numpy(),
                                   atol=1e-4, rtol=1e-4)


# ------------------------------------------------- int8 attention, plain
def test_quant_kv_matches_jax():
    x = np.random.default_rng(6).normal(size=(5, 3, 4, 24)).astype(
        np.float32)
    x[0, 0, 0] = 0.0                                  # an all-zero row
    x[1, 0, 0, :4] = [0.5, -0.5, 1.5, 127 / 254]      # halves: to even
    jq, js = jtf._quant_kv(jnp.asarray(x))
    pq, ps = transformer._quant_kv(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float16
    assert np.array_equal(pq.numpy(), np.asarray(jq))
    assert np.array_equal(ps.numpy(), np.asarray(js))
    assert np.array_equal(ref.dequant_kv(pq, ps, torch.float32).numpy(),
                          np.asarray(jtf._dequant_kv(jq, js)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_int8_attention_is_dequantize_then_attend(dtype):
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    g = torch.Generator().manual_seed(7)
    B, S, K, G, hd = 3, 20, 2, 4, 24
    kq, ks = transformer._quant_kv(torch.randn(B, S, K, hd, generator=g))
    vq, vs = transformer._quant_kv(torch.randn(B, S, K, hd, generator=g))
    q = torch.randn(B, K * G, hd, generator=g).to(dt)
    lens = torch.tensor([1, 13, 20], dtype=torch.int32)
    got = ops.decode_attention_int8(q, kq, vq, ks, vs, lens)
    k, v = ref.dequant_kv(kq, ks, dt), ref.dequant_kv(vq, vs, dt)
    assert torch.equal(got, ref.decode_attention(q, k, v, lens))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jk = np.asarray(jtf._dequant_kv(jnp.asarray(kq.numpy()), jnp.asarray(
        ks.numpy())).astype(jdt)).astype(np.float32)
    assert np.array_equal(k.float().numpy(), jk)
    assert ops.LAUNCHES["decode_attention_int8"] == 0   # the CPU: plain


def test_int8_and_ring_cache_leaves():
    cfg = _ring(kv_cache_dtype="int8")
    cache = api.init_cache(cfg, 3, 100)
    L, Kp, hd = cfg.n_layers, cfg.padded_kv_heads, cfg.head_dim
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "k": ((L, 3, W, Kp, hd), torch.int8),
        "v": ((L, 3, W, Kp, hd), torch.int8),
        "k_scale": ((L, 3, W, Kp), torch.float16),
        "v_scale": ((L, 3, W, Kp), torch.float16),
        "pos": ((3,), torch.int32)}
    assert api.ring_leaves(cfg) == ("k", "v", "k_scale", "v_scale")
    assert api.ring_leaves(_ring()) == ("k", "v")
    assert api.ring_leaves(_pair("deepseek-7b", kv_cache_dtype="int8")[1]) \
        == ()
    assert api.rollback_leaves(cfg) == ("pos",)


# ------------------------------------------- bit for bit inside the port
_PREDS = {}


def _pred(kv=None, ring=True) -> ModelPredictor:
    """Tiny predictors (random weights, seed 0): h2o's trait variant (a
    ring of 16) or deepseek's (a linear cache), bf16 cache or int8."""
    key = (kv, ring)
    if key not in _PREDS:
        cfg = _ring(kv_cache_dtype=kv) if ring else \
            _pair("deepseek-7b", kv_cache_dtype=kv)[1]
        _PREDS[key] = ModelPredictor.random_init(cfg, seed=0, device="cpu")
    return _PREDS[key]


def _steps(pred, state, toks):
    out = []
    for t in range(toks.shape[1]):
        lg, state = pred.decode_step(state, toks[:, t])
        out.append(lg.clone())
    return (torch.stack(out, 1) if out else None), state


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


@pytest.mark.parametrize("warm", [13, 30])
@pytest.mark.parametrize("kv", [None, "int8"])
def test_verify_rollback_across_the_wrap_equals_lockstep(kv, warm):
    """A verify round of 5 steps that crosses the wrap (warm 13: positions
    13-17 of a 16-slot ring) or runs wholly past it (warm 30); lanes keep
    0, 2 and 5 of its inputs, then decode on. Each lane's logits and its
    every cache leaf equal a lock-step cache's that took only the kept
    inputs, bit for bit: the rejected steps' slots hold the rows from
    before the round again."""
    pred = _pred(kv)
    pred.set_decode_len(64)
    B, T, acc = 3, 5, [0, 2, 5]
    warm_t, seq, after = _tokens((B, warm), 3), _tokens((B, T), 4), \
        _tokens((B, 6), 5)
    state = _steps(pred, pred.begin_decode(B), warm_t)[1]
    _, snaps = pred.verify_steps(state, seq)
    state = pred.rollback(snaps, np.array(acc))
    kept = {k: v.clone() for k, v in state.items()}
    got = _steps(pred, state, after)[0]
    for b, a in enumerate(acc):
        ref_state = _steps(pred, pred.begin_decode(B), warm_t)[1]
        ref_state = _steps(pred, ref_state, seq[:, :a])[1]
        for k, v in ref_state.items():
            lane = (lambda x: x[b]) if k == "pos" else (lambda x: x[:, b])
            assert torch.equal(lane(kept[k]), lane(v)), (b, k)
        want = _steps(pred, ref_state, after)[0]
        assert torch.equal(got[b], want[b]), b


def test_verify_refuses_more_steps_than_ring_slots():
    pred = _pred()
    pred.set_decode_len(64)
    with pytest.raises(ValueError, match="ring of 16"):
        pred.verify_steps(pred.begin_decode(2), _tokens((2, W + 1), 6))


def _text(n, seed, domain="wiki"):
    return encode(synthetic.human_like(domain, n, seed=seed))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_speculative_decompress_across_the_wrap_equals_lockstep(kv):
    """Chunks of 48 through a ring of 16: every verify round after the
    first 12 positions overwrites slots still in the window. The
    speculative decoder (T = 5) with an always-wrong draft (BOS, which no
    text holds) takes a round at every position and rolls each one back
    to its first input; it must decode exactly what lock-step decodes."""
    pred = _pred(kv)
    toks = _text(200, seed=71)
    kw = dict(chunk_size=48, topk=8, decode_batch=4)
    blob, _ = LLMCompressor(pred, **kw).compress(toks)
    assert np.array_equal(LLMCompressor(pred, **kw).decompress(blob), toks)
    reg = obs.MetricsRegistry()
    spec = LLMCompressor(pred, draft_k=4, draft=ConstantDraft(pred.bos_id),
                         registry=reg, **kw)
    spec._spec_window = 1 << 30      # no fall-through to lock-step
    assert np.array_equal(spec.decompress(blob), toks)
    # a round per position of each group: 48 (chunks 0-3), 8 (chunk 4)
    assert reg.value("spec.rounds") == 48 + 8
    assert reg.value("spec.drafted_accepted") == 0


@pytest.mark.parametrize("kv,ring", [("int8", False), (None, True),
                                     ("int8", True)])
def test_prefix_cache_restore_equals_cold_prefill(kv, ring):
    """Shared-prefix jobs (a 20-token prefix: longer than the ring) through
    the service: later jobs restore the prefilled lane from the radix
    prefix cache, and write the bytes a cache-off run writes."""
    pred = _pred(kv, ring)
    sp = _text(20, seed=41)
    jobs = [_text(60, seed=50 + i) for i in range(3)]

    def run(cache_on):
        svc = CompressionService(pred, slots=2, chunk_size=24, topk=8,
                                 device="cpu")
        if not cache_on:
            svc.scheduler.prefix_cache = None
        hs = [svc.submit_compress(t, shared_prefix=sp) for t in jobs]
        return svc, [h.result()[0] for h in hs]

    svc_on, blobs_on = run(True)
    _, blobs_off = run(False)
    assert blobs_on == blobs_off
    assert svc_on.registry.value("prefix_cache.hits") >= 1
    for blob, toks in zip(blobs_on, jobs):
        assert np.array_equal(svc_on.submit_decompress(blob).result(), toks)


@pytest.mark.parametrize("kv,ring", [("int8", False), (None, True),
                                     ("int8", True)])
def test_service_round_trip(kv, ring):
    """Compress then decompress through the service, jobs submitted in
    another order (so chunks land on other lanes), chunks of 40 (the ring
    wraps in each): byte identity."""
    pred = _pred(kv, ring)
    jobs = [_text(n, seed=60 + n) for n in (90, 150, 40)]
    svc = CompressionService(pred, slots=3, chunk_size=40, topk=8,
                             device="cpu")
    blobs = [h.result()[0] for h in
             [svc.submit_compress(t) for t in jobs]]
    svc = CompressionService(pred, slots=3, chunk_size=40, topk=8,
                             device="cpu")
    outs = {i: svc.submit_decompress(blobs[i]) for i in (2, 0, 1)}
    for i, toks in enumerate(jobs):
        assert np.array_equal(outs[i].result(), toks)
