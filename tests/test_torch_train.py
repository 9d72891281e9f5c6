"""The port's training path against the JAX package's, on the CPU.

Weights come from ``repro.models.schema.init_params`` through the port's
``from_jax``; token batches from a numpy seed. Two configs: ``pred-tiny``
and the tiny qwen3-1.7b (``SMOKE_CONFIG``: qk-norm, GQA). Held:

* ``loss_fn`` within rtol 1e-5 of JAX's, with ``loss_block`` 0 and 8;
* every leaf's gradient within 1e-4 x that leaf's max |g| of ``jax.grad``,
  every leaf nonzero (with per-layer remat too);
* ``lr_at`` at step 0, the end of warmup, mid-way and the end;
* ``adamw_update`` (with and without clipping and ``grad_compress``) on
  the SAME gradients, converted from JAX: Adam's first step is about
  lr * sign(g), so a near-zero gradient whose sign differs between the
  two autograds would move a parameter by 2 lr and hide what is compared;
* three composed train steps (loss within 1e-4), and two microbatches
  against the mean of two ``value_and_grad`` calls;
* ``TokenPipeline`` batches byte for byte over 5 steps and after
  ``reassign``; the checkpoint round trip (bf16 bit for bit), a corrupt
  newest step skipped, ``keep`` retention, a checkpoint of another
  structure refused, no ``msgpack``;
* ``entropy.analyze`` equal to JAX's on three texts;
* every kernel wrapper refusing a gradient-carrying input in grad mode.

The reference side composes ``jax.value_and_grad(loss_fn)`` and
``adamw_update`` exactly as ``repro.train.train_loop`` does, rather than
calling ``make_train_step``: that fails here without a mesh
(``sharding/specs.py:26`` reads ``mesh.axis_names``) and with one
(``with_sharding_constraint`` refuses the mesh's axes under the installed
jax).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_predictors as jpp  # noqa: E402
from repro.configs import qwen3_1_7b as jqwen  # noqa: E402
from repro.core import entropy as jentropy  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data.synthetic import human_like, human_like_ood  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import paper_predictors as ppp  # noqa: E402
from repro_torch.configs import qwen3_1_7b as pqwen  # noqa: E402
from repro_torch.core import entropy as pentropy  # noqa: E402
from repro_torch.data import pipeline as ppipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api as papi  # noqa: E402
from repro_torch.models import schema as pschema  # noqa: E402
from repro_torch.train import checkpoint as pckpt  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402
from repro_torch.train import train_loop as ploop  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFGS = {
    "pred-tiny": (jpp.PRED_TINY, ppp.PRED_TINY),
    "qwen3-tiny": (jqwen.SMOKE_CONFIG, pqwen.SMOKE_CONFIG),
}
OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=6)


def _setup(name, B=4, S=24, seed=0):
    jcfg, pcfg = CFGS[name]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    jp = jax.tree_util.tree_map(
        np.asarray, jschema.init_params(jcfg, jax.random.PRNGKey(seed)))
    toks = np.random.default_rng(seed + 1).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, pcfg, jp, toks


def _np(tree):
    return popt.tree_map(lambda t: t.detach().numpy(), tree)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@partial(jax.jit, static_argnums=(1, 3))
def _jax_vg(params, cfg, tokens, loss_block=0):
    return jax.value_and_grad(japi.loss_fn)(
        params, cfg, {"tokens": tokens}, attn_impl="masked",
        loss_block=loss_block)


@pytest.mark.parametrize("loss_block", [0, 8])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_loss_matches_jax(name, loss_block):
    jcfg, pcfg, jp, toks = _setup(name)
    jl, _ = _jax_vg(jp, jcfg, jnp.asarray(toks), loss_block)
    with torch.no_grad():
        pl = papi.loss_fn(pschema.from_jax(jp), pcfg,
                          {"tokens": torch.from_numpy(toks).long()},
                          loss_block=loss_block)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_grads_match_jax(name, remat):
    jcfg, pcfg, jp, toks = _setup(name)
    pcfg = pcfg.with_(remat=remat)
    jl, jg = _jax_vg(jp, jcfg, jnp.asarray(toks))
    pl, pg = ploop.value_and_grad(pschema.from_jax(jp), pcfg,
                                  {"tokens": toks})
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    jg, pg = _flat(jax.tree_util.tree_map(np.asarray, jg)), _flat(_np(pg))
    assert sorted(jg) == sorted(pg)
    for path in jg:
        scale = np.abs(jg[path]).max()
        assert scale > 0 and np.abs(pg[path]).max() > 0, path
        np.testing.assert_allclose(pg[path], jg[path], rtol=0,
                                   atol=1e-4 * scale, err_msg=path)


def test_lr_schedule_matches_jax():
    jc, pc = jopt.AdamWConfig(**OPT), popt.AdamWConfig(**OPT)
    for step in (0, OPT["warmup_steps"], 4, OPT["total_steps"]):
        np.testing.assert_allclose(
            float(popt.lr_at(pc, step)),
            float(jopt.lr_at(jc, jnp.asarray(step, jnp.int32))), rtol=1e-6)


# grad_compress is held without clipping: the clip scale divides by the
# global norm, whose float sum runs in another order in each package, and
# an int8 code whose input sits on a rounding tie may then flip. The
# quantizer itself is held bit for bit below.
@pytest.mark.parametrize("clip,compress", [(1.0, False), (1e-3, False),
                                           (None, False), (None, True)])
def test_adamw_on_identical_gradients_matches_jax(clip, compress):
    jcfg, pcfg, jp, toks = _setup("qwen3-tiny")
    _, jg = _jax_vg(jp, jcfg, jnp.asarray(toks))
    jg = jax.tree_util.tree_map(np.asarray, jg)
    kw = dict(OPT, clip_norm=clip, grad_compress=compress)
    jc, pc = jopt.AdamWConfig(**kw), popt.AdamWConfig(**kw)
    jparams, jstate = jp, jopt.init_opt_state(jp, jc)
    pparams = pschema.from_jax(jp)
    pstate = popt.init_opt_state(pparams, pc)
    for _ in range(2):          # the bias corrections at steps 1 and 2
        jparams, jstate, jn = jopt.adamw_update(jparams, jg, jstate, jc)
        pparams, pstate, pn = popt.adamw_update(
            pparams, pschema.from_jax(jg), pstate, pc)
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-5)
    assert int(pstate["step"]) == int(jstate["step"]) == 2
    for what, j, p in [("params", jparams, pparams),
                       ("m", jstate["m"], pstate["m"]),
                       ("v", jstate["v"], pstate["v"])] + (
            [("err", jstate["err"], pstate["err"])] if compress else []):
        j = _flat(jax.tree_util.tree_map(np.asarray, j))
        p = _flat(_np(p))
        for path in j:
            np.testing.assert_allclose(p[path], j[path], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{what} {path}")


def test_grad_compress_matches_jax_bit_for_bit():
    from repro.train import grad_compress as jgc
    from repro_torch.train import grad_compress as pgc
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(size=(64, 32)).astype(np.float32) * 1e-3,
         "b": {"c": rng.normal(size=(300,)).astype(np.float32)}}
    jerr = jax.tree_util.tree_map(np.zeros_like, g)
    perr = popt.tree_map(torch.from_numpy, jerr)
    for _ in range(3):          # error feedback carried across rounds
        jdeq, jerr = jgc.compress_decompress(g, jerr)
        pdeq, perr = pgc.compress_decompress(
            popt.tree_map(torch.from_numpy, g), perr)
        for j, p in ((jdeq, pdeq), (jerr, perr)):
            for path, x in _flat(jax.tree_util.tree_map(np.asarray,
                                                        j)).items():
                np.testing.assert_array_equal(_flat(_np(p))[path], x)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_three_train_steps_match_jax(name):
    jcfg, pcfg, jp, toks = _setup(name)
    jc, pc = jopt.AdamWConfig(**OPT), popt.AdamWConfig(**OPT)
    jparams, jstate = jp, jopt.init_opt_state(jp, jc)
    pparams = pschema.from_jax(jp)
    pstate = popt.init_opt_state(pparams, pc)
    step = ploop.make_train_step(pcfg, opt=pc)
    for s in range(3):
        batch = np.roll(toks, s, axis=1)
        jl, jg = _jax_vg(jparams, jcfg, jnp.asarray(batch))
        jparams, jstate, _ = jopt.adamw_update(jparams, jg, jstate, jc)
        pparams, pstate, m = step(pparams, pstate, {"tokens": batch})
        assert abs(float(m["loss"]) - float(jl)) < 1e-4, (s, m, jl)
        assert int(m["step"]) == s + 1


def test_microbatches_average_two_value_and_grad_calls():
    jcfg, pcfg, jp, toks = _setup("pred-tiny", B=4)
    pc = popt.AdamWConfig(**OPT)
    params = pschema.from_jax(jp)
    state = popt.init_opt_state(params, pc)
    new, _, m = ploop.make_train_step(pcfg, opt=pc, num_microbatches=2)(
        params, state, {"tokens": toks})
    halves = [toks[:2], toks[2:]]
    jls = [float(_jax_vg(jp, jcfg, jnp.asarray(h))[0]) for h in halves]
    np.testing.assert_allclose(float(m["loss"]), np.mean(jls), rtol=1e-5)
    parts = [ploop.value_and_grad(params, pcfg, {"tokens": h})[1]
             for h in halves]
    mean = popt.tree_map(lambda a, b: (a.float() + b.float()) / 2, *parts)
    want, _, gn = popt.adamw_update(params, mean, state, pc)
    np.testing.assert_allclose(float(m["grad_norm"]), float(gn), rtol=1e-6)
    for path, w in _flat(_np(want)).items():
        np.testing.assert_allclose(_flat(_np(new))[path], w, rtol=0,
                                   atol=1e-6, err_msg=path)
    with pytest.raises(ValueError):
        ploop.make_train_step(pcfg, opt=pc, num_microbatches=3)(
            params, state, {"tokens": toks})
    # what the port does not train on a mesh yet is refused there:
    # experts that do not divide 'model' (every family trains on one)
    from repro_torch.configs import granite_moe_1b_a400m, mamba2_130m
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((1, 2), ("data", "model"), rank=0)
    ploop.make_train_step(mamba2_130m.SMOKE_CONFIG, mesh)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ploop.make_train_step(granite_moe_1b_a400m.SMOKE_CONFIG.with_(
            n_experts=3), mesh)


def test_token_pipeline_batches_equal_jax():
    toks = np.random.default_rng(3).integers(0, 258, 5000).astype(np.int32)
    kw = dict(global_batch=8, seq_len=48, n_hosts=4, host_id=1, seed=5)
    j, p = jpipeline.TokenPipeline(toks, **kw), \
        ppipeline.TokenPipeline(toks, **kw)
    for step in range(5):
        for a, b in ((j.global_batch_array(step), p.global_batch_array(step)),
                     (j.host_batch(), p.host_batch())):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        j.advance()
        p.advance()
    j.reassign([2, 3])
    p.reassign([2, 3])
    assert p.state.to_dict() == j.state.to_dict()
    assert p.host_batch().tobytes() == j.host_batch().tobytes()
    st = ppipeline.PipelineState.from_dict(p.state.to_dict())
    assert st == p.state


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {
        "w": torch.randn(3, 5, generator=g),
        "h": torch.randn(4, 2, generator=g).to(torch.bfloat16),
        "layers": {"i": torch.arange(6, dtype=torch.int32).reshape(2, 3)}},
        "losses": np.linspace(1, 2, 7, dtype=np.float32)}


def _leaves_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = torch.as_tensor(fa[k]), torch.as_tensor(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.view(torch.uint8).equal(y.view(torch.uint8)), k


def test_checkpoint_round_trip_bit_exact(tmp_path):
    tree = _tree()
    path = pckpt.save_checkpoint(tmp_path, 7, tree)
    assert path.name == "step-00000007"
    assert (tmp_path / "latest").read_text() == path.name
    manifest = json.loads((path / "manifest.json").read_text())
    assert {e["name"]: e["dtype"] for e in manifest["arrays"]}[
        "params.h"] == "bfloat16"
    back, step = pckpt.restore_latest(tmp_path, tree)
    assert step == 7
    _leaves_equal(back, tree)


def test_checkpoint_skips_corrupt_newest_and_keeps_the_newest(tmp_path):
    tree = _tree()
    saved = {}
    for s in (1, 2, 3, 4):
        tree["params"]["w"] = tree["params"]["w"] + 1
        saved[s] = tree["params"]["w"]
        pckpt.save_checkpoint(tmp_path, s, tree, keep=2)
    assert sorted(p.name for p in tmp_path.glob("step-*")) == [
        "step-00000003", "step-00000004"]
    newest = tmp_path / "step-00000004" / "arrays.npz"
    raw = bytearray(newest.read_bytes())
    raw[len(raw) // 2] ^= 0xFF                      # a flipped byte
    newest.write_bytes(bytes(raw))
    back, step = pckpt.restore_latest(tmp_path, tree)
    assert step == 3
    assert back["params"]["w"].equal(saved[3])
    (tmp_path / "step-00000003" / "manifest.json").write_text("{")
    assert pckpt.restore_latest(tmp_path, tree) == (None, -1)
    assert pckpt.restore_latest(tmp_path / "none", tree) == (None, -1)


def test_checkpoint_of_another_structure_raises(tmp_path):
    """A sound checkpoint that does not fit the state restored into it
    raises and is not taken for an absent one: a run saved without
    ``grad_compress`` and restarted with it (``opt.err``)."""
    from repro_torch.train import optimizer as popt
    params = {"w": torch.ones(3, 5), "h": torch.zeros(4, 2)}
    plain = {"params": params,
             "opt": popt.init_opt_state(params, popt.AdamWConfig())}
    pckpt.save_checkpoint(tmp_path, 5, plain)
    compress = {"params": params, "opt": popt.init_opt_state(
        params, popt.AdamWConfig(grad_compress=True))}
    with pytest.raises(KeyError, match="opt.err"):
        pckpt.restore_latest(tmp_path, compress)
    back, step = pckpt.restore_latest(tmp_path, plain)
    assert step == 5
    _leaves_equal(back["params"], params)


def test_checkpoint_needs_no_msgpack(tmp_path):
    code = ("import sys, torch\n"
            "from repro_torch.train import checkpoint as c\n"
            "t = {'a': torch.ones(2, dtype=torch.bfloat16)}\n"
            "c.save_checkpoint(sys.argv[1], 1, t)\n"
            "back, s = c.restore_latest(sys.argv[1], t)\n"
            "assert s == 1 and back['a'].equal(t['a'])\n"
            "assert 'msgpack' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# texts made inside the test: human_like seeds with hash(domain), which
# differs between processes, and test ids must be the same in every
# worker that collects them
TEXTS = {"wiki": lambda: human_like("wiki", 3000, seed=1).decode(),
         "novel-ood": lambda: human_like_ood("novel", 3000,
                                             seed=2).decode(),
         "repeats": lambda: "a b c a b c d e f " * 40 + "once upon a time"}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_entropy_analysis_equals_jax(name):
    text = TEXTS[name]()
    assert pentropy.analyze(text) == jentropy.analyze(text)


def _kernel_calls():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    lens = torch.tensor([3, 5], dtype=torch.int32)
    k8 = torch.randint(-127, 128, (2, 5, 2, 8), generator=g,
                       dtype=torch.int8)
    return {
        "decode_attention": (lambda q, k, v: ops.decode_attention(
            q, k, v, lens), (r(2, 4, 8), r(2, 5, 2, 8), r(2, 5, 2, 8))),
        # the int8 rows cannot carry a gradient; q and the scales can
        "decode_attention_int8": (
            lambda q, ks, vs: ops.decode_attention_int8(q, k8, k8, ks, vs,
                                                        lens),
            (r(2, 4, 8), r(2, 5, 2).abs().half(), r(2, 5, 2).abs().half())),
        "decode_attention_partial": (
            lambda q, k, v: ops.decode_attention_partial(q, k, v, lens),
            (r(2, 4, 8), r(2, 5, 2, 8), r(2, 5, 2, 8))),
        "decode_attention_partial_int8": (
            lambda q, ks, vs: ops.decode_attention_partial_int8(
                q, k8, k8, ks, vs, lens),
            (r(2, 4, 8), r(2, 5, 2).abs().half(), r(2, 5, 2).abs().half())),
        "topk_cdf": (lambda x: ops.topk_cdf(x, 4, 16), (r(2, 40),)),
        "cdf_points": (lambda x: ops.cdf_points(x, 16), (r(2, 40),)),
        "flash_attention": (lambda q, k, v: ops.flash_attention(q, k, v),
                            (r(1, 4, 6, 8), r(1, 2, 6, 8), r(1, 2, 6, 8))),
        "ssd_intra": (lambda x, dt, A, B, C: ops.ssd_intra(x, dt, A, B, C),
                      (r(1, 4, 2, 3), r(1, 4, 2).abs(), -r(2).abs(),
                       r(1, 4, 5), r(1, 4, 5))),
    }


@pytest.mark.parametrize("name", sorted(ops.LAUNCHES))
def test_kernel_wrappers_refuse_gradient_inputs(name):
    fn, args = _kernel_calls()[name]
    fn(*args)                                   # no gradient: runs
    for i in range(len(args)):
        grad_args = [a.clone().requires_grad_(j == i)
                     for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*grad_args)
        with torch.no_grad():
            fn(*grad_args)                      # grad mode off: runs
