"""Training the ssm, hybrid, encdec and vlm families on a mesh: the port's
sharded train step against the JAX package's unsharded loss, gradients
and AdamW, on the CPU.

One gloo world of 4 ranks (``launch.mesh.run_ranks``; the rank side is
``tests/torch_mesh_ranks.py``) runs every case, on (data 2, model 2)
and (pod 2, model 2), in one module-scoped fixture. Configs are
``tests/helpers.py``'s tiny fp32 ones with a vocabulary of 260 (which
'model' cuts):

* ``ssm``: 8 SSD heads, cut over 'model' (4 a rank: the conv's
  [xc block | B | C] layout, B and C whole on every rank), remat per
  layer;
* ``ssm_whole``: 3 SSD heads (``ssm_expand`` 3, head dim 64), which do
  not divide 'model': the mixer whole on every rank;
* ``hybrid``: 5 SSD layers in groups of 2 (two applications of the
  shared block, whose gradient sums over them, and a trailing SSD
  layer), the shared block with qk-norm and one KV head (q gathered
  over 'model', K/V whole: their gradients partial on each rank),
  remat per block;
* ``encdec``: frames (B, 8, D) cut over the batch axes with the tokens,
  2 KV heads (cut); ``encdec_kv1`` one KV head (the self- and
  cross-attention's K/V whole, read by this rank's q heads), remat;
* ``vlm``: an image of 4 positions (B, 4, D) before the text, cut with
  the tokens; the loss over the text positions.

Weights come from ``repro.models.schema.init_params`` through
``from_jax``; tokens and conditioning from a numpy seed. The reference
is ``jax.value_and_grad(loss_fn)`` and ``adamw_update`` unsharded,
composed as ``repro.train.train_loop`` does. Held, for every family on
both meshes: the loss within 1e-5 relative; every leaf's gradient block
on every rank within 1e-4 x that leaf's max |g| (``in_B``, ``in_C``,
conv_w's cut and whole channels and the shared block's leaves named on
their own); three steps' ``grad_norm`` within 1e-5 relative, losses
within 1e-4 and parameters within 1e-6; two runs of the sharded steps
give the same bits.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from helpers import tiny  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from torch_mesh_ranks import flat, rank_block  # noqa: E402

B, S = 8, 12
# Adam's eps 1e-5, as tests/test_torch_train_mesh.py has it: a gradient
# near the default eps would move its weight by up to 2 lr either way
OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=6, eps=1e-5)
CFGS = {
    "ssm": tiny("ssm", vocab_pad_multiple=4, remat=True),
    "ssm_whole": tiny("ssm", vocab_pad_multiple=4, ssm_expand=3,
                      ssm_headdim=64),
    "hybrid": tiny("hybrid", vocab_pad_multiple=4, n_layers=5,
                   hybrid_ssm_per_block=2, qk_norm=True, n_kv_heads=1,
                   remat=True),
    "encdec": tiny("encdec", vocab_pad_multiple=4),
    "encdec_kv1": tiny("encdec", vocab_pad_multiple=4, n_kv_heads=1,
                       remat=True),
    "vlm": tiny("vlm", vocab_pad_multiple=4),
}
MESHES = {"dp": ((2, 2), ("data", "model")),
          "pod": ((2, 2), ("pod", "model"))}
STEPS = 3


@partial(jax.jit, static_argnums=(1,))
def _jax_vg(params, cfg, batch):
    return jax.value_and_grad(japi.loss_fn)(params, cfg, batch,
                                            attn_impl="masked")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed=3) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    rows = {"encdec": ("frames", cfg.max_source_len),
            "vlm": ("img_embeds", cfg.n_img_tokens)}.get(cfg.family)
    if rows:
        out[rows[0]] = rng.standard_normal(
            (B, rows[1], cfg.d_model)).astype(np.float32)
    return out


def _vg(params, cfg, batch):
    loss, g = _jax_vg(params, cfg, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    return float(loss), _np(g)


def _jax_steps(params, cfg, batch, n):
    """n JAX steps, each on the tokens rolled by its index: the losses,
    grad norms and final parameters."""
    oc = jopt.AdamWConfig(**OPT)
    state = jopt.init_opt_state(params, oc)
    losses, norms = [], []
    for s in range(n):
        loss, g = _vg(params, cfg, dict(
            batch, tokens=np.roll(batch["tokens"], s, axis=1)))
        params, state, gn = jopt.adamw_update(params, g, state, oc)
        losses.append(loss)
        norms.append(float(gn))
    return losses, norms, _np(params)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every family's JAX reference, and every rank's port output on
    both meshes (one world of 4)."""
    ref, cases, fields = {}, {}, {}
    for name, cfg in CFGS.items():
        params = _np(jschema.init_params(cfg, jax.random.PRNGKey(0)))
        batch = _batch(cfg)
        ref[name] = {"vg": _vg(params, cfg, batch),
                     "steps": _jax_steps(params, cfg, batch, STEPS)}
        fields[name] = dataclasses.asdict(cfg)
        for tag, (shape, axes) in MESHES.items():
            cases[f"vg/{name}/{tag}"] = (shape, axes, fields[name], params,
                                         batch, "vg", {})
            cases[f"steps/{name}/{tag}"] = (shape, axes, fields[name],
                                            params, batch, "step",
                                            {"opt": OPT, "steps": STEPS})
    from torch_mesh_ranks import train_world
    tmp = tmp_path_factory.mktemp("train_mesh_families")
    got = run_ranks(train_world, MESHES["dp"][0], MESHES["dp"][1],
                    backend="gloo", device="cpu", args=(cases,),
                    store_dir=tmp, timeout=600)
    return ref, got, fields


def _per_rank(worlds, kind, name, mesh):
    """(rank, its output, the reference cut to its blocks) for every
    rank of a case."""
    _, got, fields = worlds
    shape, axes = MESHES[mesh]
    for r in got[f"{kind}/{name}/{mesh}"]:
        yield r["rank"], r["out"], partial(
            rank_block, fields=fields[name], shape=shape, axes=axes,
            rank=r["rank"])


def _held(got_tree, want_tree, what):
    g, w = flat(got_tree), flat(want_tree)
    assert sorted(g) == sorted(w), what
    for path in w:
        scale = np.abs(w[path]).max()
        assert scale > 0, (what, path)
        np.testing.assert_allclose(g[path], w[path], rtol=0,
                                   atol=1e-4 * scale,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CFGS))
def test_every_rank_gradient_block_matches_jax(worlds, name, mesh):
    want_loss, want_g = worlds[0][name]["vg"]
    for rank, out, cut in _per_rank(worlds, "vg", name, mesh):
        np.testing.assert_allclose(out["loss"], want_loss, rtol=1e-5,
                                   err_msg=f"{name} {mesh} rank {rank}")
        _held(out["grads"], cut(want_g), f"{name} {mesh} rank {rank}")


#: the leaves a rank holds partly cut, partly whole, or whole but fed
#: to what differs along 'model', held on their own (the message names
#: each): mamba2's B and C path, and hybrid's shared block
SPLIT = {"ssm": ("layers/in_B", "layers/in_C", "layers/conv_w"),
         "hybrid": ("layers/in_B", "layers/in_C", "layers/conv_w",
                    "shared_attn/wq", "shared_attn/wk", "shared_attn/wv",
                    "shared_attn/q_norm", "shared_attn/k_norm",
                    "shared_attn/wo", "shared_attn/ln1")}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(SPLIT))
def test_split_leaves_match_jax(worlds, name, mesh):
    """conv_w's B and C channels (whole on every rank) and its xc block,
    in_B and in_C (whose cotangent every rank holds a part of before the
    backward's sum over 'model'), and the shared block's leaves (its
    gradient summed over its applications, K/V partial over 'model')."""
    cfg = CFGS[name]
    bc = 2 * cfg.ssm_state
    _, want_g = worlds[0][name]["vg"]
    for rank, out, cut in _per_rank(worlds, "vg", name, mesh):
        got, want = flat(out["grads"]), flat(cut(want_g))
        for path in SPLIT[name]:
            parts = {path: slice(None)}
            if path.endswith("conv_w"):
                parts = {f"{path} xc block": slice(None, -bc),
                         f"{path} B and C": slice(-bc, None)}
            for what, sl in parts.items():
                g, w = got[path][..., sl], want[path][..., sl]
                scale = np.abs(w).max()
                assert scale > 0, what
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=1e-4 * scale,
                    err_msg=f"{name} {mesh} rank {rank}: {what}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CFGS))
def test_three_steps_match_jax(worlds, name, mesh):
    losses, norms, params = worlds[0][name]["steps"]
    for rank, out, cut in _per_rank(worlds, "steps", name, mesh):
        what = f"{name} {mesh} rank {rank}"
        np.testing.assert_allclose(out["norms"], norms, rtol=1e-5,
                                   err_msg=f"{what} grad_norm")
        np.testing.assert_allclose(out["losses"], losses, rtol=0,
                                   atol=1e-4, err_msg=what)
        want = flat(cut(params))
        for path, x in flat(out["params"]).items():
            np.testing.assert_allclose(x, want[path], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{what} {path}")
        assert out["bitwise_repeat"], f"{what}: two runs differ"
