"""Training on a mesh: the port's sharded train step against the JAX
package's unsharded loss, gradients and AdamW, on the CPU.

The port runs in gloo worlds of ranks on the CPU
(``launch.mesh.run_ranks``; the rank side is ``tests/torch_mesh_ranks.py``):
one world of 4 (meshes (data 2, model 2) and (pod 2, model 2)) and one of
2 ((data 1, model 2)). Configs are ``tests/helpers.py``'s tiny fp32 ones
with a vocabulary of 260 (which 'model' cuts): dense with qk-norm and
per-layer remat, moe (4 experts, top 2). Weights come from
``repro.models.schema.init_params`` through ``from_jax``; tokens from a
numpy seed. The reference is ``jax.value_and_grad(loss_fn)`` and
``adamw_update`` unsharded, composed as ``repro.train.train_loop`` does
(JAX's own ``make_train_step`` raises here: ``tests/test_torch_train.py``).
Held, on both meshes of 4:

* the loss within 1e-5 relative, and EVERY leaf's gradient on EVERY rank
  equal to its block of JAX's within 1e-4 x that leaf's max |g|; with
  ``loss_block`` too;
* the train step's ``grad_norm`` within 1e-5 relative of JAX's
  ``global_norm``; its losses over 3 steps within 1e-4 and the
  parameters after them within 1e-6 (Adam's eps 1e-5: see ``OPT``);
  with 2 microbatches (the global batch sliced, each slice's rows of
  the rank kept, as JAX slices) one step against JAX's full-batch step;
  two runs of the sharded step give the same bits;
* ``grad_compress`` on identical gradients (JAX's, cut): the error
  state bit for bit blockwise against JAX's ``adamw_update`` (the global
  amax: every element gets JAX's int8 code), m, v and the parameters
  within rtol 1e-6;
* moe without drops (capacity factor E / k) against JAX's unsharded
  step; with drops (capacity factor 0.5) against the mean of JAX's
  ``value_and_grad`` over the batch shards' rows (capacity is per rank,
  as in JAX's ``shard_map``), and, the control, the sharded loss differs
  from the unsharded one; with drops and 2 microbatches, one step
  against JAX's step on the mean over the microbatches of the mean over
  each one's batch shards.

On (data 1, model 2): a tied embedding (the LM head's rows through
``collectives.split``) and one KV head (q gathered over 'model', K/V
whole: their gradients partial on each rank), and moe with drops, whose
batch is not cut, against JAX's unsharded gradients.
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
# eps 1e-5: Adam's first steps move a weight by about lr x the sign of its
# gradient, and the two sides sum in other orders, so a gradient near
# Adam's default eps (1e-8) could move its weight by 2 lr one way or the
# other and hide what is compared; with eps 1e-5 the update is smooth there
OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=6, eps=1e-5)
DENSE = tiny("dense", vocab_pad_multiple=4, qk_norm=True, remat=True)
MOE = tiny("moe", vocab_pad_multiple=4)
NODROP = dataclasses.replace(MOE, capacity_factor=MOE.n_experts / MOE.top_k)
DROP = dataclasses.replace(MOE, capacity_factor=0.5)
TIED = tiny("dense", vocab_pad_multiple=4, tie_embeddings=True,
            n_kv_heads=1)
MESHES = {"dp": ((2, 2), ("data", "model")),
          "pod": ((2, 2), ("pod", "model"))}
TP2 = ((1, 2), ("data", "model"))


@partial(jax.jit, static_argnums=(1, 3))
def _jax_vg(params, cfg, tokens, loss_block=0):
    return jax.value_and_grad(japi.loss_fn)(
        params, cfg, {"tokens": tokens}, attn_impl="masked",
        loss_block=loss_block)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _vg(params, cfg, tokens, loss_block=0):
    loss, g = _jax_vg(params, cfg, jnp.asarray(tokens), loss_block)
    return float(loss), _np(g)


def _params(cfg, seed=0):
    return _np(jschema.init_params(cfg, jax.random.PRNGKey(seed)))


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _sharded_vg(params, cfg, tokens, shards):
    """The loss and gradients of JAX's sharded moe step: the mean over
    the batch shards of ``value_and_grad`` on each shard's rows (each
    shard's capacity from its own tokens; every shard has the same
    number of positions)."""
    parts = [_vg(params, cfg, t) for t in np.split(tokens, shards)]
    return float(np.mean([p[0] for p in parts])), jax.tree_util.tree_map(
        lambda *g: sum(g) / len(g), *[p[1] for p in parts])


def _jax_steps(params, cfg, tokens, n, **opt):
    """n JAX steps (each on the tokens rolled by its index): the losses,
    grad norms and final parameters."""
    oc = jopt.AdamWConfig(**opt)
    state = jopt.init_opt_state(params, oc)
    losses, norms = [], []
    for s in range(n):
        loss, g = _vg(params, cfg, np.roll(tokens, s, axis=1))
        params, state, gn = jopt.adamw_update(params, g, state, oc)
        losses.append(loss)
        norms.append(float(gn))
    return losses, norms, _np(params)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case's JAX reference and every rank's port output."""
    toks = np.random.default_rng(3).integers(
        0, DENSE.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks}
    pd, pm, pt = _params(DENSE), _params(MOE), _params(TIED)
    ref = {}
    ref["vg"] = _vg(pd, DENSE, toks)
    ref["vg_lb"] = _vg(pd, DENSE, toks, 4)
    ref["steps"] = _jax_steps(pd, DENSE, toks, 3, **OPT)
    ref["mb"] = _jax_steps(pd, DENSE, toks, 1, **OPT)
    ref["nodrop"] = _vg(pm, NODROP, toks)
    halves = [_vg(pm, DROP, toks[:B // 2]), _vg(pm, DROP, toks[B // 2:])]
    ref["drop"] = (np.mean([h[0] for h in halves]), jax.tree_util.tree_map(
        lambda a, b: (a + b) / 2, halves[0][1], halves[1][1]))
    ref["drop_whole"] = _vg(pm, DROP, toks)
    # JAX's microbatches: the global batch's rows sliced, each slice cut
    # over the batch axes (2 shards on both meshes of 4)
    mbs = [_sharded_vg(pm, DROP, t, 2) for t in np.split(toks, 2)]
    oc = jopt.AdamWConfig(**OPT)
    mb_g = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, mbs[0][1],
                                  mbs[1][1])
    mb_p, _, mb_n = jopt.adamw_update(pm, mb_g,
                                      jopt.init_opt_state(pm, oc), oc)
    ref["mbdrop"] = ([float(np.mean([m[0] for m in mbs]))],
                     [float(mb_n)], _np(mb_p))
    gc_opt = dict(OPT, clip_norm=None, grad_compress=True)
    oc = jopt.AdamWConfig(**gc_opt)
    jparams, jstate, jg = pd, jopt.init_opt_state(pd, oc), ref["vg"][1]
    for _ in range(2):
        jparams, jstate, _ = jopt.adamw_update(jparams, jg, jstate, oc)
    ref["gc"] = _np({"params": jparams, "m": jstate["m"], "v": jstate["v"],
                     "err": jstate["err"]})
    ref["tied"] = _vg(pt, TIED, toks)
    ref["tp2_drop"] = _vg(pm, DROP, toks)

    d, m = _fields(DENSE), _fields(MOE)
    four = {}
    for tag, (shape, axes) in MESHES.items():
        four.update({
            f"vg_{tag}": (shape, axes, d, pd, batch, "vg", {}),
            f"vg_lb_{tag}": (shape, axes, d, pd, batch, "vg",
                             {"loss_block": 4}),
            f"steps_{tag}": (shape, axes, d, pd, batch, "step",
                             {"opt": OPT, "steps": 3}),
            f"mb_{tag}": (shape, axes, d, pd, batch, "step",
                          {"opt": OPT, "steps": 1, "microbatches": 2}),
            f"nodrop_{tag}": (shape, axes, _fields(NODROP), pm, batch,
                              "vg", {}),
            f"drop_{tag}": (shape, axes, _fields(DROP), pm, batch, "vg",
                            {}),
            f"mbdrop_{tag}": (shape, axes, _fields(DROP), pm, batch,
                              "step", {"opt": OPT, "steps": 1,
                                       "microbatches": 2}),
            f"gc_{tag}": (shape, axes, d, pd, batch, "adamw",
                          {"opt": gc_opt, "grads": ref["vg"][1]}),
        })
    tmp = tmp_path_factory.mktemp("train_mesh")
    from torch_mesh_ranks import train_world
    got = run_ranks(train_world, MESHES["dp"][0], MESHES["dp"][1],
                    backend="gloo", device="cpu", args=(four,),
                    store_dir=tmp, timeout=600)
    two = {"tied": (*TP2, _fields(TIED), pt, batch, "vg", {}),
           "tp2_drop": (*TP2, _fields(DROP), pm, batch, "vg", {})}
    got.update(run_ranks(train_world, *TP2, backend="gloo", device="cpu",
                         args=(two,), store_dir=tmp, timeout=600))
    fields = {"vg": d, "vg_lb": d, "steps": d, "mb": d, "gc": d,
              "nodrop": m, "drop": m, "mbdrop": m, "tied": _fields(TIED),
              "tp2_drop": m}
    return ref, got, fields


def _held(got_tree, want_tree, what):
    g, w = flat(got_tree), flat(want_tree)
    assert sorted(g) == sorted(w), what
    for path in w:
        scale = np.abs(w[path]).max()
        assert scale > 0, (what, path)
        np.testing.assert_allclose(g[path], w[path], rtol=0,
                                   atol=1e-4 * scale,
                                   err_msg=f"{what} {path}")


def _per_rank(worlds, case, ref_key):
    """(rank, its output, the reference cut to its blocks) for every
    rank of ``case``."""
    ref, got, fields = worlds
    tag = case.rsplit("_", 1)[-1]
    shape, axes = MESHES.get(tag, TP2)
    for r in got[case]:
        yield r["rank"], r["out"], partial(
            rank_block, fields=fields[ref_key], shape=shape, axes=axes,
            rank=r["rank"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", ["vg", "vg_lb", "nodrop", "drop"])
def test_every_rank_gradient_block_matches_jax(worlds, case, mesh):
    ref = worlds[0]
    want_loss, want_g = ref[case]
    for rank, out, cut in _per_rank(worlds, f"{case}_{mesh}", case):
        np.testing.assert_allclose(out["loss"], want_loss, rtol=1e-5,
                                   err_msg=f"rank {rank}")
        _held(out["grads"], cut(want_g), f"{case} {mesh} rank {rank}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_drops_are_per_batch_shard(worlds, mesh):
    """The control: with drops, the sharded loss is not the unsharded
    one (capacity is computed from each rank's own tokens)."""
    ref, got, _ = worlds
    whole = ref["drop_whole"][0]
    for r in got[f"drop_{mesh}"]:
        assert abs(r["out"]["loss"] - whole) > 1e-4 * abs(whole), \
            (r["out"]["loss"], whole)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_three_steps_match_jax(worlds, mesh):
    ref = worlds[0]
    losses, norms, params = ref["steps"]
    for rank, out, cut in _per_rank(worlds, f"steps_{mesh}", "steps"):
        np.testing.assert_allclose(out["norms"][0], norms[0], rtol=1e-5)
        np.testing.assert_allclose(out["losses"], losses, rtol=0,
                                   atol=1e-4)
        want = flat(cut(params))
        for path, x in flat(out["params"]).items():
            np.testing.assert_allclose(x, want[path], rtol=1e-5,
                                       atol=1e-6, err_msg=path)
        assert out["bitwise_repeat"], f"rank {rank}: two runs differ"


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_microbatches_match_the_full_batch_step(worlds, mesh):
    ref = worlds[0]
    losses, norms, params = ref["mb"]
    for rank, out, cut in _per_rank(worlds, f"mb_{mesh}", "mb"):
        np.testing.assert_allclose(out["losses"][0], losses[0], rtol=1e-5)
        np.testing.assert_allclose(out["norms"][0], norms[0], rtol=1e-5)
        want = flat(cut(params))
        for path, x in flat(out["params"]).items():
            np.testing.assert_allclose(x, want[path], rtol=1e-5,
                                       atol=1e-6, err_msg=path)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_microbatches_with_drops_match_jax_per_shard(worlds, mesh):
    """moe with capacity drops and 2 microbatches: the tokens that
    compete for capacity are one microbatch's rows on one rank, as in
    JAX (the global batch sliced first, then cut over the batch axes)."""
    ref = worlds[0]
    losses, norms, params = ref["mbdrop"]
    for rank, out, cut in _per_rank(worlds, f"mbdrop_{mesh}", "mbdrop"):
        np.testing.assert_allclose(out["losses"][0], losses[0], rtol=1e-5,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(out["norms"][0], norms[0], rtol=1e-5,
                                   err_msg=f"rank {rank}")
        want = flat(cut(params))
        for path, x in flat(out["params"]).items():
            np.testing.assert_allclose(x, want[path], rtol=1e-5,
                                       atol=1e-6,
                                       err_msg=f"rank {rank} {path}")
        assert out["bitwise_repeat"], f"rank {rank}: two runs differ"


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_grad_compress_matches_jax_blockwise(worlds, mesh):
    ref = worlds[0]
    for rank, out, cut in _per_rank(worlds, f"gc_{mesh}", "gc"):
        for what in ("err", "m", "v", "params"):
            want = flat(cut(ref["gc"][what]))
            for path, x in flat(out[what]).items():
                if what == "err":
                    np.testing.assert_array_equal(
                        x, want[path], err_msg=f"rank {rank} {path}")
                else:
                    np.testing.assert_allclose(
                        x, want[path], rtol=1e-6, atol=1e-9,
                        err_msg=f"rank {rank} {what} {path}")


@pytest.mark.parametrize("case", ["tied", "tp2_drop"])
def test_tensor_parallel_world_of_two(worlds, case):
    """(data 1, model 2): a tied embedding with one KV head, and moe
    with drops (the batch whole on every rank: the unsharded loss)."""
    ref = worlds[0]
    want_loss, want_g = ref[case]
    for rank, out, cut in _per_rank(worlds, case, case):
        np.testing.assert_allclose(out["loss"], want_loss, rtol=1e-5)
        _held(out["grads"], cut(want_g), f"{case} rank {rank}")
