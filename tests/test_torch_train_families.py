"""Training of the ssm, hybrid, moe and encdec families: the port against
the JAX package's, on the CPU.

Configs are tiny and fp32: ``tests/helpers.py``'s ``tiny("ssm")``, a
hybrid of 5 SSD layers in groups of 2 (two applications of the shared
block, whose gradient sums over them, and a trailing SSD layer),
``tiny("moe")`` (4 experts, top 2), granite-moe-1b-a400m's
``tiny_variant`` keeping its 32 experts and top 8, and
``tiny("encdec")`` with frames (B, 8, D). Weights are made by the JAX
package and carried across by ``from_jax``; tokens and frames come from
numpy seeds; S = 20 is no multiple of the SSD chunk (8), so the plain
scan pads. Held, for each family:

* ``loss_fn`` within rtol 1e-5 of JAX's, with ``loss_block`` 0 and 8;
* every leaf's gradient within 1e-4 x that leaf's max |g| of
  ``jax.grad``, every leaf nonzero, with per-layer remat off and on;
* three composed train steps, and two microbatches against the mean of
  two calls (a moe microbatch has its own capacity, as in JAX);
* the training forward launches no kernel: with gradient-carrying
  weights the scoring forward raises (the kernels have no backward) and
  the training forward does not; under ``no_grad`` the two agree;
* moe at capacity factor 0.5: the kept (token, slot) set of every layer
  equals JAX's ``rank < C`` on the same router input, and some slot is
  dropped (the control); loss and gradients agree with drops; at a
  capacity factor of E / k nothing is dropped and the capacity dispatch
  equals the dropless one bit for bit;
* ``ssd_chunked(impl="plain")`` and its gradient against the JAX
  ``ssd_chunked``'s, with an entering state, every gradient finite.

The reference composes ``jax.value_and_grad(loss_fn)`` and
``adamw_update`` as ``repro.train.train_loop`` does, without a mesh (see
``tests/test_torch_train.py``).
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
from repro.configs import base as jbase  # noqa: E402
from repro.configs import granite_moe_1b_a400m as jgranite  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import api as papi  # noqa: E402
from repro_torch.models import mamba2 as pmamba2  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models import schema as pschema  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402
from repro_torch.train import train_loop as ploop  # noqa: E402

CFGS = {
    "ssm": tiny("ssm"),
    "hybrid": tiny("hybrid", n_layers=5, hybrid_ssm_per_block=2),
    "moe": tiny("moe"),
    "granite-moe": jbase.tiny_variant(jgranite.CONFIG, n_experts=32,
                                      top_k=8),
    "encdec": tiny("encdec"),
}
MOE = ("granite-moe", "moe")
OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=6)
B, S = 4, 20


def _setup(name, seed=0, **over):
    jcfg = dataclasses.replace(CFGS[name], **over)
    pcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jax.tree_util.tree_map(
        np.asarray, jschema.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                    (B, S)).astype(np.int32)}
    if jcfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, jcfg.max_source_len, jcfg.d_model)).astype(np.float32)
    return jcfg, pcfg, jp, batch


def _torch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _rows(batch, lo, hi):
    return {k: v[lo:hi] for k, v in batch.items()}


def _np(tree):
    return popt.tree_map(lambda t: t.detach().numpy(), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@partial(jax.jit, static_argnums=(1, 3))
def _jax_vg(params, cfg, batch, loss_block=0):
    return jax.value_and_grad(japi.loss_fn)(
        params, cfg, batch, attn_impl="masked", loss_block=loss_block)


def _grads_held(jg, pg):
    jg = _flat(jax.tree_util.tree_map(np.asarray, jg))
    pg = _flat(_np(pg))
    assert sorted(jg) == sorted(pg)
    for path in jg:
        scale = np.abs(jg[path]).max()
        assert scale > 0 and np.abs(pg[path]).max() > 0, path
        np.testing.assert_allclose(pg[path], jg[path], rtol=0,
                                   atol=1e-4 * scale, err_msg=path)


@pytest.mark.parametrize("loss_block", [0, 8])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_loss_matches_jax(name, loss_block):
    jcfg, pcfg, jp, batch = _setup(name)
    jl, _ = _jax_vg(jp, jcfg, batch, loss_block)
    with torch.no_grad():
        pl = papi.loss_fn(pschema.from_jax(jp), pcfg, _torch(batch),
                          loss_block=loss_block)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_grads_match_jax(name, remat):
    jcfg, pcfg, jp, batch = _setup(name)
    jl, jg = _jax_vg(jp, jcfg, batch)
    pl, pg = ploop.value_and_grad(pschema.from_jax(jp),
                                  pcfg.with_(remat=remat), batch)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _grads_held(jg, pg)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_three_train_steps_match_jax(name):
    jcfg, pcfg, jp, batch = _setup(name)
    jc, pc = jopt.AdamWConfig(**OPT), popt.AdamWConfig(**OPT)
    jparams, jstate = jp, jopt.init_opt_state(jp, jc)
    pparams = pschema.from_jax(jp)
    pstate = popt.init_opt_state(pparams, pc)
    step = ploop.make_train_step(pcfg, opt=pc)
    for s in range(3):
        b = {k: np.roll(v, s, axis=1) for k, v in batch.items()}
        jl, jg = _jax_vg(jparams, jcfg, b)
        jparams, jstate, _ = jopt.adamw_update(jparams, jg, jstate, jc)
        pparams, pstate, m = step(pparams, pstate, b)
        assert abs(float(m["loss"]) - float(jl)) < 1e-4, (s, m, jl)
        assert int(m["step"]) == s + 1


@pytest.mark.parametrize("name", sorted(CFGS))
def test_microbatches_average_two_value_and_grad_calls(name):
    jcfg, pcfg, jp, batch = _setup(name)
    pc = popt.AdamWConfig(**OPT)
    params = pschema.from_jax(jp)
    state = popt.init_opt_state(params, pc)
    new, _, m = ploop.make_train_step(pcfg, opt=pc, num_microbatches=2)(
        params, state, batch)
    halves = [_rows(batch, 0, B // 2), _rows(batch, B // 2, B)]
    jls = [float(_jax_vg(jp, jcfg, h)[0]) for h in halves]
    np.testing.assert_allclose(float(m["loss"]), np.mean(jls), rtol=1e-5)
    parts = [ploop.value_and_grad(params, pcfg, h)[1] for h in halves]
    mean = popt.tree_map(lambda a, b: (a.float() + b.float()) / 2, *parts)
    want, _, gn = popt.adamw_update(params, mean, state, pc)
    np.testing.assert_allclose(float(m["grad_norm"]), float(gn), rtol=1e-6)
    for path, w in _flat(_np(want)).items():
        np.testing.assert_allclose(_flat(_np(new))[path], w, rtol=0,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_training_forward_runs_no_kernel(name):
    _, pcfg, jp, batch = _setup(name)
    params = popt.tree_map(lambda t: t.requires_grad_(True),
                           pschema.from_jax(jp))
    tb = _torch(batch)
    with pytest.raises(RuntimeError, match="no backward"):
        papi.forward(params, pcfg, tb)
    trained = papi.forward(params, pcfg, tb,
                           **papi.TRAIN_FORWARD[pcfg.family])
    assert trained.requires_grad
    with torch.no_grad():
        scored = papi.forward(params, pcfg, tb)
    train_kw = dict(papi.TRAIN_FORWARD[pcfg.family])
    if pcfg.family == "moe":
        # the same dispatch: only the attention and the scan differ
        train_kw["dropless"] = True
    with torch.no_grad():
        plain = papi.forward(params, pcfg, tb, **train_kw)
    np.testing.assert_allclose(plain.numpy(), scored.numpy(), atol=1e-5,
                               rtol=1e-5)


def _jax_keep(x, lp, cfg):
    """JAX's kept (token, slot)s of one capacity dispatch of x (T, D)."""
    _, experts = jmoe._route(jnp.asarray(x), jnp.asarray(lp["router"]),
                             cfg.top_k)
    fe = experts.reshape(-1)
    rank = jmoe._rank_within_expert(fe, cfg.n_experts)
    T = x.shape[0]
    C = max(1, int(np.ceil(T * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor)))
    return np.asarray(rank < C)


def _capacity_forward(monkeypatch, params, cfg, batch):
    """The capacity-dropped training forward under ``no_grad``, and each
    layer's (router input, kept (token, slot)s), observed by wrapping
    ``moe.route`` and ``moe._keep``."""
    xs, keeps = [], []
    route, keep = pmoe.route, pmoe._keep

    def recording_route(x_flat, *args):
        xs.append(x_flat)
        return route(x_flat, *args)

    def recording_keep(*args):
        keeps.append(keep(*args))
        return keeps[-1]
    with monkeypatch.context() as m:
        m.setattr(pmoe, "route", recording_route)
        m.setattr(pmoe, "_keep", recording_keep)
        with torch.no_grad():
            out = pmoe.forward(params, cfg, batch, attn_impl="masked",
                               dropless=False)
    assert len(xs) == len(keeps) == cfg.n_layers
    return out, list(zip(xs, keeps))


@pytest.mark.parametrize("name", MOE)
def test_capacity_drops_match_jax(name, monkeypatch):
    jcfg, pcfg, jp, batch = _setup(name, capacity_factor=0.5)
    params = pschema.from_jax(jp)
    _, log = _capacity_forward(monkeypatch, params, pcfg, _torch(batch))
    dropped = 0
    for layer, (x, keep) in enumerate(log):
        lp = {k: v[layer] for k, v in jp["layers"].items()}
        want = _jax_keep(x.numpy(), lp, jcfg)
        np.testing.assert_array_equal(keep.numpy(), want,
                                      err_msg=f"layer {layer}")
        dropped += int((~want).sum())
    assert dropped > 0           # the control: this capacity drops slots
    jl, jg = _jax_vg(jp, jcfg, batch)
    pl, pg = ploop.value_and_grad(params, pcfg, batch)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _grads_held(jg, pg)


@pytest.mark.parametrize("name", MOE)
def test_capacity_without_drops_equals_dropless(name, monkeypatch):
    pcfg = ModelConfig(**dataclasses.asdict(CFGS[name]))
    pcfg = pcfg.with_(capacity_factor=pcfg.n_experts / pcfg.top_k)
    _, _, jp, batch = _setup(name)
    params = pschema.from_jax(jp)
    tb = _torch(batch)
    assert pmoe.capacity(pcfg, B * S) == B * S
    cap, log = _capacity_forward(monkeypatch, params, pcfg, tb)
    with torch.no_grad():
        free = pmoe.forward(params, pcfg, tb, attn_impl="masked",
                            dispatch_group=0)
    assert all(bool(keep.all()) for _, keep in log)
    assert torch.equal(cap, free)


def test_plain_ssd_and_its_gradient_match_jax():
    rng = np.random.default_rng(7)
    Bs, Sq, H, P, N = 2, 20, 4, 8, 16
    x = rng.standard_normal((Bs, Sq, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (Bs, Sq, H)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, (H,)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((Bs, Sq, N)).astype(np.float32)
              for _ in range(2))
    s0 = rng.standard_normal((Bs, H, P, N)).astype(np.float32)
    wy = rng.standard_normal((Bs, Sq, H, P)).astype(np.float32)
    ws = rng.standard_normal((Bs, H, P, N)).astype(np.float32)

    def objective(scan, x, dt, A, Bm, Cm, s0, wy, ws):
        y, fin = scan(x, dt, A, Bm, Cm, chunk=8, initial_state=s0)
        return (y * wy).sum() + (fin * ws).sum(), (y, fin)

    args = (x, dt, A, Bm, Cm, s0)
    (jv, (jy, jfin)), jgrads = jax.value_and_grad(
        lambda *a: objective(jmamba2.ssd_chunked, *a), argnums=tuple(
            range(6)), has_aux=True)(*map(jnp.asarray, args + (wy, ws)))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    pv, (py, pfin) = objective(partial(pmamba2.ssd_chunked, impl="plain"),
                               *targs,
                               torch.from_numpy(wy), torch.from_numpy(ws))
    pgrads = torch.autograd.grad(pv, targs)
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pfin.detach().numpy(), np.asarray(jfin),
                               atol=1e-4, rtol=1e-4)
    for name, p, j in zip("x dt A B C s0".split(), pgrads, jgrads):
        j = np.asarray(j)
        assert torch.isfinite(p).all(), name
        np.testing.assert_allclose(p.numpy(), j, rtol=0,
                                   atol=1e-4 * np.abs(j).max(),
                                   err_msg=name)
