"""The port's sharding policy against the JAX package's, and its cuts.

* ``param_pspecs`` (both layouts), ``cache_pspecs``, ``batch_pspecs`` and
  ``logits_pspec`` of ``repro_torch.sharding.specs`` equal the JAX
  package's, entry for entry, for every architecture of the registry on
  meshes (data, model) of (1, 1), (1, 2), (2, 2), (1, 4), (4, 2), the
  production (16, 16) and (pod 2, 16, 16), at a batch that divides the
  batch axes and at one that does not (the fallbacks).
* ``shard_params`` of ``from_jax`` weights puts every rank's block back
  together into the whole tree, and ``init_params_sharded`` draws the
  same blocks; a cache's local shapes are its spec's.

No ranks: the policy is a function of names and sizes, and a
layout-only ``Mesh(rank=r)`` stands for rank r.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from helpers import tiny  # noqa: E402
from repro.configs.registry import ARCH_IDS, get_config as jget  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.sharding import specs as jspecs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import get_config as pget  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import api, schema  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402

MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


class FakeMesh:
    """Names and sizes only: what both packages' policies read."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def _flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jtuple(spec):
    assert isinstance(spec, P)
    return tuple(spec)


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax(arch, shape, axes):
    jcfg, pcfg = jget(arch), pget(arch)
    mesh = FakeMesh(shape, axes)
    for layout in ("train", "serve"):
        jp = dict(_flat(jax.tree_util.tree_map(
            _jtuple, jspecs.param_pspecs(jcfg, mesh, layout),
            is_leaf=lambda x: isinstance(x, P))))
        pp = dict(_flat(specs.param_pspecs(pcfg, mesh, layout)))
        assert pp == jp, (arch, layout)
    nb = int(np.prod([mesh.shape[a] for a in ("pod", "data")
                      if a in mesh.shape]))
    for batch in sorted({16, 3, nb}):       # 3 divides none but (1, ...)
        jc = {k: _jtuple(v) for k, v in
              jspecs.cache_pspecs(jcfg, mesh, batch=batch).items()}
        assert specs.cache_pspecs(pcfg, mesh, batch=batch) == jc, batch
        jb = {k: _jtuple(v) for k, v in
              jspecs.batch_pspecs(jcfg, mesh, global_batch=batch).items()}
        assert specs.batch_pspecs(pcfg, mesh, global_batch=batch) == jb
        assert specs.logits_pspec(pcfg, mesh, global_batch=batch) == \
            _jtuple(jspecs.logits_pspec(jcfg, mesh, global_batch=batch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_int8_cache_specs_equal_jax(arch):
    jcfg = jget(arch).with_(kv_cache_dtype="int8")
    pcfg = pget(arch).with_(kv_cache_dtype="int8")
    for shape, axes in MESHES[1:5]:
        mesh = FakeMesh(shape, axes)
        for batch in (4, 3):
            jc = {k: _jtuple(v) for k, v in
                  jspecs.cache_pspecs(jcfg, mesh, batch=batch).items()}
            assert specs.cache_pspecs(pcfg, mesh, batch=batch) == jc


def _whole(cfg):
    pj = jax.tree_util.tree_map(
        np.asarray, jschema.init_params(cfg, jax.random.PRNGKey(3)))
    return schema.from_jax(pj)


def _reassemble(blocks, whole, spec_of, meshes, cfg=None):
    """Write every rank's block at its offsets; each element must be
    written, and every copy of it must agree with the whole tree. A
    conv leaf (the port's [xc block | B | C] layout) is joined from the
    blocks of the ranks along 'model' (``specs.join_conv``), and every
    rank's block must be its rank's of the join."""
    for path, w in _flat(whole):
        if cfg is not None and path[-1] in specs.CONV_LEAVES \
                and cfg.family in ("ssm", "hybrid"):
            tp = meshes[0].shape["model"]
            first = [dict(_flat(blocks[r]))[path] for r in range(tp)]
            assert torch.equal(specs.join_conv(first, cfg), w), path
            for mesh, tree in zip(meshes, blocks):
                assert torch.equal(dict(_flat(tree))[path], specs.cut_conv(
                    w, cfg, mesh, spec_of(path)[-1])), path
            continue
        out = torch.full_like(w, float("nan"), dtype=torch.float32)
        for mesh, tree in zip(meshes, blocks):
            b = dict(_flat(tree))[path]
            idx = []
            for dim, entry in enumerate(spec_of(path)):
                start, n = specs.block(mesh, entry, w.shape[dim])
                idx.append(slice(start, start + n))
            region = out[tuple(idx)]
            seen = ~torch.isnan(region)
            assert torch.equal(region[seen], b.float()[seen]), path
            out[tuple(idx)] = b.float()
        assert torch.equal(out, w.float()), path


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid",
                                    "encdec", "vlm"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_shard_params_reassemble_the_whole_tree(family, shape):
    jcfg = tiny(family, vocab_pad_multiple=4)
    pcfg = ModelConfig(**dataclasses.asdict(jcfg))
    whole = _whole(jcfg)
    meshes = [Mesh(shape, ("data", "model"), rank=r)
              for r in range(int(np.prod(shape)))]
    blocks = [specs.shard_params(whole, pcfg, m) for m in meshes]
    sp = dict(_flat(specs.param_pspecs(pcfg, meshes[0], "serve")))
    _reassemble(blocks, whole, lambda p: sp[p], meshes, pcfg)
    # a leaf cut over 'model' is smaller on every rank
    if shape[1] > 1:
        name = "in_x" if family in ("ssm", "hybrid") else "wq"
        layers = "dec_layers" if family == "encdec" else "layers"
        w = dict(_flat(blocks[0]))[(layers, name)]
        assert w.shape[-1] * shape[1] == whole[layers][name].shape[-1]
    # drawn leaf by leaf from the seed: the blocks of init_params
    full = schema.init_params(pcfg, 5)
    for m in meshes:
        got = dict(_flat(specs.init_params_sharded(pcfg, m, 5)))
        want = dict(_flat(specs.shard_params(full, pcfg, m)))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in got)


def _jax_conv_leaves(jcfg, batch: int = 4) -> dict:
    """JAX's global conv leaves of ``jcfg``: ``conv_w`` drawn from a key,
    and a ``conv`` cache filled with distinct values."""
    from repro.models import mamba2 as jm
    pj = jschema.init_params(jcfg, jax.random.PRNGKey(1))
    cache = np.asarray(jm.init_cache(jcfg, batch, 8)["conv"])
    cache = np.arange(cache.size, dtype=np.float32).reshape(cache.shape)
    return {"conv_w": torch.from_numpy(np.array(
        pj["layers"]["conv_w"], np.float32)), "conv": torch.from_numpy(cache)}


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("arch", ["tiny-ssm", "tiny-hybrid", "mamba2_130m",
                                  "zamba2_7b"])
def test_conv_layout_round_trip(arch, tp):
    """mamba2's conv leaves in the port's layout: each rank of 'model'
    holds its block of xc's channels, then B and C whole; the ranks'
    blocks, joined (``join_conv``), give JAX's global leaf, of
    ``conv_w`` (L, KC, di + 2N) and of the ``conv`` cache (L, B, KC - 1,
    di + 2N). At tiny's shapes with JAX's values; at mamba2-130m's and
    zamba2-7b's on the meta device (shapes), and on one channel row of
    distinct values (the columns each rank keeps)."""
    if arch.startswith("tiny"):
        jcfg = tiny(arch.split("-")[1])
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
        leaves = _jax_conv_leaves(jcfg)
    else:
        cfg = pget(arch)
        assert cfg == ModelConfig(**dataclasses.asdict(jget(arch)))
        leaves = {"conv_w": torch.empty(
            schema.schema(cfg)["layers"]["conv_w"].shape, device="meta"),
            "conv": api.init_cache(cfg, 4, 8, device="meta")["conv"]}
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    meshes = [Mesh((1, tp), ("data", "model"), rank=r) for r in range(tp)]
    assert specs.rules(cfg, meshes[0], "serve")["ssm_inner"] == "model"
    row = torch.arange(di + 2 * N, dtype=torch.float32)
    for name, whole in dict(leaves, row=row).items():
        spec = ((None,) * (whole.dim() - 1)) + ("model",)
        blocks = [specs.cut_conv(whole, cfg, m, spec[-1]) for m in meshes]
        for r, b in enumerate(blocks):
            assert tuple(b.shape) == tuple(whole.shape[:-1]) + (
                di // tp + 2 * N,), name
        joined = specs.join_conv(blocks, cfg)
        assert joined.shape == whole.shape
        if whole.device.type != "meta":
            assert torch.equal(joined, whole), name
    # the row: rank r keeps xc's channels r * di / tp .., then B and C
    n = di // tp
    for r, m in enumerate(meshes):
        got = specs.cut_conv(row, cfg, m, "model")
        assert torch.equal(got, torch.cat([row[r * n:(r + 1) * n],
                                           row[di:]]))
    # the cache and the parameters a rank allocates have these shapes
    local = api.init_cache(cfg, 4, 8, device="meta", mesh=meshes[-1])
    assert local["conv"].shape[-1] == n + 2 * N
    assert local["state"].shape[2] == cfg.ssm_heads // tp
    if arch.startswith("tiny"):
        cache = {"conv": leaves["conv"],
                 "state": torch.zeros(tuple(local["state"].shape[:2])
                                      + (cfg.ssm_heads,)
                                      + tuple(local["state"].shape[3:])),
                 "pos": torch.zeros(4, dtype=torch.int32)}
        if cfg.family == "hybrid":
            cache.update({k: v for k, v in api.init_cache(
                cfg, 4, 8).items() if k in ("k", "v")})
        got = specs.shard_cache(cache, cfg, meshes[-1], batch=4)
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in local.items()}
        assert torch.equal(got["conv"], specs.cut_conv(
            leaves["conv"], cfg, meshes[-1], "model"))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_cache_local_shapes_follow_the_specs(kv):
    cfg = pget("qwen3_14b") if kv is None else \
        pget("qwen3_14b").with_(kv_cache_dtype="int8")
    cfg = cfg.with_(n_layers=2)
    for shape in [(1, 2), (2, 2), (1, 16), (1, 3)]:
        mesh = Mesh(shape, ("data", "model"), rank=int(np.prod(shape)) - 1)
        local = api.init_cache(cfg, 4, 48, device="meta", mesh=mesh)
        whole = api.init_cache(cfg, 4, 48, device="meta")
        cs = specs.cache_pspecs(cfg, mesh, batch=4)
        for k, v in local.items():
            spec = (cs["k"][1],) if k == "pos" else cs[k]
            assert v.shape == specs.local_shape(mesh, spec,
                                                tuple(whole[k].shape)), k
            assert v.dtype == whole[k].dtype
        kv_cut = cfg.padded_kv_heads % shape[1] == 0
        assert local["k"].shape[2] == (48 if kv_cut else 48 // shape[1])


def test_a_cache_whose_batch_does_not_divide_is_refused():
    """A batch that does not divide the batch axes puts the cache's
    sequence over them (JAX's ``cache_pspecs``): 3 lanes on (2, 2) hold
    8 of 16 positions a rank, every lane. What is refused is a sequence
    that does not divide those axes in turn."""
    cfg = pget("qwen3_14b").with_(n_layers=1)
    mesh = Mesh((2, 2), ("data", "model"), rank=0)
    local = api.init_cache(cfg, 3, 16, device="meta", mesh=mesh)
    assert local["k"].shape[1:3] == (3, 8)
    assert specs.cache_pspecs(cfg, mesh, batch=3)["k"][2] == "data"
    with pytest.raises(ValueError, match="does not divide"):
        api.init_cache(cfg, 3, 15, device="meta", mesh=mesh)


def test_a_layout_only_mesh_runs_no_collectives():
    mesh = Mesh((1, 2), ("data", "model"), rank=1)
    assert mesh.axis_index("model") == 1 and mesh.degree("model") == 2
    x = torch.ones(3)
    assert mesh.psum(x, "data") is x            # an axis of one rank
    with pytest.raises(RuntimeError, match="no collectives"):
        mesh.psum(x, "model")


def test_shard_cache_cuts_every_leaf_as_the_specs_do():
    """A whole cache's blocks (``shard_cache``) have the local cache's
    shapes (``init_cache(mesh=...)``) and are the whole's slices; ``pos``
    is cut along the lanes as K/V are."""
    cfg = pget("qwen3_14b").with_(n_layers=1, kv_cache_dtype="int8")
    g = torch.Generator().manual_seed(0)
    whole = api.init_cache(cfg, 4, 32)
    for k, v in whole.items():
        v.copy_(torch.randint(-100, 100, v.shape, generator=g).to(v.dtype))
    for shape in [(2, 2), (1, 16)]:
        for r in range(int(np.prod(shape))):
            mesh = Mesh(shape, ("data", "model"), rank=r)
            got = specs.shard_cache(whole, cfg, mesh, batch=4)
            local = api.init_cache(cfg, 4, 32, device="meta", mesh=mesh)
            assert {k: v.shape for k, v in got.items()} == \
                {k: v.shape for k, v in local.items()}
            lanes = specs.block(mesh, specs.cache_pspecs(
                cfg, mesh, batch=4)["k"][1], 4)
            assert torch.equal(got["pos"], whole["pos"].narrow(0, *lanes))
            assert torch.equal(got["k"], specs.cut(whole["k"], mesh,
                                                   specs.cache_pspecs(
                                                       cfg, mesh,
                                                       batch=4)["k"]))


def test_meshes_of_one_process():
    """``local_mesh``, ``make_mesh`` (with -1) and the production shapes
    in a world of one: the first two fit it, the production mesh needs
    its 256 ranks."""
    from repro_torch.launch.mesh import (batch_axes, local_mesh, make_mesh,
                                         make_production_mesh, mesh_degree)
    m = local_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.rank == 0
    m = make_mesh((1, -1))
    assert m.axis_names == ("data", "model") and m.shape["model"] == 1
    assert make_mesh((1, 1, 1)).axis_names == ("pod", "data", "model")
    assert batch_axes(make_mesh((1, 1, 1))) == ("pod", "data")
    assert mesh_degree(m, "pod") == 1
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
