"""The port's dry run (``launch/dryrun.py``), its stand-in mesh and its
analyses, against a real world and the JAX package, on the CPU.

  * The stand-in's log: tiny cells of every kind (train with two
    microbatches, prefill, decode, decode at batch 1 with the cache cut
    along the sequence over 'data'; dense, moe in the train layout,
    hybrid) traced on the meta device as rank 0 of a (2, 2)
    ``StandInMesh`` make the collectives, op by op in axis, shape and
    dtype, that rank 0 of a real world of 4 ranks (gloo) makes running
    the same step on values.
  * Argument bytes: the meta inputs' bytes at rank 0's blocks equal the
    sum of JAX's ``NamedSharding.shard_shape`` over the same trees
    (parameters in the serve and train layouts, AdamW's state, the
    decode cache), in a JAX subprocess on 4 host devices. Two leaves
    are laid out otherwise by design and left out: the cache's ``pos``
    (whole on every device in JAX, cut along the lanes here) and
    mamba2's conv channels (``specs.ConvSpec``), so the families here
    are dense, moe and encdec.
  * ``hlo_analysis.analytic_memory_bytes`` equals JAX's for every
    architecture x shape x production mesh.
  * The probes' extrapolation equals a full trace of a tiny config
    (FLOPs, bytes accessed, the collectives' bytes and counts), for a
    dense config at four microbatches and a hybrid one whose SSD layers
    do not fill their last group.
  * ``python -m repro_torch.launch.dryrun`` for the three cells this
    slice unblocks exits 0 and writes JAX's keys.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

from repro_torch.configs.base import SHAPES, ModelConfig, \
    ShapeConfig  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402
from repro_torch.launch.input_specs import (abstract_opt_state,  # noqa: E402
                                            abstract_params,
                                            decode_input_specs, tree_bytes)
from repro_torch.launch.mesh import StandInMesh, run_ranks  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serve import steps  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.train_loop import make_train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
AXES = ("data", "model")
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=257, head_pad_multiple=1, vocab_pad_multiple=4,
            dtype="float32", remat=False)
FAMILY_KW = {"dense": {}, "moe": dict(n_experts=4, top_k=2),
             "hybrid": dict(n_layers=3, hybrid_ssm_per_block=1,
                            ssm_state=16, ssm_headdim=16, ssm_chunk=8),
             "encdec": dict(n_enc_layers=2, max_source_len=8)}
#: cell -> (family, kind, seq_len, global batch, microbatches)
CELLS = {
    "dense_train": ("dense", "train", 8, 4, 2),
    "dense_prefill": ("dense", "prefill", 8, 4, 1),
    "dense_decode": ("dense", "decode", 16, 4, 1),
    "dense_long": ("dense", "decode", 16, 1, 1),
    "moe_train": ("moe", "train", 8, 4, 1),
    "moe_prefill": ("moe", "prefill", 8, 4, 1),
    "hybrid_long": ("hybrid", "decode", 16, 1, 1),
}


def _cfg(family: str, **kw) -> ModelConfig:
    return ModelConfig(name=f"tiny-{family}", family=family,
                       **{**BASE, **FAMILY_KW[family], **kw})


def _key(entry) -> tuple:
    op, axis, shape, dtype = entry[:4]
    return op, axis if isinstance(axis, str) else tuple(axis), \
        tuple(shape), dtype


def real_logs(mesh) -> dict:
    """Rank 0's collective log of each cell's step, run on values."""
    torch.set_num_threads(1)
    out = {}
    for cell, (family, kind, S, B, nmb) in CELLS.items():
        cfg = _cfg(family)
        g = torch.Generator().manual_seed(0)
        if kind == "train":
            p = specs.init_params_sharded(cfg, mesh, 0, "cpu",
                                          layout="train")
            step = make_train_step(cfg, mesh, opt=AdamWConfig(),
                                   num_microbatches=nmb, global_batch=B)
            toks = torch.randint(0, 256, (B, S), generator=g)
            mesh.record()
            step(p, init_opt_state(p, AdamWConfig()), {"tokens": toks})
        elif kind == "prefill":
            layout = steps.score_layout(cfg, mesh)
            p = specs.init_params_sharded(cfg, mesh, 0, "cpu",
                                          layout=layout)
            step = steps.make_score_step(cfg, mesh, topk=8,
                                         global_batch=B)
            toks = torch.randint(0, 256, (B, S), generator=g)
            mesh.record()
            step(p, {"tokens": toks})
        else:
            p = specs.init_params_sharded(cfg, mesh, 0, "cpu")
            cache = api.init_cache(cfg, B, S, device="cpu", mesh=mesh)
            step = steps.make_serve_step(cfg, mesh, batch=B, topk=8)
            mesh.record()
            step(p, cache, torch.randint(0, 256, (B,), generator=g))
        out[cell] = [_key(e) for e in mesh.log]
        mesh.log = None
    return out


def _traced_log(cell: str) -> list:
    family, kind, S, B, nmb = CELLS[cell]
    mesh = StandInMesh((2, 2), AXES, rank=0)
    cfg = _cfg(family)
    shape = ShapeConfig(cell, S, B, kind)
    if kind != "train":
        # the score and serve steps take topk 64 in the dry run; the
        # real world's K is 8: hold the log at the test's K
        return _trace_with_topk(cfg, shape, mesh)
    m = dryrun.trace_step(cfg, shape, mesh, num_microbatches=nmb)
    return [_key(e) for e in m["log"]]


def _trace_with_topk(cfg, shape, mesh, k=8) -> list:
    orig_score, orig_serve = steps.make_score_step, steps.make_serve_step
    steps.make_score_step = lambda *a, **kw: orig_score(
        *a, **{**kw, "topk": k})
    steps.make_serve_step = lambda *a, **kw: orig_serve(
        *a, **{**kw, "topk": k})
    try:
        m = dryrun.trace_step(cfg, shape, mesh)
    finally:
        steps.make_score_step, steps.make_serve_step = orig_score, \
            orig_serve
    return [_key(e) for e in m["log"]]


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_world")
    return run_ranks(real_logs, (2, 2), AXES, backend="gloo", device="cpu",
                     store_dir=d, timeout=600)


@pytest.mark.parametrize("cell", list(CELLS))
def test_stand_in_log_equals_a_real_world(real, cell):
    traced = _traced_log(cell)
    assert traced, f"{cell}: no collective was logged"
    assert traced == real[cell]


JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs.base import ModelConfig, SHAPES
from repro.configs.registry import ARCH_IDS, get_config
from repro.launch.hlo_analysis import analytic_memory_bytes
from repro.models import api as mapi
from repro.models.schema import abstract_params
from repro.sharding.specs import cache_pspecs, param_pspecs

CFGS = json.loads(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}

def shard_bytes(tree, spec_tree, itemsize=None):
    leaves = jax.tree_util.tree_leaves(tree)
    specs_ = jax.tree_util.tree_leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for x, s in zip(leaves, specs_):
        shp = NamedSharding(mesh, s).shard_shape(x.shape)
        total += int(np.prod(shp)) * (itemsize or jnp.dtype(x.dtype).itemsize)
    return total

for name, kw in CFGS.items():
    cfg = ModelConfig(**kw)
    pa = abstract_params(cfg)
    for layout in ("serve", "train"):
        out[f"{name}/params/{layout}"] = shard_bytes(
            pa, param_pspecs(cfg, mesh, layout))
    out[f"{name}/opt"] = 2 * shard_bytes(
        pa, param_pspecs(cfg, mesh, "train"), itemsize=4) + 4
    for B in (1, 4):
        extra = {"source_len": cfg.max_source_len} \
            if cfg.family == "encdec" else {}
        c = jax.eval_shape(lambda: mapi.init_cache(cfg, B, 16, **extra))
        cs = cache_pspecs(cfg, mesh, batch=B)
        c = {k: v for k, v in c.items() if k != "pos"}
        out[f"{name}/cache/{B}"] = shard_bytes(
            c, {k: cs[k] for k in c})
mem = {}
for a in ARCH_IDS:
    cfg = get_config(a)
    for s, shape in SHAPES.items():
        for n, tp in ((256, 16), (512, 16)):
            mem[f"{a}/{s}/{n}"] = analytic_memory_bytes(
                cfg, shape, n_chips=n, tp=tp, num_microbatches=8)
out["mem"] = mem
print("JAX_OUT " + json.dumps(out))
"""

BYTES_CFGS = {"dense": _cfg("dense"), "moe": _cfg("moe"),
              "encdec": _cfg("encdec")}


@pytest.fixture(scope="module")
def jax_bytes():
    import dataclasses
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    cfgs = {k: dataclasses.asdict(c) for k, c in BYTES_CFGS.items()}
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, "",
                        json.dumps(cfgs)], capture_output=True, text=True,
                       env=env, timeout=300)
    line = [x for x in r.stdout.splitlines() if x.startswith("JAX_OUT ")]
    assert r.returncode == 0 and line, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(line[0][len("JAX_OUT "):])


@pytest.mark.parametrize("name", list(BYTES_CFGS))
def test_argument_bytes_equal_jax_shard_shapes(jax_bytes, name):
    cfg = BYTES_CFGS[name]
    mesh = StandInMesh((2, 2), AXES, rank=0)
    for layout in ("serve", "train"):
        assert tree_bytes(abstract_params(cfg, mesh, layout)) == \
            jax_bytes[f"{name}/params/{layout}"], layout
    opt = abstract_opt_state(abstract_params(cfg, mesh, "train"))
    assert tree_bytes(opt) == jax_bytes[f"{name}/opt"]
    for B in (1, 4):
        cache, _ = decode_input_specs(cfg, ShapeConfig("c", 16, B,
                                                       "decode"), mesh)
        cache.pop("pos")
        assert tree_bytes(cache) == jax_bytes[f"{name}/cache/{B}"], B


def test_analytic_memory_equals_jax(jax_bytes):
    want = jax_bytes["mem"]
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s, shape in SHAPES.items():
            for n, tp in ((256, 16), (512, 16)):
                got = hlo_analysis.analytic_memory_bytes(
                    cfg, shape, n_chips=n, tp=tp, num_microbatches=8)
                assert got == pytest.approx(want[f"{a}/{s}/{n}"],
                                            rel=1e-12), (a, s, n)


@pytest.mark.parametrize("family,n_layers,nmb", [("dense", 4, 4),
                                                 ("hybrid", 5, 2)])
def test_probes_extrapolate_to_a_full_trace(family, n_layers, nmb):
    kw = dict(n_layers=n_layers)
    if family == "hybrid":
        kw["hybrid_ssm_per_block"] = 2      # 5 = 2 groups + 1 layer
    cfg = _cfg(family, **kw)
    mesh = StandInMesh((2, 2), AXES, rank=0)
    shape = ShapeConfig("t", 8, 4 * nmb, "train")
    full = dryrun.trace_step(cfg, shape, mesh, num_microbatches=nmb)
    coll = hlo_analysis.collective_stats(full["log"])
    est = dryrun.probe_step(cfg, shape, mesh, num_microbatches=nmb)
    for key in ("flops", "aten_flops", "bytes_accessed"):
        assert est[key] == pytest.approx(full[key], rel=1e-9), key
    for kind, v in coll["by_kind"].items():
        for f in ("bytes", "count"):
            assert est["collectives"]["by_kind"][kind][f] == \
                pytest.approx(v[f], rel=1e-9, abs=1e-6), (kind, f)
    assert est["argument_bytes"] == full["argument_bytes"]


@pytest.mark.parametrize("arch,shape,mesh,probe", [
    ("h2o_danube_3_4b", "long_500k", "single", "auto"),
    ("zamba2_7b", "long_500k", "multi", "auto"),
    ("qwen3_moe_235b_a22b", "prefill_32k", "single", "on"),
])
def test_dryrun_cli_traces_the_unblocked_cells(tmp_path, arch, shape, mesh,
                                               probe):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--probe", probe, "--results",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert not list(tmp_path.glob("*.err"))
    res = json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json")
                     .read_text())
    for key in ("arch", "shape", "mesh", "mesh_axes", "kind", "n_chips",
                "memory", "roofline", "collectives", "lower_s"):
        assert key in res, key
    for key in ("bytes_per_device", "argument_bytes", "temp_bytes"):
        assert res["memory"][key] > 0, key
    for key in ("t_compute_s", "t_memory_s", "t_collective_s",
                "bottleneck", "roofline_fraction"):
        assert key in res["roofline"], key
    assert res["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("flags", [["--attn-impl", "masked"],
                                   ["--no-sharded-topk"]])
def test_dryrun_refuses_options_the_port_does_not_run(tmp_path, flags):
    """JAX's flags are taken with the one value each that the port runs;
    another is refused before any cell is traced or written."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "h2o_danube_3_4b", "--shape", "long_500k",
                     "--results", str(tmp_path), *flags])
    assert e.value.code == 2
    assert not list(tmp_path.iterdir())
