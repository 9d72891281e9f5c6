"""The port's training driver and its fault tolerance, on the CPU: the
counterparts of ``tests/test_fault_tolerance.py`` (bitwise resume, the
watchdog) and ``tests/test_distributed.py``'s elastic reshard.

* bitwise resume: 6 steps straight against 3 steps, a checkpoint (the
  pipeline's cursor inside), a restore into a fresh state and 3 more:
  every parameter equal bit for bit, on one device and on every rank of
  a gloo world of 4 ((data 2, model 2), ``tests/torch_mesh_ranks.py``);
* the elastic reshard: a training state saved on (2, 2) (rank 0 writes
  the global leaves) restores onto (1, 4) and (4, 1) in the train
  layout, (1, 4) in the serve layout and one device: every rank's block
  equals its cut of the global leaves, which equal the saving ranks'
  blocks put together; a restore into a state of another structure
  (``grad_compress``'s error leaves) raises on every rank;
* ``python -m repro_torch.launch.train --smoke --device cpu --backend
  gloo --mesh 2,1 --crash-at 3 --watchdog`` logs
  ``train.fault_injection``, ``train.resume`` and ``train.done`` on
  stdout, and its checkpoint holds the last step;
* without ``--device`` the driver asks for the card and, without one,
  raises (and does not train on the CPU).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch.mesh import Mesh, run_ranks  # noqa: E402
from repro_torch.models import schema  # noqa: E402
from repro_torch.sharding import specs  # noqa: E402
from repro_torch.train import checkpoint as pckpt  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402
from torch_mesh_ranks import (elastic_ssd_world, elastic_world,  # noqa: E402
                              flat, resume_world)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = dict(name="tiny-dense", family="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=257,
              head_pad_multiple=1, vocab_pad_multiple=4, dtype="float32",
              remat=True, qk_norm=True)
#: the SSD families (8 SSD heads, cut over 'model': conv_w in the port's
#: [xc block | B | C] layout); hybrid with one application of its shared
#: block and a trailing SSD layer
SSD = {"ssm": dict(FIELDS, name="tiny-ssm", family="ssm", qk_norm=False,
                   ssm_state=16, ssm_headdim=16, ssm_chunk=8),
       "hybrid": dict(FIELDS, name="tiny-hybrid", family="hybrid",
                      n_layers=3, hybrid_ssm_per_block=2, ssm_state=16,
                      ssm_headdim=16, ssm_chunk=8)}


def test_bitwise_resume_on_one_device(tmp_path):
    (rank, same), = resume_world(Mesh((1, 1), ("data", "model")), FIELDS,
                                 str(tmp_path))
    assert same


def test_bitwise_resume_on_a_world_of_four(tmp_path):
    got = run_ranks(resume_world, (2, 2), ("data", "model"),
                    backend="gloo", device="cpu",
                    args=(FIELDS, str(tmp_path / "ckpt")),
                    store_dir=tmp_path, timeout=600)
    assert sorted(r for r, _ in got) == [0, 1, 2, 3]
    assert all(same for _, same in got), got


@pytest.mark.parametrize("family", sorted(SSD))
def test_bitwise_resume_of_the_ssd_families_on_a_world_of_four(tmp_path,
                                                               family):
    got = run_ranks(resume_world, (2, 2), ("data", "model"),
                    backend="gloo", device="cpu",
                    args=(SSD[family], str(tmp_path / "ckpt")),
                    store_dir=tmp_path, timeout=600)
    assert sorted(r for r, _ in got) == [0, 1, 2, 3]
    assert all(same for _, same in got), got


@pytest.fixture(scope="module")
def elastic_ssd(tmp_path_factory):
    """Both SSD families' states saved on (2, 2) after a step, and
    restored onto three other meshes and layouts, in one world."""
    d = tmp_path_factory.mktemp("elastic_ssd")
    cases = {f: (SSD[f], str(d / f)) for f in SSD}
    got = run_ranks(elastic_ssd_world, (2, 2), ("data", "model"),
                    backend="gloo", device="cpu", args=(cases,),
                    store_dir=d, timeout=600)
    return d, got


def _global_state(ckpt, fields):
    """The checkpoint's global parameters, m and v, restored onto one
    device (numpy)."""
    cfg = ModelConfig(**fields)
    whole = schema.init_params(cfg, 0)
    opt = popt.AdamWConfig()
    like = {"params": whole, "opt": popt.init_opt_state(whole, opt),
            "pipe": {"step": np.zeros((), np.int64)}}
    got, step = pckpt.restore_latest(ckpt, like)
    assert step == 1
    return cfg, popt.tree_map(lambda t: t.numpy(), {
        "params": got["params"], "m": got["opt"]["m"],
        "v": got["opt"]["v"]})


@pytest.mark.parametrize("family", sorted(SSD))
def test_ssd_checkpoint_of_a_mesh_holds_the_global_conv_leaf(elastic_ssd,
                                                             family):
    """Rank 0 wrote JAX's global leaves: conv_w, its m and its v restored
    onto one device equal ``specs.join_conv`` of the saving ranks'
    blocks along 'model' (their xc blocks side by side, then B and C),
    and every leaf cut under the saving mesh's specs is each rank's
    block, bit for bit."""
    d, got = elastic_ssd
    cfg, glob = _global_state(d / family, SSD[family])
    saved = dict(got[family]["saved"])
    assert sorted(saved) == [0, 1, 2, 3]
    tail = 2 * cfg.ssm_state
    for what in ("params", "m", "v"):
        conv = glob[what]["layers"]["conv_w"]
        assert conv.shape[-1] == cfg.ssm_d_inner + tail
        for row in ((0, 1), (2, 3)):    # the ranks of 'model' at data 0, 1
            blocks = [torch.from_numpy(saved[r][what]["layers"]["conv_w"])
                      for r in row]
            np.testing.assert_array_equal(
                specs.join_conv(blocks, cfg).numpy(), conv,
                err_msg=f"{family} {what} conv_w, ranks {row}")
        if what != "params":
            assert np.abs(conv[..., -tail:]).max() > 0, what
        for rank, blocks in saved.items():
            m = Mesh((2, 2), ("data", "model"), rank=rank)
            sp = specs.param_pspecs(cfg, m, "train")
            want = flat(popt.tree_map(
                lambda t, s: specs.cut(torch.from_numpy(t), m, s).numpy(),
                glob[what], sp))
            for path, x in flat(blocks[what]).items():
                np.testing.assert_array_equal(
                    x, want[path], err_msg=f"{family} rank {rank} {what} "
                                           f"{path}")


@pytest.mark.parametrize("family", sorted(SSD))
@pytest.mark.parametrize("shape,layout", [((1, 4), "train"),
                                          ((4, 1), "train"),
                                          ((1, 4), "serve")])
def test_ssd_elastic_restore_onto_another_mesh(elastic_ssd, family, shape,
                                               layout):
    """Every rank's restored parameters, m and v equal
    ``specs.shard_params`` of the global leaves under its mesh and
    layout (conv_w by ``cut_conv``)."""
    d, got = elastic_ssd
    cfg, glob = _global_state(d / family, SSD[family])
    ranks = got[family][(shape, layout)]
    assert sorted(r for r, _ in ranks) == list(range(4))
    for rank, blocks in ranks:
        m = Mesh(shape, ("data", "model"), rank=rank)
        for what in ("params", "m", "v"):
            want = flat(popt.tree_map(lambda t: t.numpy(), specs.shard_params(
                popt.tree_map(torch.from_numpy, glob[what]), cfg, m,
                layout=layout)))
            for path, x in flat(blocks[what]).items():
                np.testing.assert_array_equal(
                    x, want[path], err_msg=f"{family} rank {rank} {what} "
                                           f"{path}")


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    got = run_ranks(elastic_world, (2, 2), ("data", "model"),
                    backend="gloo", device="cpu",
                    args=(FIELDS, str(d / "ckpt")), store_dir=d,
                    timeout=600)
    return d / "ckpt", got


def test_checkpoint_of_a_mesh_holds_the_global_leaves(elastic):
    """Rank 0 wrote the whole leaves: the one-device restore equals the
    state drawn whole from the seed (each rank drew its blocks of it)."""
    ckpt, _ = elastic
    cfg = ModelConfig(**FIELDS)
    whole = schema.init_params(cfg, 0)
    opt = popt.AdamWConfig()
    like = {"params": whole, "opt": popt.init_opt_state(whole, opt),
            "pipe": {"step": np.zeros((), np.int64)}}
    got, step = pckpt.restore_latest(ckpt, like)
    assert step == 1 and int(got["pipe"]["step"]) == 1
    for path, x in flat(popt.tree_map(lambda t: t.numpy(),
                                      got["params"])).items():
        want = flat(popt.tree_map(lambda t: t.numpy(), whole))[path]
        assert x.dtype == want.dtype and x.shape == want.shape, path
        np.testing.assert_array_equal(x, want, err_msg=path)


@pytest.mark.parametrize("shape,layout", [((1, 4), "train"),
                                          ((4, 1), "train"),
                                          ((1, 4), "serve")])
def test_elastic_restore_onto_another_mesh(elastic, shape, layout):
    _, got = elastic
    cfg = ModelConfig(**FIELDS)
    whole = schema.init_params(cfg, 0)
    ranks = got[(shape, layout)]
    assert sorted(r for r, _ in ranks) == list(range(4))
    for rank, blocks in ranks:
        m = Mesh(shape, ("data", "model"), rank=rank)
        want = flat(popt.tree_map(lambda t: t.numpy(), specs.shard_params(
            whole, cfg, m, layout=layout)))
        for path, x in flat(blocks).items():
            np.testing.assert_array_equal(x, want[path],
                                          err_msg=f"rank {rank} {path}")


def test_restore_into_another_structure_raises_on_every_rank(elastic):
    """A checkpoint saved without ``grad_compress`` restored into a state
    with its ``opt.err`` leaves: every rank raises (one process group,
    no rank left waiting) instead of training again from step 0."""
    _, got = elastic
    refused = got["refused"]
    assert sorted(r for r, _ in refused) == [0, 1, 2, 3]
    for rank, msg in refused:
        assert msg is not None and "opt.err" in msg, (rank, msg)


def _driver(args, tmp_path, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONHASHSEED",)}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         str(ROOT / "tests")])
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=600)


def test_watchdog_restarts_after_an_injected_crash_on_a_mesh(tmp_path):
    ckpt = tmp_path / "ckpt"
    out = _driver(["--arch", "qwen3-1.7b", "--smoke", "--steps", "6",
                   "--batch", "2", "--seq-len", "32", "--ckpt-dir",
                   str(ckpt), "--ckpt-every", "2", "--crash-at", "3",
                   "--watchdog", "--log-every", "1", "--mesh", "2,1",
                   "--backend", "gloo", "--device", "cpu",
                   "--corpus-bytes", "65536"], tmp_path)
    log = out.stdout
    assert out.returncode == 0, log[-3000:] + out.stderr[-3000:]
    assert "train.fault_injection step=3" in log
    assert "train.resume restored=2 continuing=2" in log
    assert "train.done" in log
    assert "collectives=" in log
    assert (ckpt / "latest").read_text() == "step-00000006"


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b",
                                  "llava-next-34b"])
def test_driver_trains_the_ssd_and_vlm_families_on_a_mesh(tmp_path, arch):
    """ssm, hybrid and vlm (on its text, as the JAX driver feeds it)
    train through the driver on (data 2, model 2) to ``train.done``."""
    out = _driver(["--arch", arch, "--smoke", "--steps", "2", "--batch",
                   "2", "--seq-len", "16", "--log-every", "1", "--mesh",
                   "2,2", "--backend", "gloo", "--device", "cpu",
                   "--corpus-bytes", "16384"], tmp_path)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("train.step") == 2, out.stdout[-3000:]
    assert "train.done" in out.stdout and "launches=0" in out.stdout


def test_driver_refuses_encdec_naming_the_missing_frames(tmp_path):
    """The token pipeline makes no frames: the driver refuses the encdec
    family before it starts a rank (JAX's raises a KeyError on
    batch["frames"] mid-step)."""
    for extra in ([], ["--mesh", "2,2", "--backend", "gloo"]):
        out = _driver(["--arch", "whisper-large-v3", "--smoke", "--steps",
                       "1", "--device", "cpu", *extra], tmp_path)
        assert out.returncode != 0
        assert "frames" in out.stderr and "encdec" in out.stderr, \
            out.stderr[-2000:]
        assert "train.step" not in out.stdout


def test_driver_asks_for_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    for extra in ([], ["--mesh", "2,1", "--backend", "gloo"]):
        out = _driver(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1",
                       *extra], tmp_path)
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr, out.stderr[-2000:]
        assert "train.step" not in out.stdout
    # nccl needs a card a rank: refused, not switched to gloo
    out = _driver(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1",
                   "--mesh", "2,1", "--device", "cpu"], tmp_path)
    assert out.returncode != 0 and "nccl" in out.stderr
