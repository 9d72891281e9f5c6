"""Sampling (``ModelPredictor.generate``) and the CLI's trained predictors,
on the CPU.

* Near-greedy sampling (temperature 1e-4) against the JAX engine's
  ``generate`` on the same ``pred-tiny`` weights: the same tokens, except
  that a row may part from the reference where the reference's two
  largest logits (over the byte ids sampled from) lie within 1e-3 — a
  near tie, which two float orders may break either way.
* ``vocab_limit``, ``top_k`` and both prompt shapes; the same seed gives
  the same tokens; ``data/synthetic.py llm_generated`` runs.
* ``llmc-torch compress --predictor pred-tiny`` with the cache in a
  temporary directory and a short recipe: the first process trains and
  saves, a second process loads without training and restores the file
  byte for byte, and the trained predictor codes its own generated text
  better than the untrained one. Two callers that reach a missing
  predictor at once train it once.

Nothing here writes into the checkout.
"""
import logging
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import paper_predictors as jpp  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve.engine import ModelPredictor as JaxPredictor  # noqa: E402
from repro_torch.configs import paper_predictors as ppp  # noqa: E402
from repro_torch.core import LLMCompressor  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.tokenizer import BOS_ID, encode  # noqa: E402
from repro_torch.models import api as papi  # noqa: E402
from repro_torch.models.schema import from_jax  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.cli import main as cli_main  # noqa: E402
from repro_torch.train import prep  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    jp = jax.tree_util.tree_map(np.asarray, jschema.init_params(
        jpp.PRED_TINY, jax.random.PRNGKey(3)))
    return (JaxPredictor(jp, jpp.PRED_TINY, bos_id=BOS_ID),
            ModelPredictor(from_jax(jp), ppp.PRED_TINY, bos_id=BOS_ID,
                           device="cpu"), jp)


def _prompts(n, plen=6, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, plen))


@pytest.mark.parametrize("shared", [False, True])
def test_near_greedy_generate_matches_jax(pair, shared):
    jpred, ppred, jp = pair
    prompt = _prompts(3)[0] if shared else _prompts(3)
    kw = dict(batch=3, temperature=1e-4, seed=0, prompt=prompt,
              vocab_limit=256)
    want = jpred.generate(20, **kw)
    got = ppred.generate(20, **kw)
    assert got.shape == want.shape == (3, 20) and got.dtype == np.int32
    rows = np.broadcast_to(np.asarray(prompt), (3, 6))
    for b in range(3):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:           # only at a near tie of the reference
            t = int(diff[0])
            seq = np.concatenate([[BOS_ID], rows[b], want[b, :t]])
            lg = np.asarray(jtf.forward(jp, jpp.PRED_TINY, {
                "tokens": jnp.asarray(seq[None], jnp.int32)}))[0, -1, :256]
            top2 = np.sort(lg)[-2:]
            assert top2[1] - top2[0] < 1e-3, (b, t, top2)


def test_generate_respects_vocab_limit_top_k_and_prompts(pair):
    _, pred, _ = pair
    prompt = _prompts(1)[0]
    limited = pred.generate(24, batch=2, temperature=1.5, seed=1,
                            prompt=prompt, vocab_limit=10)
    assert limited.max() < 10
    shared = pred.generate(12, batch=2, seed=2, prompt=prompt)
    tiled = pred.generate(12, batch=2, seed=2, prompt=np.tile(prompt,
                                                              (2, 1)))
    np.testing.assert_array_equal(shared, tiled)
    greedy = pred.generate(12, batch=2, temperature=1e-4, prompt=prompt)
    np.testing.assert_array_equal(
        pred.generate(12, batch=2, temperature=3.0, top_k=1, seed=5,
                      prompt=prompt), greedy)
    top3 = pred.generate(16, batch=2, temperature=2.0, top_k=3, seed=4,
                         prompt=prompt)
    seq = np.concatenate([np.full((2, 1), BOS_ID), np.tile(prompt, (2, 1)),
                          top3], axis=1)
    with torch.no_grad():
        lg = papi.forward(pred.params, pred.cfg,
                          {"tokens": torch.as_tensor(seq)})
    best3 = torch.topk(lg[:, 6:-1], 3, dim=-1).indices.numpy()
    assert (best3 == top3[..., None]).any(-1).all()


def test_same_seed_same_tokens_and_llm_generated_runs(pair):
    _, pred, _ = pair
    a = pred.generate(16, batch=3, seed=7)
    np.testing.assert_array_equal(a, pred.generate(16, batch=3, seed=7))
    assert not np.array_equal(a, pred.generate(16, batch=3, seed=8))
    text = synthetic.llm_generated(pred, 50, batch=2, seed=1)
    assert isinstance(text, bytes) and 0 < len(text) <= 50


def _cli(args, env):
    return subprocess.run([sys.executable, "-m", "repro_torch.cli", *args,
                           "--predictor", "pred-tiny", "--device", "cpu",
                           "--slots", "4"], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)


def test_cli_trains_pred_tiny_once_then_loads(tmp_path, monkeypatch,
                                              capsys, caplog):
    caplog.set_level(logging.INFO, logger="repro")    # prep logs via obs
    cache = tmp_path / "cache"
    monkeypatch.setenv("REPRO_TORCH_CACHE", str(cache))
    monkeypatch.setitem(prep.TRAIN_STEPS, "pred-tiny", 16)   # a short recipe
    src, arc, back = tmp_path / "in.txt", tmp_path / "a.llmc", \
        tmp_path / "back.txt"
    src.write_bytes(synthetic.human_like("wiki", 400, seed=3))
    assert cli_main(["compress", str(src), str(arc), "--chunk", "64",
                     "--predictor", "pred-tiny", "--device", "cpu",
                     "--slots", "4"]) == 0
    err = capsys.readouterr().err
    assert "training 16 steps" in caplog.text and "UNTRAINED" not in err
    # a second process loads the checkpoint and never trains; two
    # threads: the test runs beside other test processes
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONHASHSEED="0", OMP_NUM_THREADS="2")
    r = _cli(["decompress", str(arc), str(back)], env)
    assert r.returncode == 0, r.stderr
    assert "loaded" in r.stderr and "training" not in r.stderr
    assert back.read_bytes() == src.read_bytes()

    logs = []
    trained = prep.predictor("pred-tiny", device="cpu", cache_dir=cache,
                             log=logs.append)
    assert len(logs) == 1 and "loaded" in logs[0]
    own = encode(prep.llm_dataset("wiki", 768, gen_model="pred-tiny",
                                  device="cpu", cache_dir=cache))
    assert own.size == 768
    untrained = ModelPredictor.random_init(ppp.PRED_TINY, seed=0,
                                           device="cpu")
    ratio = {}
    for name, pred in (("trained", trained), ("untrained", untrained)):
        comp = LLMCompressor(pred, chunk_size=64, topk=32, decode_batch=4)
        blob, _ = comp.compress(own)
        assert np.array_equal(comp.decompress(blob), own)
        ratio[name] = own.size / len(blob)
    assert ratio["trained"] > ratio["untrained"], ratio
    assert not any(p.is_relative_to(ROOT) for p in (cache, tmp_path))


def test_first_use_together_trains_once(tmp_path):
    """Two callers that find no checkpoint at once: one trains, the other
    waits on the lock and loads, and both get the checkpoint's weights."""
    logs = ([], [])
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(prep.train_predictor, "pred-tiny", steps=2,
                            device="cpu", cache_dir=tmp_path,
                            log=logs[i].append) for i in range(2)]
        params = [f.result()[0] for f in futs]
    trained = [any("training" in m for m in log) for log in logs]
    assert sorted(trained) == [False, True], logs
    assert any("loaded" in m for m in logs[trained.index(False)])
    for a, b in zip(tree_leaves(params[0]), tree_leaves(params[1])):
        assert torch.equal(a, b)
