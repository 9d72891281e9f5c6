"""The port's engine programs on the CPU: verify/rollback, snapshot/
restore, prefill, the service's context paths and the CLI flags.

* ``verify_steps`` gives logits bit-identical to T ``decode_step`` calls
  and within 1e-4 of the JAX package's ``verify_steps`` on the same
  weights (``from_jax``); XLA and PyTorch multiply in other orders.
* ``rollback`` of each lane, then more steps, is bit-identical to
  lock-step decoding of the inputs that lane kept.
* Prefill and snapshot/restore are bit-identical to sequential decode
  (``tests/test_context.py``'s engine tests, ported).
* The service's shared-prefix jobs hit the radix prefix cache and round-
  trip, and write the bytes a cache-off run writes; its carried-context
  bytes equal the grouped compressor's; the next job on the same service
  works (both used to raise).
* ``llmc-torch compress --context-window/--shared-prefix`` and
  ``decompress --draft`` round-trip with ``--device cpu``.
* Every engine call leaves each cache leaf's storage where it was: the
  precondition of the captured step on the card.

Tiny configs (d=64) of the four families (dense, moe and ssm with 2
layers, the moe one with qwen3-moe's qk-norm and 4 experts, top 2; hybrid
with 5 SSD layers and the shared block after every 2), weights from
fixed seeds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (caps torch's threads)

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import mamba2_130m as jmamba  # noqa: E402
from repro.configs import qwen3_1_7b as jqwen  # noqa: E402
from repro.configs import qwen3_moe_235b_a22b as jqmoe  # noqa: E402
from repro.configs import zamba2_7b as jzamba  # noqa: E402
from repro.models import schema as jschema  # noqa: E402
from repro.serve.engine import ModelPredictor as JaxPredictor  # noqa: E402
from repro_torch.cli import main as cli_main  # noqa: E402
from repro_torch.configs import base as pbase  # noqa: E402
from repro_torch.configs import mamba2_130m as pmamba  # noqa: E402
from repro_torch.configs import qwen3_1_7b as pqwen  # noqa: E402
from repro_torch.configs import qwen3_moe_235b_a22b as pqmoe  # noqa: E402
from repro_torch.configs import zamba2_7b as pzamba  # noqa: E402
from repro_torch.core import LLMCompressor, read_index  # noqa: E402
from repro_torch.core.compressor import (RECIPE_CARRY,  # noqa: E402
                                         RECIPE_SHARED)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import schema  # noqa: E402
from repro_torch.serve.engine import ModelPredictor  # noqa: E402
from repro_torch.service import CompressionService  # noqa: E402
from repro_torch.train.prep import train_predictor  # noqa: E402

CFGS = {"dense": (jbase.tiny_variant(jqwen.CONFIG),
                  pbase.tiny_variant(pqwen.CONFIG)),
        "ssm": (jbase.tiny_variant(jmamba.CONFIG),
                pbase.tiny_variant(pmamba.CONFIG)),
        # 5 SSD layers in groups of 2: a trailing layer, as zamba2-7b has
        "hybrid": (jbase.tiny_variant(jzamba.CONFIG, n_layers=5),
                   pbase.tiny_variant(pzamba.CONFIG, n_layers=5)),
        "moe": (jbase.tiny_variant(jqmoe.CONFIG),
                pbase.tiny_variant(pqmoe.CONFIG))}
FAMILIES = sorted(CFGS)


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(JAX predictor, port predictor) of one family on the same
    weights."""
    jcfg, pcfg = CFGS[request.param]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    pnp = jax.tree_util.tree_map(
        np.asarray, jschema.init_params(jcfg, jax.random.PRNGKey(5)))
    return (JaxPredictor(pnp, jcfg),
            ModelPredictor(schema.from_jax(pnp), pcfg, device="cpu"))


@pytest.fixture(scope="module", params=FAMILIES)
def pred(request):
    return ModelPredictor.random_init(CFGS[request.param][1], seed=0,
                                      device="cpu")


def _steps(pred, state, toks):
    """Feed toks (B, n) one column a step: (logits (B, n, V), state)."""
    out = []
    for t in range(toks.shape[1]):
        lg, state = pred.decode_step(state, toks[:, t])
        out.append(lg.clone())
    return (torch.stack(out, 1) if out else None), state


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape)


# ------------------------------------------------------ verify / rollback
def test_verify_steps_equal_decode_steps_and_jax(pair):
    jpred, ppred = pair
    B, T = 3, 5
    for p in pair:
        p.set_decode_len(24)
    warm = _tokens((B, 4), 1)
    seq = _tokens((B, T), 2)
    ps = _steps(ppred, ppred.begin_decode(B), warm)[1]
    lg, _ = ppred.verify_steps(ps, seq)
    want = _steps(ppred, _steps(ppred, ppred.begin_decode(B), warm)[1],
                  seq)[0]
    assert lg.shape == (B, T, ppred.vocab_size)
    assert torch.equal(lg, want)
    js = jpred.begin_decode(B)
    for t in range(warm.shape[1]):
        _, js = jpred.decode_step(js, warm[:, t].astype(np.int32))
    jl, _ = jpred.verify_steps(js, seq.astype(np.int32))
    np.testing.assert_allclose(lg.numpy(), jl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("acc", [[0, 2, 5], [5, 1, 0], [3, 3, 3]])
def test_rollback_then_decode_equals_lockstep(pred, acc):
    """Lane b keeps acc[b] of the verify inputs and decodes on: its logits
    equal those of a cache that took only those inputs, bit for bit."""
    B, T = 3, 5
    pred.set_decode_len(24)
    warm, seq, after = _tokens((B, 3), 3), _tokens((B, T), 4), \
        _tokens((B, 4), 5)
    state = _steps(pred, pred.begin_decode(B), warm)[1]
    _, snaps = pred.verify_steps(state, seq)
    state = pred.rollback(snaps, np.array(acc, np.int32))
    got = _steps(pred, state, after)[0]
    for b, a in enumerate(acc):
        ref = _steps(pred, pred.begin_decode(B), warm)[1]
        ref = _steps(pred, ref, seq[:, :a])[1]
        want = _steps(pred, ref, after)[0]
        assert torch.equal(got[b], want[b]), b


def test_rollback_refuses_counts_outside_the_round(pred):
    pred.set_decode_len(8)
    state = pred.begin_decode(2)
    _, snaps = pred.verify_steps(state, _tokens((2, 3), 6))
    for bad in ([0, 4], [-1, 0], [1, 1, 1]):
        with pytest.raises(ValueError, match="rollback"):
            pred.rollback(snaps, np.array(bad))


# ---------------------------------------------- prefill, snapshot, restore
def test_prefill_matches_sequential_decode_bit_exact(pred):
    pred.set_decode_len(48)
    prefix = np.array([[3, 1, 4, 1, 5, 9, 2, 6],
                       [2, 7, 1, 8, 2, 8, 1, 8]])
    cont = np.array([[5, 3, 5], [9, 7, 9]])
    inp = np.concatenate([np.full((2, 1), pred.bos_id), prefix], 1)
    state = _steps(pred, pred.begin_decode(2), inp[:, :-1])[1]
    ref = _steps(pred, state, np.concatenate([prefix[:, -1:], cont[:, :-1]],
                                             1))[0]
    state2 = pred.begin_decode(2, prefix=prefix)
    got = _steps(pred, state2, np.concatenate([prefix[:, -1:],
                                               cont[:, :-1]], 1))[0]
    assert torch.equal(got, ref)
    state3 = pred.begin_decode(2, prefix=prefix[0])      # 1-D broadcasts
    lg, _ = pred.decode_step(state3, np.repeat(prefix[0, -1], 2))
    assert torch.equal(lg[0], lg[1])


def test_snapshot_restore_slot_bit_exact(pred):
    """A lane snapshot taken after prefill, restored into another decode
    state, continues with bit-identical logits; the other lane keeps its
    own state."""
    pred.set_decode_len(32)
    prefix = np.array([7, 3, 7, 3, 7, 1])
    sA = pred.begin_decode(2, prefix=prefix)
    snap = pred.snapshot_slot(sA, 1)
    ref = pred.decode_step(sA, np.repeat(prefix[-1], 2))[0].clone()
    sB = _steps(pred, pred.begin_decode(2), np.array([[9, 4, 4]] * 2))[1]
    sB = pred.reset_slots(sB, np.array([True, True]))
    sB = _steps(pred, sB, np.array([[8], [8]]))[1]
    keep = {k: v[..., 1].clone() if k == "pos" else v[:, 1].clone()
            for k, v in sB.items()}
    sB = pred.restore_slot(sB, snap, np.array([True, False]))
    for k, v in sB.items():
        assert torch.equal(v[1] if k == "pos" else v[:, 1], keep[k]), k
    got, _ = pred.decode_step(sB, np.repeat(prefix[-1], 2))
    assert torch.equal(got[0], ref[1])


def test_engine_calls_keep_every_leaf_in_its_storage(pred):
    """decode_step, prefill, reset_slots, restore_slot, verify_steps and
    rollback write the cache in place: a captured step on the card reads
    the storage it was captured over."""
    pred.set_decode_len(16)
    state = pred.begin_decode(3, prefix=np.array([4, 5, 6]))
    ptrs = {k: v.untyped_storage().data_ptr() for k, v in state.items()}
    ids = {k: id(v) for k, v in state.items()}
    calls = [
        lambda s: pred.decode_step(s, np.array([1, 2, 3]))[1],
        lambda s: pred.reset_slots(s, np.array([True, False, True])),
        lambda s: pred.restore_slot(s, pred.snapshot_slot(s, 1),
                                    np.array([True, False, False])),
        lambda s: pred.rollback(pred.verify_steps(s, _tokens((3, 4), 7))[1],
                                np.array([0, 2, 4])),
    ]
    for call in calls:
        out = call(state)
        assert out is state
        assert {k: v.untyped_storage().data_ptr()
                for k, v in state.items()} == ptrs
        assert {k: id(v) for k, v in state.items()} == ids


# ----------------------------------------------------------- the service
def _text(n, seed, domain="wiki"):
    from repro_torch.data.tokenizer import encode
    return encode(synthetic.human_like(domain, n, seed=seed))


def _comp(pred, **kw):
    return LLMCompressor(pred, chunk_size=16, topk=8, decode_batch=4, **kw)


def test_service_shared_prefix_jobs_hit_cache_and_roundtrip(pred):
    """Shared-prefix jobs through the scheduler: later slots restore the
    cached post-prefill lane instead of prefilling again (hits > 0, fewer
    prefill steps than a cache-off run), every archive round-trips, the
    cache changes no byte, and the service takes the next job."""
    sp = _text(20, seed=41)
    jobs = [_text(48, seed=50 + i) for i in range(4)]

    def run(cache_on):
        svc = CompressionService(pred, slots=4, chunk_size=16, topk=8,
                                 device="cpu")
        if not cache_on:
            svc.scheduler.prefix_cache = None
        handles = [svc.submit_compress(t, shared_prefix=sp) for t in jobs]
        return svc, [h.result()[0] for h in handles]

    svc_on, blobs_on = run(True)
    svc_off, blobs_off = run(False)
    assert blobs_on == blobs_off
    for blob, toks in zip(blobs_on, jobs):
        assert all(e.recipe_kind == RECIPE_SHARED
                   for e in read_index(blob).entries)
        assert np.array_equal(_comp(pred).decompress(blob), toks)
        assert np.array_equal(svc_on.submit_decompress(blob).result(), toks)
    on, off = svc_on.registry.snapshot(), svc_off.registry.snapshot()
    assert on["prefix_cache.hits"]["value"] >= 1
    assert on["scheduler.prefill_steps"]["value"] < \
        off["scheduler.prefill_steps"]["value"]
    plain = jobs[0]
    blob, _ = svc_on.submit_compress(plain).result()
    assert np.array_equal(svc_on.submit_decompress(blob).result(), plain)


def test_service_carried_compress_matches_grouped_bytes(pred):
    toks = _text(90, seed=61)
    svc = CompressionService(pred, slots=4, chunk_size=16, topk=8,
                             device="cpu")
    blob_svc, _ = svc.submit_compress(toks, context_window=6).result()
    assert RECIPE_CARRY in {e.recipe_kind for e in read_index(
        blob_svc).entries}
    blob_ref, _ = _comp(pred, context_window=6, context_stripes=4).compress(
        toks)
    assert blob_svc == blob_ref
    assert np.array_equal(_comp(pred).decompress(blob_svc), toks)


# ---------------------------------------------------------------- the CLI
def test_cli_context_and_draft_flags(tmp_path, capsys, monkeypatch):
    # pred-* predictors are trained at first use: a short recipe put in a
    # cache of the test's own, which the CLI loads
    cache = tmp_path / "cache"
    monkeypatch.setenv("REPRO_TORCH_CACHE", str(cache))
    train_predictor("pred-tiny", steps=3, device="cpu", cache_dir=cache)
    data = synthetic.human_like("wiki", 260, seed=9)
    src, pref = tmp_path / "in.txt", tmp_path / "p.txt"
    src.write_bytes(data)
    pref.write_bytes(b"A shared header of the corpus.")
    arc, out = tmp_path / "a.llmc", tmp_path / "out.txt"
    model = ["--predictor", "pred-tiny", "--device", "cpu"]
    assert cli_main(["compress", str(src), str(arc), "--chunk", "32",
                     "--slots", "4", "--topk", "8", "--context-window",
                     "8", "--shared-prefix", str(pref)] + model) == 0
    assert cli_main(["info", str(arc)]) == 0
    shown = capsys.readouterr().out
    assert "LLMC v6" in shown and "carry(8)" in shown
    assert "shared prefix [0]:" in shown and "30 tokens" in shown
    for extra in (["--draft", "3"], []):
        out.unlink(missing_ok=True)
        assert cli_main(["decompress", str(arc), str(out)] + model
                        + extra) == 0
        assert out.read_bytes() == data


def test_cli_context_flags_reject_the_ac_path(tmp_path):
    src, pref = tmp_path / "in.txt", tmp_path / "p.txt"
    src.write_bytes(b"some text " * 8)
    pref.write_bytes(b"pp")
    model = ["--predictor", "pred-tiny", "--device", "cpu"]
    for flags in (["--context-window", "4"], ["--shared-prefix", str(pref)]):
        with pytest.raises(SystemExit, match="context"):
            cli_main(["compress", str(src), str(tmp_path / "a.llmc"),
                      "--codec", "ac"] + flags + model)
