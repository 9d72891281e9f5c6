"""Trained predictors and LLM-generated corpora (the port's copy of the
recipe in the JAX package's ``benchmarks/prep.py``).

``train_predictor`` trains a ``pred-*`` predictor on a 1 MiB mix of the
eight ``human_like`` domains (16 x 192 token windows, AdamW at 3e-3 with
20 warm-up steps, ``TRAIN_STEPS`` steps) and keeps the weights as a
checkpoint in the cache; ``predictor`` wraps them in a ``ModelPredictor``;
``llm_dataset`` samples the paper's "LLM-generated" text from the trained
``pred-base`` and caches it.

The cache is ``results/torch_cache/`` in the checkout (``$REPRO_TORCH_CACHE``
overrides it; an installed package uses the temporary directory). A
process that finds a predictor's checkpoint loads it and never trains
again: training on the card is not bit-reproducible (the embedding's
backward adds with atomics), so weights trained twice would write
archives that the other copy cannot decode. Processes that reach a
missing predictor together take turns on a lock file beside its
checkpoint: one trains and saves, the others wait and load, and every
process (the one that trained too) codes with the weights read back from
the checkpoint. Moving the cache moves the predictors; deleting it means
training anew, and archives written with the old weights no longer
decode.

``train_predictor(steps=...)`` shortens the recipe (a quick, weaker
predictor, for tests and CPU trials) and keeps it under the predictor's
own name: give it a cache of its own. The seed expression of
``llm_dataset`` uses ``hash(domain)`` as the JAX recipe does: run with
``PYTHONHASHSEED=0`` for the same text in every process.
"""
from __future__ import annotations

import fcntl
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.registry import PREDICTORS as CONFIGS
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.synthetic import human_like
from repro_torch.data.tokenizer import BOS_ID, encode
from repro_torch.device import resolve_device
from repro_torch.serve.engine import ModelPredictor
from .checkpoint import restore_latest, save_checkpoint
from .optimizer import AdamWConfig, tree_leaves, tree_map
from .train_loop import init_train_state, make_train_step

TRAIN_STEPS = {"pred-tiny": 260, "pred-small": 260, "pred-base": 220,
               "pred-large": 160}
DOMAINS = ("wiki", "code", "math", "clinical", "web", "science", "novel",
           "article")
BATCH, SEQ_LEN = 16, 192
CORPUS_BYTES = 1 << 20


def _log(msg: str) -> None:
    obs.log(msg)


def default_cache_dir() -> pathlib.Path:
    """``$REPRO_TORCH_CACHE`` if set, else ``results/torch_cache`` in the
    checkout that holds this package, else a directory in the temporary
    directory."""
    env = os.environ.get("REPRO_TORCH_CACHE")
    if env:
        return pathlib.Path(env)
    pkg = pathlib.Path(__file__).resolve().parents[1]
    root = pkg.parents[1]
    if pkg.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "results" / "torch_cache"
    return pathlib.Path(tempfile.gettempdir()) / "repro_torch-cache"


def checkpoint_dir(name: str, seed: int = 0, cache_dir=None) -> pathlib.Path:
    return pathlib.Path(cache_dir or default_cache_dir()) / f"{name}-s{seed}"


def corpus_pipeline(seed: int = 0):
    """The recipe's training batches: a ``TokenPipeline`` of 16 x 193
    token windows over the mixed-domain corpus."""
    corpus = b"".join(
        human_like(d, CORPUS_BYTES // len(DOMAINS), seed=seed + i)
        for i, d in enumerate(DOMAINS))
    return TokenPipeline(encode(corpus), global_batch=BATCH,
                         seq_len=SEQ_LEN, seed=seed)


def _same(a: dict, b: dict) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def train_predictor(name: str, *, steps=None, seed: int = 0, device=None,
                    cache_dir=None, log=_log):
    """(params, cfg) of predictor ``name`` trained from ``seed`` on
    ``device`` (the card unless the caller asks for the CPU): loaded from
    its checkpoint when the cache holds one, else trained, saved and read
    back. The checkpoint holds the parameters and the loss of every
    step; ``steps`` defaults to the recipe's ``TRAIN_STEPS``."""
    cfg = CONFIGS[name]
    dev = resolve_device(device)
    steps = steps or TRAIN_STEPS[name]
    ckpt = checkpoint_dir(name, seed, cache_dir)
    opt = AdamWConfig(learning_rate=3e-3, warmup_steps=20, total_steps=steps)
    params, opt_state = init_train_state(cfg, seed, dev, opt)
    like = {"params": params, "losses": torch.zeros(steps)}
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    with open(ckpt.parent / f"{ckpt.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when the file closes
        restored, step = restore_latest(ckpt, like)
        if restored is not None:
            log(f"[{name}] loaded {ckpt} (step {step})")
            return restored["params"], cfg
        log(f"[{name}] training {steps} steps on {dev} into {ckpt}")
        pipe = corpus_pipeline(seed)
        step_fn = make_train_step(cfg, opt=opt)
        losses = []
        t0 = time.perf_counter()
        for s in range(steps):
            batch = {"tokens": pipe.global_batch_array(s)}
            params, opt_state, m = step_fn(params, opt_state, batch)
            losses.append(m["loss"])
            if s % 50 == 0:
                log(f"  [{name}] step {s} loss {float(m['loss']):.3f} "
                    f"({time.perf_counter() - t0:.1f}s)")
        losses = torch.stack(losses).float().cpu()
        save_checkpoint(ckpt, steps, {"params": params, "losses": losses})
        restored, _ = restore_latest(ckpt, like)
    if restored is None or not _same(restored["params"], params):
        raise RuntimeError(f"{ckpt}: the saved checkpoint does not read "
                           f"back as the trained weights")
    log(f"  [{name}] trained {steps} steps, final loss "
        f"{float(losses[-1]):.3f} in {time.perf_counter() - t0:.1f}s")
    return restored["params"], cfg


def predictor(name: str, *, seed: int = 0, device=None, cache_dir=None,
              log=_log):
    """The trained ``ModelPredictor`` of ``name`` (cached; see
    ``train_predictor``), on detached copies of the weights."""
    params, cfg = train_predictor(name, seed=seed, device=device,
                                  cache_dir=cache_dir, log=log)
    return ModelPredictor(tree_map(lambda p: p.detach().clone(), params),
                          cfg, bos_id=BOS_ID, device=device)


def llm_dataset(domain: str, n_bytes: int = 6144, *,
                gen_model: str = "pred-base", temperature: float = 0.55,
                seed: int = 0, doc_len: int = 384, device=None,
                cache_dir=None) -> bytes:
    """Cached "LLM-generated" text: the trained ``gen_model`` continues a
    distinct 128-byte ``human_like`` prompt per document of ``doc_len``
    bytes, at ``temperature``, over the 256 byte ids; the corpus is the
    documents' prompts and continuations, cut to ``n_bytes``. As in the
    JAX recipe, temperature 0.55 puts a predictor this small in the
    predictability regime of the paper's generators, and independent
    documents keep one long stream from drifting off-distribution."""
    root = pathlib.Path(cache_dir or default_cache_dir())
    path = root / (f"gen3-{gen_model}-{domain}-{n_bytes}-t{temperature}"
                   f"-d{doc_len}-s{seed}.bin")
    if path.exists():
        return path.read_bytes()
    pred = predictor(gen_model, seed=0, device=device, cache_dir=root)
    n_docs = -(-n_bytes // doc_len)
    plen = 128
    prompts = np.stack([encode(human_like(domain, plen, seed=seed + 77 + i))
                        for i in range(n_docs)])
    toks = pred.generate(doc_len - plen, batch=n_docs,
                         temperature=temperature,
                         seed=seed + hash(domain) % 1000, prompt=prompts,
                         vocab_limit=256)
    docs = np.concatenate([prompts, toks], axis=1)
    data = docs.ravel().astype(np.uint8).tobytes()[:n_bytes]
    root.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)
    return data
