"""The training driver, with fault tolerance (the JAX package's
``launch/train.py``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --steps 200 --ckpt-dir CKPT [--mesh D,M --backend nccl|gloo] \
      [--smoke] [--device cpu]

Behaviour:
  * on the card unless ``--device cpu`` is given; a mesh of more than one
    rank (``--mesh data,model``) runs one process a rank through
    ``launch.mesh.run_ranks`` over the backend named by ``--backend``
    (``nccl``: a card a rank; ``gloo``: ranks sharing a card, or the
    CPU). Nothing falls back to another device or backend;
  * ``--arch NAME`` takes the registry's config (``--smoke``: its reduced
    same-family config); ``NAME@L`` cuts its depth to L layers at full
    width. Every family but encdec trains, on one device or a mesh (vlm
    on its text alone, as the JAX driver feeds it); encdec is refused
    before anything starts: the token pipeline makes no ``frames``;
  * auto-resume from the newest sound checkpoint (corrupt ones skipped),
    onto any mesh shape (elastic: the checkpoint holds the global
    leaves, each rank cuts its own);
  * a checkpoint every ``--ckpt-every`` steps and at the end, atomic,
    with retention;
  * the data pipeline's cursor lives inside the checkpoint, so a restart
    reproduces the exact batch sequence (bitwise resume:
    ``tests/test_torch_launch_train.py``);
  * ``--crash-at N`` (fault injection) logs ``train.fault_injection`` and
    hard-exits rank 0 (code 42) after step N; ``run_ranks`` then ends the
    other ranks and raises;
  * ``--watchdog`` respawns the trainer (``python -m
    repro_torch.launch.train`` without ``--crash-at``) until it exits 0,
    at most ``--max-restarts`` times, each restart resuming from the
    newest checkpoint.

The stdout contract is the JAX driver's: rank 0 logs ``train.step``,
``train.resume``, ``train.fault_injection`` and ``train.done`` through
``repro_torch.obs`` on stdout (``train.step`` also carries the step's
host ms and, on a mesh, its collectives; ``train.checkpoint`` and
``train.resume`` their seconds; ``train.done`` the device's peak
memory). The synthetic corpus seeds with ``hash(domain)``, so the
driver runs with ``PYTHONHASHSEED`` 0 unless the caller set one: a
restart then trains on the same corpus.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch import obs

AXES = ("data", "model")


def config_of(args):
    """The config ``--arch`` names (``NAME@L``: cut to L layers),
    reduced by ``--smoke``."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    name, _, depth = args.arch.partition("@")
    cfg = get_smoke_config(name) if args.smoke else get_config(name)
    return cfg.with_(n_layers=int(depth)) if depth else cfg


def mesh_shape(args) -> tuple:
    if not args.mesh:
        return (1, 1)
    shape = tuple(int(x) for x in args.mesh.split(","))
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"--mesh {args.mesh!r}: data,model (e.g. 2,2)")
    return shape


def train_main(args) -> int:
    from repro_torch.data.synthetic import human_like
    from repro_torch.data.tokenizer import encode
    from repro_torch.launch.mesh import check_backend, run_ranks
    shape = mesh_shape(args)
    if config_of(args).family == "encdec":
        # JAX's driver raises a KeyError on batch["frames"] here
        raise ValueError(
            f"{args.arch}: the encdec family trains on frames (B, S_enc, "
            f"D) beside the tokens, and the driver's token pipeline makes "
            f"no frames; train it through train_loop.make_train_step with "
            f"batch['frames']")
    if shape != (1, 1):
        check_backend(args.backend, args.device, shape[0] * shape[1])
    elif torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the trainer runs "
                           "on the card unless --device cpu is given")
    # made here, once: every rank trains on the same corpus
    corpus = encode(human_like("wiki", args.corpus_bytes, seed=1))
    if shape == (1, 1):
        train_rank(None, vars(args), corpus)
        return 0
    run_ranks(train_rank, shape, AXES, backend=args.backend,
              device=args.device, args=(vars(args), corpus),
              timeout=args.timeout)
    return 0


def _state(params, opt_state, step: int) -> dict:
    return {"params": params, "opt": opt_state,
            "pipe": {"step": np.asarray(step, np.int64)}}


def train_rank(mesh, opts: dict, corpus) -> dict:
    """One rank's training loop (``mesh`` None: one device). Returns the
    last step's metrics."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.train.checkpoint import restore_latest
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (init_train_state,
                                              make_train_step, state_specs)
    args = argparse.Namespace(**opts)
    lead = mesh is None or mesh.rank == 0
    if lead:
        obs.configure(stream=sys.stdout)
    device = torch.device(args.device) if mesh is None else mesh.device
    cfg = config_of(args)
    opt = AdamWConfig(learning_rate=args.lr, warmup_steps=20,
                      total_steps=args.steps,
                      grad_compress=args.grad_compress)
    pipe = TokenPipeline(corpus, global_batch=args.batch,
                         seq_len=args.seq_len)
    params, opt_state = init_train_state(cfg, args.seed, device, opt,
                                         mesh=mesh)
    specs = None if mesh is None else state_specs(cfg, mesh, opt)
    start = 0
    if args.ckpt_dir:
        t0 = time.perf_counter()
        restored, step = restore_latest(
            args.ckpt_dir, _state(params, opt_state, 0), mesh=mesh,
            specs=specs)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = int(restored["pipe"]["step"])
            pipe.state.step = start
            if lead:
                obs.log("train.resume", restored=step, continuing=start,
                        seconds=round(time.perf_counter() - t0, 2))
    step_fn = make_train_step(cfg, mesh, opt=opt,
                              num_microbatches=args.microbatches,
                              global_batch=args.batch,
                              loss_block=args.loss_block)
    t0 = t_last = time.perf_counter()
    calls = 0 if mesh is None else mesh.calls
    saved, metrics, done = -1, None, start
    for step in range(start, args.steps):
        batch = {"tokens": pipe.global_batch_array(step)}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        pipe.advance()
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])       # waits for the step
            now = time.perf_counter()
            n = step + 1 - done
            fields = dict(step=step, loss=round(loss, 4),
                          gnorm=round(float(metrics["grad_norm"]), 3),
                          elapsed_s=round(now - t0, 1),
                          step_ms=round((now - t_last) / n * 1e3, 1))
            if mesh is not None:
                fields["collectives"] = (mesh.calls - calls) // n
                calls = mesh.calls
            t_last, done = now, step + 1
            if lead:
                obs.log("train.step", **fields)
        if args.crash_at is not None and step == args.crash_at and lead:
            # StreamHandler flushes per record, so this line survives the
            # hard exit below (os._exit skips interpreter buffers)
            obs.log("train.fault_injection", step=step)
            os._exit(42)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(args, step + 1, params, opt_state, mesh, specs, lead)
            saved = step + 1
            t_last = time.perf_counter()    # a step's ms leaves it out
    if args.ckpt_dir and saved != args.steps and metrics is not None:
        _save(args, args.steps, params, opt_state, mesh, specs, lead)
    final = None if metrics is None else float(metrics["loss"])
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    if lead:
        # kernel launches of this process: training launches none (the
        # kernels have no backward; models.api.TRAIN_FORWARD)
        obs.log("train.done", final_loss=None if final is None
                else round(final, 4),
                peak_gib=None if peak is None else round(peak / 2**30, 3),
                launches=sum(ops.LAUNCHES.values()))
    return {"final_loss": final, "steps": args.steps - start,
            "peak_bytes": peak}


def _save(args, step: int, params, opt_state, mesh, specs,
          lead: bool) -> None:
    from repro_torch.train.checkpoint import save_checkpoint
    t0 = time.perf_counter()
    save_checkpoint(args.ckpt_dir, step, _state(params, opt_state, step),
                    mesh=mesh, specs=specs)
    if lead:
        obs.log("train.checkpoint", step=step,
                seconds=round(time.perf_counter() - t0, 2))


def watchdog(args) -> int:
    """Respawn the trainer until it exits cleanly (node-failure
    recovery)."""
    attempts = 0
    argv = [a for a in sys.argv[1:] if a != "--watchdog"]
    while attempts < args.max_restarts + 1:
        rc = subprocess.call([sys.executable, "-m",
                              "repro_torch.launch.train", *argv])
        if rc == 0:
            return 0
        attempts += 1
        obs.log_error("train.watchdog_restart", rc=rc, restart=attempts)
        # after a crash, never replay the same fault injection
        if "--crash-at" in argv:
            i = argv.index("--crash-at")
            argv = argv[:i] + argv[i + 2:]
        argv = [a for a in argv if not a.startswith("--crash-at=")]
    return 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True,
                    help="a registry name; NAME@L cuts it to L layers")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--loss-block", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus-bytes", type=int, default=1 << 20)
    ap.add_argument("--mesh", default=None, help="data,model e.g. 2,4")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="the ranks' process-group backend (a mesh of "
                         "more than one rank)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--timeout", type=float, default=86400.0,
                    help="seconds before the ranks are ended")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="fault injection: hard-exit at this step")
    ap.add_argument("--watchdog", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=3)
    return ap


def main():
    if os.environ.get("PYTHONHASHSEED") is None:
        # the corpus seeds with hash(domain): one seed in every restart
        os.execve(sys.executable, [sys.executable, "-m",
                                   "repro_torch.launch.train",
                                   *sys.argv[1:]],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    args = parser().parse_args()
    # the trainer's operational log is its stdout contract: the watchdog
    # test greps the child's stdout for train.resume / train.done
    obs.configure(stream=sys.stdout)
    if args.watchdog:
        raise SystemExit(watchdog(args))
    raise SystemExit(train_main(args))


if __name__ == "__main__":
    main()
