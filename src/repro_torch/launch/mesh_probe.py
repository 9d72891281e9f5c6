"""Time a mesh's collectives and decode steps where the ranks run:

    python -m repro_torch.launch.mesh_probe [--ranks 2 8]
        [--step qwen3-14b@8:2 --step zamba2-7b@14:2 ...] [--backend gloo]
        [--device cuda]
        [--iters 50]

For each world size of ``--ranks``, ``run_ranks`` starts the ranks (all
on one card over gloo by default) and each times, after a warm-up, the
mean wall ms of a ``psum`` of a (16, 5120) bf16 tensor (a decode step's
row-parallel product at qwen3-14b's width), an ``all_gather`` of
(16, 8, 33) fp32 (the sequence-sharded combine's payload at pred-base's
width) and a device-to-host synchronisation alone.

Each ``--step NAME[@LAYERS]:TP`` builds that config (random weights from
seed 0, cut to LAYERS layers if given; any family: an encdec model
decodes against its stub frontend's frames, whose cross K/V
``begin_decode`` writes) on a (1, TP) mesh and times a
decode step of 16 lanes with its top-48 CDF moved to the host (what a
coder step waits for): host ms and collectives over a few steps, then, under
``torch.profiler``, the rank's compute kernels' device ms (the gloo
staging copies apart, which include waits for the other ranks' work on
a shared card), their count and the idle share. Rank 0's numbers, one
JSON line each, after the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.launch.mesh import run_ranks
from repro_torch.obs.logs import console


def _collectives(mesh, iters: int) -> dict:
    dev = mesh.device
    x = torch.randn(16, 5120, device=dev).to(torch.bfloat16)
    small = torch.randn(1, 16, 8, 33, device=dev)
    out = {}
    for name, fn in (("psum_bf16_16x5120", lambda: mesh.psum(x.clone(),
                                                            "model")),
                     ("all_gather_f32_16x8x33",
                      lambda: mesh.all_gather(small, "model", dim=0)),
                     ("sync", lambda: x[0, 0].item())):
        for _ in range(5):
            fn()
        mesh.psum(torch.zeros(1, device=dev), "model")     # line up
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out[name] = (time.perf_counter() - t0) / iters * 1e3
    return out


def _config(spec: str):
    from repro_torch.configs.registry import get_config
    name, _, layers = spec.partition("@")
    cfg = get_config(name)
    return cfg.with_(n_layers=int(layers)) if layers else cfg


def _step(mesh, spec: str, iters: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.cdf import to_numpy, topk_cdf
    from repro_torch.serve.engine import ModelPredictor
    pred = ModelPredictor.random_init(_config(spec), seed=0, mesh=mesh)
    pred.set_decode_len(2 * iters + 8)
    state = pred.begin_decode(16)
    prev = np.arange(16, dtype=np.int64) * 37 % pred.vocab_size

    def step():
        lg, _ = pred.decode_step(state, prev)
        to_numpy(topk_cdf(lg, 48, 16)[1])
    for _ in range(2):
        step()
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" \
        else (lambda: None)
    sync()
    calls = mesh.calls
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    sync()
    host = (time.perf_counter() - t0) / iters * 1e3
    calls = (mesh.calls - calls) / iters
    acts = [ProfilerActivity.CUDA] if mesh.device.type == "cuda" \
        else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        for _ in range(iters):
            step()
        sync()
    ev = [e for e in prof.key_averages()
          if e.device_type.name == "CUDA"
          and not getattr(e, "is_user_annotation", False)]
    kernels = [e for e in ev if not e.key.startswith(("Memcpy", "Memset"))]
    kern_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    copy_ms = sum(e.self_device_time_total for e in ev
                  if e.key.startswith("Memcpy")) / 1e3 / iters
    return dict(step=spec, tp=mesh.shape["model"], host_ms=host,
                collectives=calls,
                kernel_ms=kern_ms or None, copy_ms=copy_ms,
                kernels=sum(e.count for e in kernels) / iters,
                idle=1 - kern_ms / host if kern_ms else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="*", default=[2, 8])
    ap.add_argument("--step", action="append", default=[],
                    metavar="NAME[@LAYERS]:TP")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=50)
    a = ap.parse_args(argv)
    if a.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        console(smi)
    for n in a.ranks:
        r = run_ranks(_collectives, (1, n), backend=a.backend,
                      device=a.device, args=(a.iters,), timeout=600)
        console(json.dumps({"ranks": n, "backend": a.backend,
                            "device": a.device, "ms": r}))
    for spec in a.step:
        name, _, tp = spec.rpartition(":")
        r = run_ranks(_step, (1, int(tp)), backend=a.backend,
                      device=a.device, args=(name, max(2, a.iters // 10)),
                      timeout=900)
        console(json.dumps(dict(r, backend=a.backend, device=a.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
