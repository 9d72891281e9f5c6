"""A one-minute check of the captured decode programs on a card.

    PYTHONPATH=src python -m repro_torch.serve.graph_probe [ARCH ...]

For each config (default ``qwen3-1.7b``, ``mamba2-130m`` and
``zamba2-7b``; any name of ``configs/registry.py``, such as
``h2o-danube-3-4b``, ``deepseek-7b`` or ``qwen3-14b``; random weights
from seed 0, 16 lanes, a 128-position cache; each model freed before
the next): the first step's
time (its capture and eager warm-up included), 8 replays held against 8
eager steps on a twin cache bit for bit, the host ms per step of the
eager and the captured step (a host clock around 20 steps ending in a
synchronise), the first verify program's capture (T = 5), and the host
ms of a verify round with its rollback. ``chip_smoke.py`` measures the
same and more at full length; this is its quick form. A zamba2-7b
step replays 6 ``decode_attention`` launches (one per application of
its shared block) among its SSD layers' elementwise kernels.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.registry import get_config
from repro_torch.kernels import build
from repro_torch.serve import graphs
from repro_torch.serve.engine import ModelPredictor


def _host_ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def probe(arch: str, B: int = 16, S: int = 128) -> None:
    pred = ModelPredictor.random_init(get_config(arch), seed=0,
                                      device="cuda")
    pred.set_decode_len(S)
    rng = np.random.default_rng(0)
    graphs.reset_stats()
    t0 = time.perf_counter()
    pred.decode_step(pred.begin_decode(B), rng.integers(0, 1000, B))
    torch.cuda.synchronize()
    obs.console(f"{arch} first step (capture) "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms {graphs.STATS}")
    g, e = pred.begin_decode(B), pred._init_cache(B, S)
    same = True
    for _ in range(8):
        prev = rng.integers(0, 1000, B)
        lg, _ = pred.decode_step(g, prev)
        le, _ = pred._eager_decode_step(e, prev)
        same &= torch.equal(lg, le) and all(torch.equal(g[k], e[k])
                                            for k in g)
    obs.console(f"{arch} captured == eager over 8 steps: {same}")
    prev = rng.integers(0, 1000, B)
    for name, fn in (("eager", lambda: pred._eager_decode_step(e, prev)),
                     ("captured", lambda: pred.decode_step(g, prev))):
        obs.console(f"{arch} {name} host ms/step {_host_ms(fn):.3f}")
    seq = rng.integers(0, 1000, (B, 5))
    t0 = time.perf_counter()
    pred.verify_steps(g, seq)
    torch.cuda.synchronize()
    obs.console(f"{arch} verify (T=5) capture "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    def round_():
        pred.rollback(pred.verify_steps(g, seq)[1], np.zeros(B, np.int64))
    obs.console(f"{arch} verify + rollback host ms "
                f"{_host_ms(round_, 10):.3f}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        obs.console("graph_probe: no CUDA device", err=True)
        return 2
    obs.console(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip())
    build.build_all()
    for arch in argv or ["qwen3-1.7b", "mamba2-130m", "zamba2-7b"]:
        probe(arch)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
