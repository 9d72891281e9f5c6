#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one card

Phases, in order; any failure raises and the script exits non-zero:

1. The card (``nvidia-smi`` name and power limit) and the kernel build:
   every ``src/repro_torch/kernels/csrc/*.cu`` compiled by its own
   ``nvcc``, all at once.
2. Each kernel at the main path's shapes against its plain PyTorch
   version on the same inputs, with its time, the plain version's time,
   a one-call PyTorch yardstick (``library_ms``, never used by the port)
   and its bound on the card (the larger of bytes over 3.35 TB/s and
   operations over the peak rate of their type).
3. The main path at full width: ``qwen3-1.7b`` (28 layers, d=2048,
   V=151936, bf16; random weights from seed 0) through
   ``CompressionService(slots=16, chunk_size=128, topk=48)``: a few
   compress jobs of mixed length, then decompression by another service
   run in another order (so chunks land on other lanes), byte identity
   required. The kernel launch counts are reset just before and read
   just after. Then five bare decode steps under ``torch.profiler``
   (device time and launches per step), and the containers decompressed
   once more by a fresh process that rebuilds the predictor from the
   seed, in a third order: compress and decompress are separate
   processes in the user's flow.
4. ``--topk 0`` (full-vocabulary CDF kernel) round trip at ``pred-base``
   width, counts read the same way.
5. ``python -m repro_torch.cli compress`` / ``decompress`` on a small
   file, and a byte comparison.
6. One JSON line describing every kernel, then the result line
   ``{"ok": true, "device": {...}}`` as the last line of stdout.

It exits non-zero, printing no result, without a CUDA device or outside
a checkout of the repository. Built libraries go to ``build/``.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
FP32_FLOPS = 67e12                  # fp32 outside the tensor cores
SOURCES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:67"),
    "topk_cdf": ("src/repro_torch/kernels/csrc/topk_cdf.cu",
                 "src/repro/kernels/ac_cdf.py:187"),
    "cdf_points": ("src/repro_torch/kernels/csrc/cdf_points.cu",
                   "src/repro/kernels/ac_cdf.py:92"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int = 50) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters``
    calls after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ----------------------------------------------------------- phase 2
def check_attention(shape, dtype, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B, H, K, hd, S = shape
    dev = "cuda"
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    kc = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
    vc = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    out = ops.decode_attention(q, kc, vc, lengths)
    want = ref.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs().max().item()
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    if not err <= tol:
        fail(f"decode_attention {shape} {dtype}: max err {err} > {tol}")
    # yardstick: one SDPA call over the same cache (GQA, padding mask)
    q4 = q[:, :, None, :]
    k4, v4 = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True))
    ms = time_ms(lambda: ops.decode_attention(q, kc, vc, lengths))
    plain_ms = time_ms(lambda: ref.decode_attention(q, kc, vc, lengths))
    el = q.element_size()
    live = int(lengths.sum().item())
    nbytes = 2 * B * H * hd * el + 2 * live * K * hd * el + B * 4
    flops = 4.0 * live * H * hd
    b_ms, b_by = bound(nbytes, flops)
    return dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def _logits(R, V, dtype, gen, padded=None):
    """(R, V) logits laid out as the main path hands them over: a view of
    the first V columns of (R, padded) logits when the vocab is padded."""
    import torch
    full = torch.randn((R, padded or V), generator=gen, device="cuda")
    return full.to(dtype)[:, :V]


def check_topk(R, V, dtype, gen, k=48, precision=16, padded=None):
    import torch
    from repro_torch.kernels import ops, ref
    x = _logits(R, V, dtype, gen, padded)
    ids, cdf = ops.topk_cdf(x, k, precision)
    ids_r, cdf_r = ref.topk_cdf(x, k, precision)
    torch.cuda.synchronize()
    if not torch.equal(ids, ids_r):
        fail(f"topk_cdf ({R},{V}) {dtype}: ids differ from plain version")
    err = (cdf - cdf_r).abs().max().item()
    if err > 1 or not bool((cdf[:, 0] == 0).all()) \
            or not bool((cdf[:, -1] == 1 << precision).all()) \
            or not bool((cdf.diff(dim=-1) >= 1).all()):
        fail(f"topk_cdf ({R},{V}): cdf err {err} quanta or invariants")
    ms = time_ms(lambda: ops.topk_cdf(x, k, precision))
    plain_ms = time_ms(lambda: ref.topk_cdf(x, k, precision), 10)
    lib_ms = time_ms(lambda: torch.topk(torch.softmax(x.float(), dim=-1),
                                        k, dim=-1))
    nbytes = R * V * x.element_size() + R * k * 4 + R * (k + 2) * 4
    b_ms, b_by = bound(nbytes, 4.0 * R * V)
    return dict(max_abs_err=float(err), tol=1, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def check_cdf_points(R, V, dtype, gen, precision, padded=None):
    import torch
    from repro_torch.kernels import ops, ref
    x = _logits(R, V, dtype, gen, padded)
    pts = ops.cdf_points(x, precision)
    pts_r = ref.cdf_points(x, precision)
    torch.cuda.synchronize()
    err = (pts - pts_r).abs().max().item()
    if err > 1 or not bool((pts[:, -1] == 1 << precision).all()) \
            or not bool((pts.diff(dim=-1) >= 1).all()) \
            or not bool((pts[:, 0] >= 1).all()):
        fail(f"cdf_points ({R},{V}): err {err} quanta or invariants")
    ms = time_ms(lambda: ops.cdf_points(x, precision))
    plain_ms = time_ms(lambda: ref.cdf_points(x, precision))
    lib_ms = time_ms(lambda: torch.cumsum(torch.softmax(x.float(), dim=-1),
                                          dim=-1))
    nbytes = R * V * x.element_size() + R * V * 4
    b_ms, b_by = bound(nbytes, 4.0 * R * V)
    return dict(max_abs_err=float(err), tol=1, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def phase_kernels(gen) -> dict:
    import torch
    from repro_torch.configs.paper_predictors import PRED_BASE
    from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN
    res = {}
    S = 128                                   # chunk 128, no context
    for name, fn, args in [
        ("decode_attention", check_attention,
         ((16, QWEN.n_heads, QWEN.n_kv_heads, QWEN.head_dim, S),
          torch.bfloat16, gen)),
        ("decode_attention@pred-base", check_attention,
         ((16, PRED_BASE.n_heads, PRED_BASE.padded_kv_heads,
           PRED_BASE.head_dim, S), torch.float32, gen)),
        ("topk_cdf", check_topk,
         (16, QWEN.vocab_size, torch.bfloat16, gen, 48, 16,
          QWEN.padded_vocab)),
        ("topk_cdf@pred-base", check_topk,
         (16, PRED_BASE.vocab_size, torch.float32, gen)),
        ("cdf_points", check_cdf_points,
         (16, QWEN.vocab_size, torch.bfloat16, gen, 18, QWEN.padded_vocab)),
        ("cdf_points@pred-base", check_cdf_points,
         (16, PRED_BASE.vocab_size, torch.float32, gen, 16)),
    ]:
        r = fn(*args)
        res[name] = r
        log(f"[kernel] {name}: max_err {r['max_abs_err']:.3g} (tol "
            f"{r['tol']}) kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return res


# ----------------------------------------------------------- phase 3
def phase_service(gen) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN
    from repro_torch.data.synthetic import human_like
    from repro_torch.data.tokenizer import encode
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ModelPredictor
    from repro_torch.service import CompressionService
    t0 = time.perf_counter()
    pred = ModelPredictor.random_init(QWEN, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[service] qwen3-1.7b random init (seed 0, bf16): "
        f"{sum(t.numel() for t in _leaves(pred.params)) / 1e9:.3f} B "
        f"params in {time.perf_counter() - t0:.1f} s")

    # cuBLAS + kernels at a fixed batch: a lane's logits must not depend
    # on which lane it is. Permute the lanes of one decode step.
    B = 16
    pred.set_decode_len(128)
    toks = np.arange(B, dtype=np.int64) * 37 % QWEN.vocab_size
    perm = np.roll(np.arange(B), 5)
    la, _ = pred.decode_step(pred.begin_decode(B), toks)
    lb, _ = pred.decode_step(pred.begin_decode(B), toks[perm])
    if not torch.equal(la[torch.as_tensor(perm, device="cuda")], lb):
        fail("decode-step logits change with the lane a sequence runs on")
    log("[service] lane permutation: decode-step logits bit-identical")

    svc = CompressionService(pred, slots=16, chunk_size=128, topk=48)
    sizes = [(d, n, s) for d, n, s in (("wiki", 3000, 1), ("code", 2200, 2),
                                        ("web", 4000, 3), ("math", 2600, 4))]
    texts = [human_like(d, n, seed=s) for d, n, s in sizes]
    n_tok = sum(len(t) for t in texts)
    ops.reset_launches()
    steps0 = svc.stats.model_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [svc.submit_compress(encode(t)) for t in texts]
    blobs = [h.result()[0] for h in handles]
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    steps_c = svc.stats.model_steps - steps0
    # decompress in another service run, other jobs first: other lanes
    order = [2, 0, 3, 1]
    svc = CompressionService(pred, slots=16, chunk_size=128, topk=48)
    t0 = time.perf_counter()
    handles = {i: svc.submit_decompress(blobs[i]) for i in order}
    outs = {i: handles[i].result() for i in order}
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    steps_d = svc.stats.model_steps
    launches = dict(ops.LAUNCHES)
    for i, t in enumerate(texts):
        if not np.array_equal(outs[i], encode(t)):
            fail(f"service round trip: job {i} differs after decompress")
    for k in ("decode_attention", "topk_cdf"):
        if launches[k] <= 0:
            fail(f"main path launched {k} {launches[k]} times")
    if launches["decode_attention"] != QWEN.n_layers * (steps_c + steps_d):
        fail(f"decode_attention launches {launches['decode_attention']} != "
             f"{QWEN.n_layers} x {steps_c + steps_d} steps")

    # decode step alone at 16 lanes, then under torch.profiler
    state = pred.begin_decode(B)
    prev = np.zeros(B, np.int64)
    for _ in range(3):
        _, state = pred.decode_step(state, prev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 20
    for _ in range(n):
        _, state = pred.decode_step(state, prev)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    prof = profile_steps(pred, state, prev)
    out = dict(tokens=n_tok, bytes_in=n_tok,
               bytes_out=sum(len(b) for b in blobs),
               compress_s=t_c, decompress_s=t_d,
               compress_tok_s=n_tok / t_c, decompress_tok_s=n_tok / t_d,
               compress_steps=steps_c, decompress_steps=steps_d,
               service_step_ms=(t_c + t_d) / (steps_c + steps_d) * 1e3,
               decode_step_ms=step_ms, launches=launches, **prof)
    log(f"[service] {len(texts)} jobs, {n_tok} tokens: compress "
        f"{t_c:.2f} s ({n_tok / t_c:.0f} tok/s, {steps_c} steps), "
        f"decompress {t_d:.2f} s ({n_tok / t_d:.0f} tok/s, {steps_d} steps)"
        f", {out['bytes_out']} container bytes; byte-identical in reorder "
        f"{order}")
    log(f"[service] mean service step {out['service_step_ms']:.2f} ms; "
        f"decode_step alone (B=16) {step_ms:.2f} ms, of it on the device "
        f"{prof['device_ms_per_step']:.3f} ms (idle "
        f"{1 - prof['device_ms_per_step'] / step_ms:.1%}), "
        f"{prof['launches_per_step']:.0f} kernel launches per step; "
        f"launches {launches}")
    del pred, svc, state
    torch.cuda.empty_cache()

    # the user's flow: decompression in a process of its own, which
    # builds the predictor from the seed again, jobs in a third order
    work = ROOT / "build" / "chip_smoke" / "full_width"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for i, b in enumerate(blobs):
        (work / f"job{i}.llmc").write_bytes(b)
    order = [1, 3, 0, 2]
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke"
         ".decompress_in_fresh_process(sys.argv[1], sys.argv[2:]))",
         str(work), *map(str, order)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"fresh-process decompression exited {r.returncode}:\n"
             f"{r.stdout}\n{r.stderr}")
    for i, t in enumerate(texts):
        if not np.array_equal(np.load(work / f"job{i}.npy"), encode(t)):
            fail(f"fresh-process decompression: job {i} differs")
    log(f"[service] decompressed again in a fresh process (seed 0 re-init, "
        f"order {order}): byte-identical "
        f"({time.perf_counter() - t0:.1f} s with start-up)")
    return out


def profile_steps(pred, state, prev, n: int = 5) -> dict:
    """torch.profiler over ``n`` decode steps: the operators by device
    time, device ms and kernel launches per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            _, state = pred.decode_step(state, prev)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    log(ka.table(sort_by="self_cuda_time_total", row_limit=20))
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA)
    n_launch = sum(e.count for e in ka
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    return dict(device_ms_per_step=dev_us / 1e3 / n,
                launches_per_step=n_launch / n)


def decompress_in_fresh_process(work: str, order) -> int:
    """Phase 3's second half, run by a new interpreter: qwen3-1.7b from
    seed 0 again, the saved containers decompressed in ``order``, the
    tokens saved beside them."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN
    from repro_torch.serve.engine import ModelPredictor
    from repro_torch.service import CompressionService
    work = pathlib.Path(work)
    pred = ModelPredictor.random_init(QWEN, seed=0, device="cuda")
    svc = CompressionService(pred, slots=16, chunk_size=128, topk=48)
    handles = {int(i): svc.submit_decompress(
        (work / f"job{i}.llmc").read_bytes()) for i in order}
    for i, h in handles.items():
        np.save(work / f"job{i}.npy", h.result())
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ----------------------------------------------------------- phase 4
def phase_full_cdf() -> dict:
    import numpy as np
    import torch
    from repro_torch.configs.paper_predictors import PRED_BASE
    from repro_torch.data.synthetic import human_like
    from repro_torch.data.tokenizer import encode
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ModelPredictor
    from repro_torch.service import CompressionService
    pred = ModelPredictor.random_init(PRED_BASE, seed=0, device="cuda")
    svc = CompressionService(pred, slots=16, chunk_size=128, topk=0)
    toks = encode(human_like("article", 2500, seed=5))
    ops.reset_launches()
    t0 = time.perf_counter()
    blob, _ = svc.submit_compress(toks).result()
    back = svc.submit_decompress(blob).result()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if not np.array_equal(back, toks):
        fail("--topk 0 round trip differs")
    for k in ("decode_attention", "cdf_points"):
        if launches[k] <= 0:
            fail(f"--topk 0 path launched {k} {launches[k]} times")
    log(f"[topk0] pred-base {toks.size} tokens -> {len(blob)} B and back "
        f"in {dt:.2f} s; launches {launches}")
    return dict(launches=launches)


# ----------------------------------------------------------- phase 5
def phase_cli() -> None:
    from repro_torch.data.synthetic import human_like
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    src, arc, back = work / "in.txt", work / "in.llmc", work / "back.txt"
    src.write_bytes(human_like("novel", 1500, seed=7))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    for cmd in (["compress", str(src), str(arc)],
                ["decompress", str(arc), str(back)]):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.cli", *cmd,
                            "--predictor", "pred-base"], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"llmc-torch {cmd[0]} exited {r.returncode}:\n{r.stdout}"
                 f"\n{r.stderr}")
        log(f"[cli] {cmd[0]}: {r.stdout.strip()} "
            f"({time.perf_counter() - t0:.1f} s with start-up)")
    if src.read_bytes() != back.read_bytes():
        fail("CLI round trip: decompressed file differs")
    log(f"[cli] compress -> decompress byte-identical "
        f"({src.stat().st_size} B -> {arc.stat().st_size} B)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        f"(one nvcc per source, in parallel)")
    for name, (secs, report) in built.items():
        regs = [ln.strip() for ln in report.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name} ({secs:.1f} s): " + " | ".join(regs[:6]))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kern = phase_kernels(gen)
    svc = phase_service(gen)
    full = phase_full_cdf()
    phase_cli()

    rows = []
    for name, (src, replaces) in SOURCES.items():
        r = kern[name]
        main_launches = (full if name == "cdf_points" else svc)["launches"]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": int(main_launches[name]),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
