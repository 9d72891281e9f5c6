#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one card

Phases, in order; any failure raises and the script exits non-zero:

1. The card (``nvidia-smi`` name and power limit) and the kernel build:
   every ``src/repro_torch/kernels/csrc/*.cu`` compiled by its own
   ``nvcc``, all at once.
2. Each kernel at the main paths' shapes against its plain PyTorch
   version on the same inputs, with its time (a CUDA-event mean of
   back-to-back calls, and its own device time from ``torch.profiler``),
   the plain version's time,
   a one-call PyTorch yardstick (``library_ms``, never used by the port;
   ``library_device_ms`` the device time of every kernel that call
   launches, held beside the kernel's own device time) and its bound on
   the card (the larger of bytes over 3.35 TB/s and
   operations over the peak rate of their type: the bf16 tensor rate for
   bf16 inputs, the fp32 rate for fp32). ``decode_attention`` at
   qwen3-1.7b's and ``pred-base``'s decode shapes and at zamba2-7b's
   attention widths over a 512-position cache (32 heads, G = 1, hd 112),
   and at phase 17's: h2o-danube-3-4b (32 heads, G = 4, hd 120: the
   CUDA-core path) over 128 and 4,096 positions, deepseek-7b (G = 1, K =
   32) and qwen3-14b (48 heads, G = 6), and at phases 19-20's:
   qwen3-moe-235b-a22b (64 heads over 4: G = 16, the kernel's sixteen q
   rows of one tensor-core product) and granite-moe-1b-a400m (16/8, hd
   64); its int8 variant
   ``decode_attention_int8`` at deepseek-7b's shape, h2o's 4,096 and
   qwen3-moe's G = 16, held
   also bit for bit against the bf16 kernel on the dequantized cache,
   whose time is printed beside it (no one-call library equivalent).
   ``flash_attention`` at full
   width (S = 128), at the router probe's shape (S = 32), with a 32-token
   prefix (S = 160), under a sliding window, at ``pred-base`` width
   in fp32, at zamba2-7b's (32 heads, G = 1, hd 112; S = 128, 32 and
   160), at h2o's (hd 120, window 4096; S = 128, and 2 lanes of S =
   4,352 as phase 18 scores them), qwen3-14b's (G = 6) and deepseek-7b's
   (G = 1, K = 32), qwen3-moe's (G = 16: two CTA head groups of 8) and
   granite-moe's (hd 64). ``topk_cdf`` at qwen3-1.7b's, mamba2-130m's,
   ``pred-base``'s, zamba2-7b's, deepseek-7b's (102,400) and
   granite-moe's (49,155: odd, in rows of 49,408) vocabularies. ``ssd_intra`` at the mamba2-130m
   scoring path's shapes
   (H=24, P=64, N=128, bf16): 16 chunks of Q = 128, the probe's Q = 32,
   the prefix's Q = 160, S = 512 as 32 chunks of Q = 256, and the tiny
   test width in fp32; and at zamba2-7b's (H=112, P=64, N=64, bf16): Q =
   128, 32 and 160. Phase 18's fp32 twin adds ``decode_attention`` at
   h2o over 4,096 positions and ``flash_attention`` at 4,352, windowed
   and not, in fp32. The attention kernels are held against the plain
   version computed in fp32: 2e-5 absolute in fp32, and in bf16
   ATTN_REL_TOL of each output row's largest |value|; a plain version
   with one key tile skipped must fail that limit (``_planted``).
3. The decode path at full width: ``qwen3-1.7b`` (28 layers, d=2048,
   V=151936, bf16; random weights from seed 0) through
   ``CompressionService(slots=16, chunk_size=128, topk=48)``: a few
   compress jobs of mixed length, then decompression by another service
   run in another order (so chunks land on other lanes), byte identity
   required. Every model step is the replay of the captured decode step
   (``serve/graphs.py``). The kernel launch counts and the graph counts
   are reset just before and read just after: each service step must be
   a replay, and a kernel captured in the step must count (replays +
   warm-up steps) x its launches per step. Before the jobs, one decode
   step with the lanes permuted, and one with lane 0 kept and the other
   lanes permuted, each bit for bit against the first; after them, the
   captured step's bound (every weight read once over 3.35 TB/s). Then 16 replays held against
   16 eager steps on a twin cache, bit for bit (logits and every cache
   leaf, two lanes reset half way), the bytes of one lane's snapshot,
   the captured and the eager step timed side by side (host ms, and
   under ``torch.profiler`` device ms, idle share, kernels and host
   launch calls per step), and the four jobs traced each way through a
   ``PhaseReport`` (the model's share of a service step against the CDF
   -> rANS coder's and the scheduler's). Then phase 10, and the
   containers decompressed once more by a fresh process that rebuilds
   the predictor from the seed, in a third order: compress and
   decompress are separate processes in the user's flow. Digests of the
   weights and of one decode step let runs on other cards be compared.
4. Teacher-forced scoring at full width: ``score_chunks`` on 16 chunks
   x 128 against the decode program's logits for the same chunks, fresh
   and under a 32-token prefix (max |logit difference| and the share of
   positions whose top-48 id sets agree, against stated tolerances);
   ``LLMCompressor.compress(exact=False)`` against ``exact=True`` on
   those chunks (the two code lengths).
5. The routed service at full width: two jobs of text, random bytes and
   runs of one byte through ``CompressionService(route="auto")``, counts
   reset just before and read just after (``flash_attention`` = 28 per
   probe), decompressed by another service run in the other order, byte
   identity required; the per-codec decisions and the probe's time.
6. ``--topk 0`` (full-vocabulary CDF kernel) round trip at ``pred-base``
   width, counts read the same way. Then a ``pred-base`` top-k archive
   decoded under another seed's weights through ``LLMCompressor`` and
   ``CompressionService``: ``ContainerError`` from both, and the same
   CUDA context decodes it under the writer's weights byte for byte.
7. ``llmc-torch`` as a user runs it, every command a new process on the
   trained ``pred-base`` (each printed with its time, start-up included;
   after the first, which trains ``pred-base``, they run in two waves of
   processes side by side: the compressions and ``stats``, then what
   reads their archives):
   ``compress`` / ``decompress`` of a small file, plain, with ``--route
   auto``, and with the context flags and ``--draft``; ``--v3`` and back;
   ``compress --sidecar --trace`` (the sidecar has one entry per chunk,
   the trace is Chrome-trace JSON with the service's span names, the
   phase line is printed) and ``decompress --sidecar``; ``range`` over an
   interior interval of the plain and of the routed archive (each equal
   to the source's byte slice); a ``--route raw`` archive decompressed by
   a process whose ``$REPRO_TORCH_CACHE`` is an empty directory, which
   must stay empty (no predictor trained or loaded); ``stats`` as JSON
   (``chunks_completed`` = 64), Prometheus text and summary. Then
   ``range`` and ``stats`` once more in this process through
   ``repro_torch.cli.main``, counts reset just before and read just
   after: ``stats`` launches ``cdf_points`` and ``decode_attention``,
   ``range`` launches ``topk_cdf`` and ``decode_attention`` = 6 x
   (replays + warm-up steps). Last, the span mirror: one
   ``LLMCompressor.compress`` of 4 KiB of text at a (lanes, length) no
   earlier phase used (so its decode graph is captured inside) under
   ``torch.profiler``: ``compress.job`` and ``model.decode_step`` are
   ``record_function`` events, a ``decode_attention`` kernel was launched
   inside a ``model.decode_step`` span, no ``mirror=False`` span
   (``coder.step``) appears, and the bytes equal an unprofiled compress.
8. Phase 3 again for ``mamba2-130m`` (the ssm family at full width: 24
   layers, d=768, N=128, P=64, V=50280, bf16; random weights from seed
   0): the captured recurrent decode step and ``topk_cdf``, the same
   jobs, checks and timings, phase 10, the fresh process.
9. Phases 4 and 5 again for ``mamba2-130m``: ``score_chunks`` against
   the decode program, fresh and under a prefix (held in fp32 through a
   twin of the same seed, and in bf16 against that twin: see
   ``SCORE_TOL_FP32``), ``compress(exact=False)`` and the routed
   service, with ``ssd_intra`` launched once per layer of every
   teacher-forced ``forward``.
10. Speculative decompression at full width, run inside phases 3 and 8
   on their predictor and containers: ``LLMCompressor(decode_batch=16)``
   lock-step, then with ``draft_k=4`` (one captured verify program of 5
   steps per round, each lane rolled back to what it accepted); byte
   identity both ways, rounds against verify replays, lock-step steps,
   draft acceptance and the wall time of each.
11. Shared prefix at full width (``qwen3-1.7b``, after phase 5): two jobs
   through one service with the same 32-token shared prefix; the second
   must hit the radix prefix cache, both must round-trip, and a fresh
   service (a cache miss) must write the second's container byte for
   byte. Phase 7 also runs ``compress --context-window 16
   --shared-prefix`` and ``decompress --draft 4`` through the CLI.
13. The paper's experiment (``pred-base``, fp32, into a fresh cache):
   every leaf's gradient finite and nonzero at step 0 of the recipe,
   then ``train/prep.py``'s recipe (220 AdamW steps of 16 x 192 tokens;
   the loss every 50 steps, the mean of the last 10 held below that of
   the first 10, and no kernel launched by training), the checkpoint
   reloaded bit for bit, a train step timed (host and device ms, tokens/s,
   peak memory); ``llm_dataset("wiki", 4096)`` generated through the
   captured step (sampled tokens/s; ``decode_attention`` = n_layers x
   (replays + warm-up steps)); that text compressed by
   ``LLMCompressor(chunk_size=64, topk=32, decode_batch=16)`` and by
   ``llmc-torch compress`` (CLI defaults, v4), both decompressed byte for
   byte by fresh processes that load the checkpoint; the ratio held above
   ``gzip_ratio`` (``tests/test_system.py``'s headline check). Printed,
   not held: chunks 16 and 128, own text against ``human_like_ood``,
   ``exact=False`` against exact, ``entropy.analyze`` of the text.
14. Five AdamW steps of ``qwen3-1.7b`` at full width (bf16 parameters,
   fp32 moments, remat per layer) on one fixed 8 x 256 batch: every
   leaf's gradient finite and nonzero at step 1, the loss lower at step
   5 than at step 1; step ms, tokens/s, peak memory and 6 N tokens /
   step time as a share of 989 TFLOP/s.
15. Phase 3 again for ``zamba2-7b`` (the hybrid family at full width,
   cut to 29 of its 81 SSD layers (``ZAMBA_CUT``: two applications of
   its shared block, then its 3 trailing SSD layers, as 81 = 6 x 13 +
   3): d=3584, 112 heads x P=64, N=64, and one shared attention + MLP
   block, 32 heads of hd 112, d_ff 14336, after every 13 SSD layers;
   V=32000, bf16, from seed 0): shorter jobs (23 chunks), the same
   checks (``decode_attention`` 2 x (replays + warm-up steps)), timings,
   phase 10 and the fresh process, and the peak device memory.
16. Phases 4, 5 and 11 for ``zamba2-7b`` (the same cut): scoring
   against the decode program held through the fp32 twin, after a check
   that the bf16 logits are finite; ``compress(exact=False)``; the
   routed service with ``flash_attention`` 2 and ``ssd_intra`` 29 per
   teacher-forced forward; the shared-prefix jobs
   (a prefix-cache hit of one ~166 MB lane snapshot; the service's cache
   capacity 256 tokens). Each phase's model is freed before the next;
   the peak memory of each is logged.
17. ``h2o-danube-3-4b`` (d=3840, hd 120, window 4096), ``deepseek-7b``
   (MHA, V = 102,400) with its bf16 cache and again with the int8 KV
   cache, and ``qwen3-14b`` (d=5120, 40 heads padded to 48), at full
   width, each cut to ``DENSE_CUT`` = 8 layers (of 24, 30 and 40: every
   trait these phases hold is a layer's), random weights from seed 0,
   bf16, each freed
   before the next: phase 3's service round trip on 23 chunks (launch
   counts; ``decode_attention_int8`` for the int8 cache), captured
   against eager, the captured step's host and device ms, idle share and
   kernels, phase 10's speculative decompression, then phases 4 and 11
   (scoring to SCORE_TOL, not for the int8 twin; the shared-prefix
   jobs), peak memory at ``init_params`` and per phase; then one fresh
   process decompresses all four configs' containers.
18. Two lanes of ``h2o-danube-3-4b`` (cut to 8 layers, as in phase 17)
   past its window: 4,352 positions
   through the captured step (a ring of 4,096 slots that wraps), their
   logits held to SCORE_TOL against windowed teacher-forced scoring of
   the same tokens (one ``forward`` through the flash kernel, window
   4096), over every position and over the 256 past the window; then a
   captured verify round after the wrap, rolled back to 1 and 3 of its 5
   inputs, against captured lock-step caches: bit for bit. Then the
   fp32 twin decodes the same positions and is held to SCORE_TOL_FP32
   against its windowed scoring, and scoring with no window (a ring that
   evicts nothing) must lie outside that limit past the window.
19. ``granite-moe-1b-a400m`` (the moe family at full width and depth:
   24 layers, d=1024, 16/8 heads of hd 64, 32 experts of d_ff 512, top
   8, V = 49,155, 1.39 B parameters from seed 0, bf16): phase 3's
   service round trip on 23 chunks (the lane permutations bit for bit),
   captured against eager, the captured step's host and device ms, idle
   share and kernels against its bound (every expert's weights read),
   phase 10's speculative decompression, then phases 4 and 11 (scoring
   against the decode program held through the fp32 twin, as for
   mamba2-130m: see ``SCORE_TOL_FP32``; the shared-prefix jobs), with the
   peak memory of each.
20. The same for ``qwen3-moe-235b-a22b`` at full width (d=4096, 64/4
   heads: G = 16, qk-norm, 128 experts of d_ff 1536, top 8, V =
   151,936), cut to 4 of its 94 layers (11.2 B of its 235 B parameters;
   the whole model needs expert parallelism over several cards); then
   one fresh process decompresses both moe configs' containers.
12. Last, one JSON line describing every kernel (its ``launches`` from
   the main path that runs it: phase 3 for ``decode_attention`` and
   ``topk_cdf``, 6 for ``cdf_points``, 5 for ``flash_attention``, 9 for
   ``ssd_intra``, 17 (deepseek-7b's int8 service) for
   ``decode_attention_int8``; phase 7 holds the CLI's own counts;
   ``launches_zamba2`` from phases 15 and 16, ``launches_phase17`` per
   config, ``launches_phase18`` and ``launches_moe`` per phase 19-20
   config), then the result line ``{"ok":
   true, "device": {...}}`` as the last line of stdout. A ``[time]``
   line gives each phase's wall seconds.

The CLI's ``pred-*`` predictors train at first use: phase 7 trains
``pred-base`` into ``build/chip_smoke/torch_cache`` (``$REPRO_TORCH_CACHE``
for the whole run), phase 13 into a cache of its own.

It exits non-zero, printing no result, without a CUDA device or outside
a checkout of the repository. Built libraries go to ``build/``. It runs
with ``PYTHONHASHSEED=0`` (re-executing itself once when that is not
set), as do the processes it starts: ``data/synthetic.py`` seeds its
text with ``hash(domain)``, so the jobs' texts, and the container sizes,
would otherwise move from run to run.
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
BF16_FLOPS = 989e12                 # bf16 on the tensor cores, dense
SOURCES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:67"),
    # the same source built with -DREPRO_KV_INT8: the int8 cache's variant
    # of the same TPU kernel (the JAX model dequantizes before calling it)
    "decode_attention_int8": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:67"),
    "topk_cdf": ("src/repro_torch/kernels/csrc/topk_cdf.cu",
                 "src/repro/kernels/ac_cdf.py:187"),
    "cdf_points": ("src/repro_torch/kernels/csrc/cdf_points.cu",
                   "src/repro/kernels/ac_cdf.py:92"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:89"),
    "ssd_intra": ("src/repro_torch/kernels/csrc/ssd_intra.cu",
                  "src/repro/kernels/ssd_scan.py:51"),
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


def _on_device(e) -> bool:
    """A profiler event that is device work: a kernel, copy or set, not
    the GPU-side interval of a ``record_function`` span (the port's spans
    are mirrored into the profiler; summing those intervals would count
    the kernels inside them twice)."""
    from torch.autograd import DeviceType
    return e.device_type == DeviceType.CUDA \
        and not getattr(e, "is_user_annotation", False)


def device_ms(fn, kernel: str, iters: int = 20):
    """Mean device milliseconds per call of the CUDA kernels whose name
    contains ``kernel``, from ``torch.profiler`` over ``iters`` calls:
    the kernel's own time, without the host's launch overhead that a
    CUDA-event mean of back-to-back calls includes when the host cannot
    keep the device busy. A profiler session that records none of the
    kernel's launches (the launches ran, the trace came back without
    them: seen in long runs, once three sessions in a row) is taken
    again, up to five times, a second apart; then the time is "not
    measured" (None), which is logged: the profiler's loss is no fault of
    the kernel, whose checks and event times stand. For a named kernel
    (one launch per call) the mean is over the launches the session
    recorded, so a trace that lost some of them does not read low; the
    loss is logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages() if _on_device(e)]
        us = sum(t for k, t, _ in seen if kernel in k)
        if us > 0:
            if not kernel:
                return us / 1e3 / iters
            n = sum(c for k, _, c in seen if kernel in k)
            if n != iters:
                log(f"[profiler] recorded {n} of {iters} launches of "
                    f"{kernel}")
            return us / 1e3 / n
        log(f"[profiler] session {attempt + 1} saw no device time of "
            f"{kernel or 'the call'} (device events: {seen})")
    log(f"[profiler] {kernel or 'the call'}: device time not measured "
        f"(five sessions recorded none of it)")
    return None


def _ms(x, digits: int = 4) -> str:
    """A time in ms, or "not measured" (a profiler that lost it)."""
    return "not measured" if x is None else f"{x:.{digits}f} ms"


def library_device_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of a yardstick PyTorch call: the
    time of every CUDA kernel it launches, from ``torch.profiler``, so
    that a kernel's device time and its library call's compare like for
    like."""
    return device_ms(fn, "", iters)


def bound(nbytes: float, flops: float, dtype=None) -> tuple[float, str]:
    """Least ms for ``nbytes`` moved and ``flops`` done on inputs of
    ``dtype``: bf16 counts at the tensor-core rate, anything else at the
    fp32 rate."""
    import torch
    rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ----------------------------------------------------------- phase 2
# Attention kernels against their plain version computed in fp32 on the
# same inputs (the bf16 plain version is that output rounded once). In
# fp32 the limit is 2e-5 absolute. In bf16 it is ATTN_REL_TOL of the
# largest |value| of the same output row (a (lane, head) row of decode,
# a (lane, head, query) row of flash): rounding the output to bf16 alone
# moves a value by up to 2**-8 of itself (half an ulp), and the flash
# kernel rounds P to bf16 once more, a fraction of that. An absolute
# limit cannot do this: at 4,096 positions an output is ~sqrt(e / len)
# ~ 0.03, the size of 3e-2 (that limit is kept beside it, for rows of a
# few keys, whose values reach 4). Each check also plants a fault in the
# plain version (one tile of keys skipped in one row set, the kernel's
# tile: DECODE_TILE positions for decode, 64 keys for flash) and fails
# unless the same limit rejects it.
ATTN_REL_TOL = 2.0 ** -7
ATTN_BF16_ABS_TOL = 3e-2
ATTN_F32_ABS_TOL = 2e-5


def _attn_held(out, want32, dtype) -> dict:
    """max |out - want32| and its largest share of its row's max
    |want32|; ``ok`` under the dtype's limit."""
    import torch
    err = (out.float() - want32).abs()
    row = want32.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    r = dict(max_abs_err=err.max().item(), rel_err=(err / row).max().item())
    if dtype == torch.bfloat16:
        r.update(tol=ATTN_REL_TOL, ok=r["rel_err"] <= ATTN_REL_TOL
                 and r["max_abs_err"] <= ATTN_BF16_ABS_TOL)
    else:
        r.update(tol=ATTN_F32_ABS_TOL,
                 ok=r["max_abs_err"] <= ATTN_F32_ABS_TOL)
    return r


def _planted(what: str, fault, want32, dtype) -> dict:
    """The planted fault (fp32, rounded to ``dtype`` as a kernel's output
    is) must fail the limit a kernel is held to."""
    r = _attn_held(fault.to(dtype), want32, dtype)
    if r["ok"]:
        fail(f"{what}: a plain version with one tile of keys skipped passes "
             f"the limit (max err {r['max_abs_err']}, rel {r['rel_err']}): "
             f"the check cannot see such a fault")
    return dict(planted_max_abs_err=r["max_abs_err"],
                planted_rel_err=r["rel_err"])


def _decode_planted(q32, k32, v32, lengths, want32, dtype, what):
    """Decode attention's plain version with one DECODE_TILE of positions
    skipped in the longest lane, from the middle of its live length."""
    import torch
    from repro_torch.kernels import ops, ref
    b = int(lengths.argmax().item())
    n, T = int(lengths[b].item()), ops.DECODE_TILE
    if n < 2 * T:
        return {}
    a = (n // 2) // T * T
    keep = torch.cat([torch.arange(a), torch.arange(a + T, n)]).to(q32.device)
    fault = want32.clone()
    fault[b] = ref.decode_attention(
        q32[b:b + 1], k32[b:b + 1, keep], v32[b:b + 1, keep],
        torch.tensor([n - T], dtype=torch.int32, device=q32.device))[0]
    return _planted(what, fault, want32, dtype)


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
    q32, k32, v32 = q.float(), kc.float(), vc.float()
    want32 = ref.decode_attention(q32, k32, v32, lengths)
    torch.cuda.synchronize()
    what = f"decode_attention {shape} {dtype}"
    r = _attn_held(out, want32, dtype)
    if not r["ok"]:
        fail(f"{what}: {r}")
    r.update(_decode_planted(q32, k32, v32, lengths, want32, dtype, what))
    del q32, k32, v32, want32
    # yardstick: one SDPA call over the same cache (GQA, padding mask)
    q4 = q[:, :, None, :]
    k4, v4 = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=mask, enable_gqa=True)
    lib_ms = time_ms(lib)
    lib_dev_ms = library_device_ms(lib)
    ms = time_ms(lambda: ops.decode_attention(q, kc, vc, lengths))
    dev_ms = device_ms(lambda: ops.decode_attention(q, kc, vc, lengths),
                       "decode_attention_kernel")
    plain_ms = time_ms(lambda: ref.decode_attention(q, kc, vc, lengths))
    el = q.element_size()
    live = int(lengths.sum().item())
    nbytes = 2 * B * H * hd * el + 2 * live * K * hd * el + B * 4
    flops = 4.0 * live * H * hd
    b_ms, b_by = bound(nbytes, flops, dtype)
    return dict(r, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_device_ms=lib_dev_ms)


def check_attention_int8(shape, dtype, gen):
    """The int8 decode-attention kernel over a cache quantized as the
    model quantizes it: against its plain version (dequantize to the
    model dtype, then attend, in fp32), and bit for bit against the bf16
    kernel on the dequantized cache, whose time at the same shape is
    reported beside its own. No one PyTorch call attends an int8 cache,
    so there is no library time. The bound counts the int8 rows and
    their fp16 scales."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.transformer import _quant_kv
    B, H, K, hd, S = shape
    dev = "cuda"
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(dtype)
    kq, ks = _quant_kv(torch.randn((B, S, K, hd), generator=gen, device=dev))
    vq, vs = _quant_kv(torch.randn((B, S, K, hd), generator=gen, device=dev))
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    run = lambda: ops.decode_attention_int8(  # noqa: E731
        q, kq, vq, ks, vs, lengths)
    out = run()
    kd, vd = ref.dequant_kv(kq, ks, dtype), ref.dequant_kv(vq, vs, dtype)
    q32, k32, v32 = q.float(), kd.float(), vd.float()
    want32 = ref.decode_attention(q32, k32, v32, lengths)
    same = torch.equal(out, ops.decode_attention(q, kd, vd, lengths))
    torch.cuda.synchronize()
    what = f"decode_attention_int8 {shape} {dtype}"
    r = _attn_held(out, want32, dtype)
    if not r["ok"] or not same:
        fail(f"{what}: {r}, or not the bf16 kernel's output on the "
             f"dequantized cache")
    r.update(_decode_planted(q32, k32, v32, lengths, want32, dtype, what))
    del q32, k32, v32, want32
    ms = time_ms(run)
    dev_ms = device_ms(run, "decode_attention_kernel")
    plain_ms = time_ms(lambda: ref.decode_attention_int8(
        q, kq, vq, ks, vs, lengths))
    bf = lambda: ops.decode_attention(q, kd, vd, lengths)  # noqa: E731
    bf_ms = time_ms(bf)
    bf_dev_ms = device_ms(bf, "decode_attention_kernel")
    el = q.element_size()
    live = int(lengths.sum().item())
    nbytes = 2 * B * H * hd * el + 2 * live * K * (hd + 2) + B * 4
    flops = 4.0 * live * H * hd
    b_ms, b_by = bound(nbytes, flops, dtype)
    return dict(r, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, library_device_ms=None,
                bf16_kernel_ms=bf_ms, bf16_kernel_device_ms=bf_dev_ms)


def _flash_planted(q32, k32, v32, window, want32, dtype, what):
    """Flash attention's plain version for lane 0's last 64 queries with
    one 64-key tile skipped, from the middle of the keys they all see."""
    import math
    import torch
    from repro_torch.kernels import ref
    _, H, S, hd = q32.shape
    K, T = k32.shape[1], 64
    if S < 2 * T:
        return {}
    rows = slice(S - T, S)
    a = (S - min(S, window or S) // 2) // T * T
    mask = ref.attention_mask(S, S, True, window, q32.device)[rows].clone()
    mask[:, a:a + T] = False
    kh = k32[0].repeat_interleave(H // K, 0)            # (H, S, hd)
    vh = v32[0].repeat_interleave(H // K, 0)
    s = torch.einsum("hqd,hkd->hqk", q32[0, :, rows], kh) / math.sqrt(hd)
    p = torch.softmax(s.masked_fill(~mask, ref.NEG_INF), -1)
    fault = want32.clone()
    fault[0, :, rows] = torch.einsum("hqk,hkd->hqd", p, vh)
    return _planted(what, fault, want32, dtype)


def check_flash(B, H, K, S, hd, dtype, gen, window=None):
    """Prefill attention as the model calls it: q/k/v made in the model's
    (B, S, heads, hd) layout and handed over as transposed views."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dev = "cuda"
    q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, S, K, hd), generator=gen, device=dev).to(dtype)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = ops.flash_attention(q, k, v, True, window)
    q32, k32, v32 = q.float(), k.float(), v.float()
    want32 = ref.flash_attention(q32, k32, v32, True, window)
    torch.cuda.synchronize()
    what = f"flash_attention ({B},{H},{K},{S},{hd}) window {window} {dtype}"
    r = _attn_held(out, want32, dtype)
    if not r["ok"]:
        fail(f"{what}: {r}")
    r.update(_flash_planted(q32, k32, v32, window, want32, dtype, what))
    del q32, k32, v32, want32
    mask = ref.attention_mask(S, S, True, window, dev)
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True)
    lib_ms = time_ms(lib)
    lib_dev_ms = library_device_ms(lib)
    ms = time_ms(lambda: ops.flash_attention(q, k, v, True, window))
    dev_ms = device_ms(lambda: ops.flash_attention(q, k, v, True, window),
                       "flash_bf16_kernel" if dtype == torch.bfloat16
                       else "flash_f32_kernel")
    plain_ms = time_ms(lambda: ref.flash_attention(q, k, v, True, window),
                       10)
    el = q.element_size()
    nbytes = (2 * B * H * S * hd + 2 * B * K * S * hd) * el
    flops = 4.0 * B * H * hd * int(mask.sum().item())
    b_ms, b_by = bound(nbytes, flops, dtype)
    return dict(r, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_device_ms=lib_dev_ms)


# ssd_intra against its plain version: both compute in fp32 from the same
# inputs, in other orders, and the bf16 kernel keeps ~16 bits of its fp32
# factors (two bf16 parts each); held to SSD_TOL of the plain version's
# largest |value| (at least 1), as tests/test_torch_cuda.py holds it.
SSD_TOL = {"float32": 2e-5, "bfloat16": 1e-4}


def check_ssd(R, Q, H, P, N, dtype, gen):
    """The SSD intra-chunk kernel as the model calls it: x, B and C as
    views of one (R, Q, H*P + 2N) conv output, inputs drawn as in
    tests/test_kernels.py."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = "cuda"
    conv = torch.randn((R, Q, H * P + 2 * N), generator=gen,
                       device=dev).to(dtype)
    x, Bm, Cm = torch.split(conv, [H * P, N, N], dim=-1)
    x = x.reshape(R, Q, H, P)
    dt = (0.05 + 0.75 * torch.rand((R, Q, H), generator=gen,
                                   device=dev)).to(dtype)
    A = -(0.3 + 1.7 * torch.rand((H,), generator=gen, device=dev))
    y, s = ops.ssd_intra(x, dt, A, Bm, Cm)
    yr, sr = ref.ssd_intra(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    scale = max(1.0, yr.abs().max().item(), sr.abs().max().item())
    err = max((y - yr).abs().max().item(), (s - sr).abs().max().item())
    tol = SSD_TOL[str(dtype).split(".")[-1]] * scale
    if not err <= tol:
        fail(f"ssd_intra ({R},{Q},{H},{P},{N}) {dtype}: max err {err} > "
             f"{tol}")
    ms = time_ms(lambda: ops.ssd_intra(x, dt, A, Bm, Cm))
    dev_ms = device_ms(lambda: ops.ssd_intra(x, dt, A, Bm, Cm),
                       "ssd_bf16_kernel" if dtype == torch.bfloat16
                       else "ssd_f32_kernel")
    plain_ms = time_ms(lambda: ref.ssd_intra(x, dt, A, Bm, Cm), 10)
    el = x.element_size()
    nbytes = (R * Q * H * P + R * Q * H + 2 * R * Q * N) * el + H * 4 \
        + (R * Q * H * P + R * H * P * N) * 4
    # what the function needs: C B^T once per chunk (heads share B and
    # C) over the Q (Q + 1) / 2 causal pairs, W x per head over the same
    # pairs, and the (P, N) state per head over Q positions
    pairs = Q * (Q + 1) // 2
    flops = 2.0 * R * pairs * N + 2.0 * R * H * pairs * P \
        + 2.0 * R * H * Q * P * N
    b_ms, b_by = bound(nbytes, flops, dtype)
    return dict(max_abs_err=err, tol=tol, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, library_device_ms=None)


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
    dev_ms = device_ms(lambda: ops.topk_cdf(x, k, precision),
                       "topk_cdf_kernel")
    plain_ms = time_ms(lambda: ref.topk_cdf(x, k, precision), 10)
    lib = lambda: torch.topk(torch.softmax(x.float(), dim=-1),  # noqa: E731
                             k, dim=-1)
    lib_ms = time_ms(lib)
    lib_dev_ms = library_device_ms(lib)
    nbytes = R * V * x.element_size() + R * k * 4 + R * (k + 2) * 4
    b_ms, b_by = bound(nbytes, 4.0 * R * V, dtype)
    return dict(max_abs_err=float(err), tol=1, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_device_ms=lib_dev_ms)


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
    dev_ms = device_ms(lambda: ops.cdf_points(x, precision),
                       "cdf_points_kernel")
    plain_ms = time_ms(lambda: ref.cdf_points(x, precision))
    lib = lambda: torch.cumsum(torch.softmax(x.float(), dim=-1),  # noqa
                               dim=-1)
    lib_ms = time_ms(lib)
    lib_dev_ms = library_device_ms(lib)
    nbytes = R * V * x.element_size() + R * V * 4
    b_ms, b_by = bound(nbytes, 4.0 * R * V, dtype)
    return dict(max_abs_err=float(err), tol=1, ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_device_ms=lib_dev_ms)


def phase_kernels(gen, probe_chunks: int) -> dict:
    import torch
    from repro_torch.configs.base import tiny_variant
    from repro_torch.configs.deepseek_7b import CONFIG as DEEP
    from repro_torch.configs.granite_moe_1b_a400m import CONFIG as GRANITE
    from repro_torch.configs.h2o_danube_3_4b import CONFIG as H2O
    from repro_torch.configs.mamba2_130m import CONFIG as MAMBA
    from repro_torch.configs.paper_predictors import PRED_BASE
    from repro_torch.configs.qwen3_14b import CONFIG as Q14
    from repro_torch.configs.qwen3_1_7b import CONFIG as QWEN
    from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as QMOE
    from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA
    res = {}
    # phase 17's configs: (heads, kv-heads, hd) as the kernels see them
    h2o = (H2O.padded_heads, H2O.padded_kv_heads, H2O.head_dim)  # G 4, hd 120
    deep = (DEEP.padded_heads, DEEP.padded_kv_heads, DEEP.head_dim)  # G 1
    q14 = (Q14.padded_heads, Q14.padded_kv_heads, Q14.head_dim)  # G 6
    # phases 19-20's: granite-moe (16/8, hd 64), qwen3-moe (64/4: G 16)
    gmoe = (GRANITE.padded_heads, GRANITE.padded_kv_heads, GRANITE.head_dim)
    qmoe = (QMOE.padded_heads, QMOE.padded_kv_heads, QMOE.head_dim)
    W = H2O.sliding_window
    S = 128                                   # chunk 128, no context
    H, K, hd = QWEN.n_heads, QWEN.n_kv_heads, QWEN.head_dim
    bf = torch.bfloat16
    ssm = (MAMBA.ssm_heads, MAMBA.ssm_headdim, MAMBA.ssm_state)
    tiny = tiny_variant(MAMBA)
    zh, zhd = ZAMBA.n_heads, ZAMBA.head_dim          # MHA: G = 1, hd 112
    zssm = (ZAMBA.ssm_heads, ZAMBA.ssm_headdim, ZAMBA.ssm_state)
    for name, fn, args in [
        ("decode_attention", check_attention,
         ((16, QWEN.n_heads, QWEN.n_kv_heads, QWEN.head_dim, S),
          torch.bfloat16, gen)),
        ("decode_attention@pred-base", check_attention,
         ((16, PRED_BASE.n_heads, PRED_BASE.padded_kv_heads,
           PRED_BASE.head_dim, S), torch.float32, gen)),
        ("decode_attention@zamba2-S512", check_attention,
         ((16, 32, 32, 112, 512), torch.bfloat16, gen)),
        # hd 120: the scalar-lane path, 8 q rows computed for G = 4
        ("decode_attention@h2o-S128", check_attention,
         ((16,) + h2o + (S,), bf, gen)),
        ("decode_attention@h2o-S4096", check_attention,
         ((16,) + h2o + (W,), bf, gen)),
        # phase 18's fp32 twin: 2 lanes through the ring of W
        ("decode_attention@h2o-S4096-fp32", check_attention,
         ((2,) + h2o + (W,), torch.float32, gen)),
        ("decode_attention@deepseek", check_attention,
         ((16,) + deep + (S,), bf, gen)),
        ("decode_attention_int8", check_attention_int8,
         ((16,) + deep + (S,), bf, gen)),
        ("decode_attention_int8@h2o-S4096", check_attention_int8,
         ((16,) + h2o + (W,), bf, gen)),
        ("decode_attention@qwen3-14b", check_attention,     # kG = 8, G 6
         ((16,) + q14 + (S,), bf, gen)),
        # sixteen q rows of one m16n8k16 product (kG = 16)
        ("decode_attention@qwen3-moe", check_attention,
         ((16,) + qmoe + (S,), bf, gen)),
        ("decode_attention@granite-moe", check_attention,
         ((16,) + gmoe + (S,), bf, gen)),
        ("decode_attention_int8@qwen3-moe", check_attention_int8,
         ((16,) + qmoe + (S,), bf, gen)),
        ("topk_cdf", check_topk,
         (16, QWEN.vocab_size, torch.bfloat16, gen, 48, 16,
          QWEN.padded_vocab)),
        ("topk_cdf@mamba2", check_topk,
         (16, MAMBA.vocab_size, torch.bfloat16, gen)),
        ("topk_cdf@pred-base", check_topk,
         (16, PRED_BASE.vocab_size, torch.float32, gen)),
        ("topk_cdf@zamba2", check_topk,
         (16, ZAMBA.vocab_size, torch.bfloat16, gen)),
        ("topk_cdf@deepseek", check_topk,
         (16, DEEP.vocab_size, torch.bfloat16, gen)),
        # V = 49,155 (odd) in rows of 49,408: slices past the first start
        # unaligned
        ("topk_cdf@granite-moe", check_topk,
         (16, GRANITE.vocab_size, torch.bfloat16, gen, 48, 16,
          GRANITE.padded_vocab)),
        ("cdf_points", check_cdf_points,
         (16, QWEN.vocab_size, torch.bfloat16, gen, 18, QWEN.padded_vocab)),
        ("cdf_points@pred-base", check_cdf_points,
         (16, PRED_BASE.vocab_size, torch.float32, gen, 16)),
        ("flash_attention", check_flash, (16, H, K, S, hd, bf, gen)),
        ("flash_attention@probe", check_flash,
         (probe_chunks, H, K, 32, hd, bf, gen)),
        ("flash_attention@prefix32", check_flash,
         (16, H, K, S + 32, hd, bf, gen)),
        ("flash_attention@window64", check_flash,
         (16, H, K, S, hd, bf, gen, 64)),
        ("flash_attention@pred-base", check_flash,
         (16, PRED_BASE.n_heads, PRED_BASE.padded_kv_heads, S,
          PRED_BASE.head_dim, torch.float32, gen)),
        ("flash_attention@zamba2", check_flash,
         (16, zh, zh, S, zhd, bf, gen)),
        ("flash_attention@zamba2-probe", check_flash,
         (16, zh, zh, 32, zhd, bf, gen)),
        ("flash_attention@zamba2-prefix32", check_flash,
         (16, zh, zh, S + 32, zhd, bf, gen)),
        ("flash_attention@h2o", check_flash,
         (16,) + h2o[:2] + (S, h2o[2], bf, gen, W)),
        # phase 18's teacher-forced scoring: 2 lanes past the window
        ("flash_attention@h2o-S4352", check_flash,
         (2,) + h2o[:2] + (W + 256, h2o[2], bf, gen, W)),
        # and its fp32 twin's, with the window and without (the control)
        ("flash_attention@h2o-S4352-fp32", check_flash,
         (2,) + h2o[:2] + (W + 256, h2o[2], torch.float32, gen, W)),
        ("flash_attention@h2o-S4352-fp32-open", check_flash,
         (2,) + h2o[:2] + (W + 256, h2o[2], torch.float32, gen)),
        ("flash_attention@qwen3-14b", check_flash,
         (16,) + q14[:2] + (S, q14[2], bf, gen)),
        ("flash_attention@deepseek", check_flash,
         (16,) + deep[:2] + (S, deep[2], bf, gen)),
        # G 16 in two CTA head groups of 8 (flash_geometry)
        ("flash_attention@qwen3-moe", check_flash,
         (16,) + qmoe[:2] + (S, qmoe[2], bf, gen)),
        ("flash_attention@granite-moe", check_flash,
         (16,) + gmoe[:2] + (S, gmoe[2], bf, gen)),
        ("ssd_intra", check_ssd, (16, S) + ssm + (bf, gen)),
        ("ssd_intra@probe", check_ssd, (probe_chunks, 32) + ssm + (bf, gen)),
        ("ssd_intra@prefix32", check_ssd, (16, S + 32) + ssm + (bf, gen)),
        ("ssd_intra@S512", check_ssd,
         (32, MAMBA.ssm_chunk) + ssm + (bf, gen)),
        ("ssd_intra@tiny", check_ssd,
         (16, tiny.ssm_chunk, tiny.ssm_heads, tiny.ssm_headdim,
          tiny.ssm_state, torch.float32, gen)),
        ("ssd_intra@zamba2", check_ssd, (16, S) + zssm + (bf, gen)),
        ("ssd_intra@zamba2-probe", check_ssd,
         (probe_chunks, 32) + zssm + (bf, gen)),
        ("ssd_intra@zamba2-prefix32", check_ssd,
         (16, S + 32) + zssm + (bf, gen)),
    ]:
        r = fn(*args)
        res[name] = r
        dev, ldev = r["device_ms"], r["library_device_ms"]
        ratio = "" if dev is None or ldev is None \
            else f"; kernel / library on the device {dev / ldev:.2f}"
        lib = "none" if r["library_ms"] is None \
            else (f"{r['library_ms']:.4f} ms (on the device "
                  f"{_ms(ldev)}{ratio})")
        if "bf16_kernel_ms" in r:
            lib += (f" (no one-call equivalent); the bf16 kernel on the "
                    f"dequantized cache {r['bf16_kernel_ms']:.4f} ms (on "
                    f"the device {_ms(r['bf16_kernel_device_ms'])})")
        held = f"max_err {r['max_abs_err']:.3g} (tol {r['tol']:.3g})"
        if "rel_err" in r:
            held = (f"max_err {r['max_abs_err']:.3g}, of its row's max "
                    f"|value| {r['rel_err']:.3g} (tol "
                    + (f"{r['tol']:.3g} of it" if r["tol"] == ATTN_REL_TOL
                       else f"{r['tol']:.3g} absolute") + ")")
            if "planted_rel_err" in r:
                held += (f"; a tile skipped: max_err "
                         f"{r['planted_max_abs_err']:.3g}, of its row's "
                         f"{r['planted_rel_err']:.3g}, rejected")
        log(f"[kernel] {name}: {held} kernel {r['ms']:.4f} ms (on the device "
            f"{_ms(dev)}), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return res


# ----------------------------------------------------------- phase 3
def config(spec: str):
    """A config by registry name; ``NAME+int8`` is that config with the
    int8 KV cache (``kv_cache_dtype="int8"``, as the JAX package reaches
    it: through the config); ``...@L`` cuts its depth to L layers at full
    width (every leaf drawn from the seed at that depth)."""
    from repro_torch.configs.registry import get_config
    spec, _, depth = spec.partition("@")
    name, _, kv = spec.partition("+")
    cfg = get_config(name)
    if kv == "int8":
        cfg = cfg.with_(kv_cache_dtype="int8")
    return cfg.with_(n_layers=int(depth)) if depth else cfg


def attn_kernel(cfg) -> str:
    """The decode-attention kernel of a config's cache."""
    return "decode_attention_int8" if cfg.kv_cache_dtype == "int8" \
        else "decode_attention"


def label(cfg) -> str:
    """A config's name, with ``+int8`` for the int8 KV cache and ``@L``
    for a depth cut to L layers."""
    from repro_torch.configs.registry import get_config
    cut = cfg.n_layers != get_config(cfg.name).n_layers
    return cfg.name + ("+int8" if cfg.kv_cache_dtype == "int8" else "") \
        + (f"@{cfg.n_layers}" if cut else "")


def decode_kernels(cfg) -> tuple:
    """The kernels a family's decode path launches on every step."""
    if cfg.family == "ssm":
        return ("topk_cdf",)
    return (attn_kernel(cfg), "topk_cdf")


def attention_blocks(cfg) -> int:
    """Attention blocks a decode step or a teacher-forced forward runs:
    every layer of the dense and moe families, none of the ssm family,
    and one per application of the hybrid's shared block (zamba2-7b: 81
    // 13 = 6; cut to 29 layers, 2)."""
    return {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
            "hybrid": cfg.n_layers // max(1, cfg.hybrid_ssm_per_block)}[
        cfg.family]


def _check_captured_launches(cfg, launches, stats, steps: int,
                             what: str) -> None:
    """The launch counts of a window against the captured programs: every
    one of ``steps`` service steps a replay of the captured step, and a
    kernel captured in the step counted (replayed steps + warm-up steps)
    x its launches per step; ``topk_cdf``, outside the graph, once per
    step."""
    if stats["step_replays"] != steps:
        fail(f"{what}: {steps} model steps but {stats['step_replays']} "
             f"replays of the captured step")
    per = attention_blocks(cfg)         # decode_attention a captured step
    kern = attn_kernel(cfg)
    if launches[kern] != per * (steps + stats["warmup_steps"]):
        fail(f"{what}: {kern} launches {launches[kern]} != {per} x ({steps} "
             f"replayed + {stats['warmup_steps']} warm-up steps)")
    if launches["topk_cdf"] != steps:
        fail(f"{what}: topk_cdf launches {launches['topk_cdf']} != "
             f"{steps} steps")


def graph_against_eager(pred, B: int = 16, S: int = 128, n: int = 16):
    """n replays of the captured step against n eager steps on a twin
    cache, from the same inputs, with two lanes reset in the middle:
    logits and every cache leaf bit for bit."""
    import numpy as np
    import torch
    pred.set_decode_len(S)
    g, e = pred.begin_decode(B), pred._init_cache(B, S)
    rng = np.random.default_rng(0)
    for t in range(n):
        if t == n // 2:
            mask = np.isin(np.arange(B), (3, 7))
            pred.reset_slots(g, mask)
            pred.reset_slots(e, mask)
        prev = rng.integers(0, pred.vocab_size - 1, B)
        lg, _ = pred.decode_step(g, prev)
        le, _ = pred._eager_decode_step(e, prev)
        if not torch.equal(lg, le):
            fail(f"captured step {t}: logits differ from the eager step")
        for k in g:
            if not torch.equal(g[k], e[k]):
                fail(f"captured step {t}: cache leaf {k} differs from the "
                     f"eager step's")
    log(f"[graph] {label(pred.cfg)}: {n} replays of the captured step equal "
        f"{n} eager steps bit for bit (logits and every cache leaf; lanes "
        f"3 and 7 reset after step {n // 2})")
    return g, e


def time_steps(pred, g, e, n: int = 20, eager: bool = True) -> dict:
    """Host ms per step (a host clock around ``n`` steps ending in a
    synchronise) of the captured and (when ``eager``) the eager step at B
    lanes, and each one's device ms, idle share and kernels per step
    from ``torch.profiler`` over 5 steps."""
    import numpy as np
    import torch
    prev = np.zeros(g["pos"].shape[0], np.int64)
    out = {}
    for name, fn in (("captured", lambda: pred.decode_step(g, prev)),
                     ("eager", lambda: pred._eager_decode_step(e, prev)))[
            :2 if eager else 1]:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / n * 1e3
        dev, kernels, api = profile_calls(fn, 5)
        out[name] = dict(host_ms=host, device_ms=dev, kernels=kernels,
                         host_launch_calls=api)
        log(f"[graph] {label(pred.cfg)} {name} step (B={prev.size}): host "
            f"{host:.3f} ms, device {_ms(dev, 3)} (idle "
            f"{_idle(dev, host)}), {_count(kernels)} kernels and {api:.0f} "
            f"host launch calls per step")
    return out


#: the service round trip's jobs (domain, bytes, seed): 93 chunks of 128
SERVICE_JOBS = (("wiki", 3000, 1), ("code", 2200, 2), ("web", 4000, 3),
                ("math", 2600, 4))
#: zamba2-7b's and phase 17's: 23 chunks, two rounds of the 16 slots each
#: way
SHORT_JOBS = (("wiki", 700, 1), ("code", 500, 2), ("web", 900, 3),
              ("math", 600, 4))


def weight_bytes(pred) -> int:
    """Bytes of every weight of a predictor."""
    return sum(t.numel() * t.element_size() for t in _leaves(pred.params))


def state_bytes(cfg) -> int:
    """Bytes of SSM state a decode step at B = 16 reads and writes (fp32;
    none outside the ssm and hybrid families)."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    return 2 * 16 * cfg.n_layers * cfg.ssm_heads * cfg.ssm_headdim \
        * cfg.ssm_state * 4


def step_bound_ms(pred) -> float:
    """Least ms of a decode step at B = 16: every weight read once over
    3.35 TB/s (a moe step's 16 x top-k slots reach every expert, and the
    batched expert product reads all E experts' weights), and an SSM's
    state read and written. The embedding table is counted whole, as
    PERF.md's earlier bounds count it."""
    return (weight_bytes(pred) + state_bytes(pred.cfg)) / HBM_BYTES_PER_S \
        * 1e3


def _free_card() -> None:
    """Let go of what only reference cycles still hold (finished services
    and their jobs keep a predictor's caches), then return the cached
    blocks to the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _peak(what: str) -> int:
    """Log and return the peak of allocated device memory since the last
    reset."""
    import torch
    peak = torch.cuda.max_memory_allocated()
    log(f"[memory] {what}: peak {peak / 2**30:.2f} GiB allocated")
    return peak


def phase_service(arch: str, sizes=SERVICE_JOBS, baselines: bool = True,
                  fresh: bool = True) -> dict:
    """The service round trip of config ``arch`` (a ``config`` spec) at
    full width (phase 3 for qwen3-1.7b, phase 8 for mamba2-130m, phase 15
    for zamba2-7b, phase 17 for h2o-danube-3-4b, deepseek-7b with either
    cache and qwen3-14b), then the same containers through speculative
    decompression (phase 10). ``baselines``: the eager step's times, the
    jobs again through a ``PhaseReport`` each way, and phase 10's
    lock-step baseline. ``fresh``: the containers decompressed in a fresh
    process here; else the caller gets them (``out["fresh"]``) for
    ``fresh_decompress``."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.data.synthetic import human_like
    from repro_torch.data.tokenizer import encode
    from repro_torch.kernels import ops
    from repro_torch.serve import graphs
    from repro_torch.serve.engine import ModelPredictor
    from repro_torch.service import CompressionService
    cfg = config(arch)
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred = ModelPredictor.random_init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[service] {arch} random init (seed 0, {cfg.dtype}): "
        f"{sum(t.numel() for t in _leaves(pred.params)) / 1e9:.3f} B "
        f"params in {time.perf_counter() - t0:.1f} s")
    init_peak = _peak(f"{arch} init_params (each leaf drawn in fp32, then "
                      f"cast)")
    step_bound = step_bound_ms(pred)
    graphs.reset_stats()

    # cuBLAS + kernels at a fixed batch: a lane's logits must not depend
    # on which lane it is. Permute the lanes of one decode step. (Each
    # logits buffer is the captured step's own: copy it out.)
    B = 16
    pred.set_decode_len(128)
    toks = np.arange(B, dtype=np.int64) * 37 % cfg.vocab_size
    perm = np.roll(np.arange(B), 5)
    la = pred.decode_step(pred.begin_decode(B), toks)[0].clone()
    first_capture_ms = graphs.STATS["capture_ms"]
    lb, _ = pred.decode_step(pred.begin_decode(B), toks[perm])
    if not torch.equal(la[torch.as_tensor(perm, device="cuda")], lb):
        fail("decode-step logits change with the lane a sequence runs on")
    # lane 0 keeps its token while the other lanes' tokens are permuted
    # among them (in the moe family the permutations move where each
    # token lands in its experts' buffers)
    rest = np.concatenate([[0], 1 + np.roll(np.arange(B - 1), 3)])
    lc, _ = pred.decode_step(pred.begin_decode(B), toks[rest])
    if not torch.equal(la[0], lc[0]):
        fail("lane 0's decode-step logits change when the other lanes' "
             "tokens are permuted")
    log("[service] lane permutation: decode-step logits bit-identical; "
        "lane 0's with the other lanes permuted too")
    log(f"[service] digests: weights {_digest(_leaves(pred.params))}, "
        f"first decode-step logits {_digest([la])}")
    log(f"[graph] {arch}: first capture of the step (B=16, S=128) "
        f"{first_capture_ms:.1f} ms, its eager warm-up included")
    svc = CompressionService(pred, slots=16, chunk_size=128, topk=48)
    texts = [human_like(d, n, seed=s) for d, n, s in sizes]
    n_tok = sum(len(t) for t in texts)
    ops.reset_launches()
    graphs.reset_stats()
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
    stats = dict(graphs.STATS)
    for i, t in enumerate(texts):
        if not np.array_equal(outs[i], encode(t)):
            fail(f"service round trip: job {i} differs after decompress")
    for k in decode_kernels(cfg):
        if launches[k] <= 0:
            fail(f"main path launched {k} {launches[k]} times")
    _check_captured_launches(cfg, launches, stats, steps_c + steps_d,
                             "service round trip")

    # bare steps: captured against eager, bit for bit, then timed: the
    # before and after in one run
    g, e = graph_against_eager(pred)
    snap = pred.snapshot_slot(g, 0)
    snap_bytes = sum(t.numel() * t.element_size() for t in snap.values())
    log(f"[prefix] {arch}: one lane's snapshot (S=128) is {snap_bytes} B "
        f"on the card")
    steps = time_steps(pred, g, e, eager=baselines)
    del g, e, snap
    # the host's share of a service step outside the model: a PhaseReport
    # over the four jobs each way, traced (the model span waits for the
    # device while a timeline records). The round trip's services are let
    # go first, so the traced ones take over their cache and graphs.
    del svc, handles
    phases = {}
    tsvc = None
    for kind in ("compress", "decompress") if baselines else ():
        rec = obs.TimelineRecorder()
        tsvc = CompressionService(pred, slots=16, chunk_size=128, topk=48,
                                  trace=rec)
        hs = [tsvc.submit_compress(encode(t)) for t in texts] \
            if kind == "compress" else \
            [tsvc.submit_decompress(b) for b in blobs]
        for h in hs:
            h.result()
        tsvc.close()
        rep = obs.PhaseReport.from_events(rec.events(), dropped=rec.dropped)
        phases[kind] = dict(total_ms=rep.total_s * 1e3,
                            coverage=rep.coverage,
                            share={k: v / rep.total_s
                                   for k, v in rep.phases.items()})
        log(f"[phases] {arch} {kind} of the 4 jobs, traced "
            f"({rep.total_s * 1e3:.1f} ms, coverage {rep.coverage:.1%}): "
            + ", ".join(f"{k} {v:.1%}" for k, v in sorted(
                phases[kind]["share"].items()) if v > 0))
    log(f"[graph] {label(cfg)} captured step bound: "
        f"{weight_bytes(pred) / 1e9:.3f} GB of weights and "
        f"{state_bytes(cfg) / 1e9:.3f} GB of SSM state over 3.35 TB/s = "
        f"{step_bound:.3f} ms; the captured step's device time is "
        + ("not measured" if steps["captured"]["device_ms"] is None else
           f"{steps['captured']['device_ms'] / step_bound:.2f} x it"))
    out = dict(tokens=n_tok, bytes_in=n_tok,
               bytes_out=sum(len(b) for b in blobs),
               compress_s=t_c, decompress_s=t_d,
               compress_tok_s=n_tok / t_c, decompress_tok_s=n_tok / t_d,
               compress_steps=steps_c, decompress_steps=steps_d,
               service_step_ms=(t_c + t_d) / (steps_c + steps_d) * 1e3,
               steps=steps, graph_stats=stats, launches=launches,
               phases=phases, snapshot_bytes=snap_bytes,
               init_peak_bytes=init_peak, step_bound_ms=step_bound)
    log(f"[service] {len(texts)} jobs, {n_tok} tokens: compress "
        f"{t_c:.2f} s ({n_tok / t_c:.0f} tok/s, {steps_c} steps), "
        f"decompress {t_d:.2f} s ({n_tok / t_d:.0f} tok/s, {steps_d} steps)"
        f", {out['bytes_out']} container bytes; byte-identical in reorder "
        f"{order}")
    eager = "not timed" if "eager" not in steps else \
        f"{steps['eager']['host_ms']:.3f} ms"
    log(f"[service] mean service step {out['service_step_ms']:.2f} ms; "
        f"captured step alone {steps['captured']['host_ms']:.3f} ms (eager "
        f"{eager}); graphs in the round trip: "
        f"{stats['captures']} captures ({stats['capture_ms']:.1f} ms), "
        f"{stats['step_replays']} replays, {stats['warmup_steps']} warm-up "
        f"steps; launches {launches} = per step x (replays + warm-ups)")
    out["spec"] = phase_speculative(pred, blobs, texts, baselines)
    out["peak_bytes"] = _peak(f"{arch} service, graphs and speculative "
                              f"decode")
    del pred, tsvc
    _free_card()

    # the user's flow: decompression in a process of its own (now, or
    # with the other configs of phase 17 in one process: ``fresh``)
    work = ROOT / "build" / "chip_smoke" / f"full_width_{arch}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for i, b in enumerate(blobs):
        (work / f"job{i}.llmc").write_bytes(b)
    if fresh:
        fresh_decompress({arch: (work, texts)})
    else:
        out["fresh"] = (work, texts)
    return out


def fresh_decompress(jobs: dict) -> None:
    """The user's flow: decompression in a process of its own, which
    builds each predictor from the seed again, jobs in a third order.
    ``jobs``: {arch: (directory of its job*.llmc, the jobs' texts)}, all
    decoded by one new interpreter, each model freed before the next."""
    import numpy as np
    from repro_torch.data.tokenizer import encode
    order = [1, 3, 0, 2]
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke"
         ".decompress_in_fresh_process(*sys.argv[1:]))",
         ",".join(map(str, order)),
         *(f"{work}={arch}" for arch, (work, _) in jobs.items())],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        fail(f"fresh-process decompression exited {r.returncode}:\n"
             f"{r.stdout}\n{r.stderr}")
    for arch, (work, texts) in jobs.items():
        for i, t in enumerate(texts):
            if not np.array_equal(np.load(work / f"job{i}.npy"), encode(t)):
                fail(f"fresh-process decompression: {arch} job {i} differs")
    log(f"[service] {', '.join(jobs)} decompressed again in a fresh process "
        f"(seed 0 re-init, order {order}): byte-identical "
        f"({time.perf_counter() - t0:.1f} s with start-up)")


# ---------------------------------------------------------- phase 10
def phase_speculative(pred, blobs, texts, lockstep: bool = True) -> dict:
    """The service's containers through the grouped decompressor, lock-
    step (the baseline, when ``lockstep``) and speculative (``draft_k=4``:
    the suffix self-draft, one captured verify program over 5 positions
    per round, each lane rolled back to what it accepted): byte identity,
    rounds, verify programs against lock-step steps, draft acceptance and
    wall time."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import LLMCompressor
    from repro_torch.data.tokenizer import encode
    from repro_torch.kernels import ops
    from repro_torch.serve import graphs
    res = {}
    for name, k in (("lock-step", 0), ("speculative", 4))[
            0 if lockstep else 1:]:
        reg = obs.MetricsRegistry()
        comp = LLMCompressor(pred, chunk_size=128, topk=48, decode_batch=16,
                             draft_k=k, registry=reg)
        ops.reset_launches()
        graphs.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [comp.decompress(b) for b in blobs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for i, t in enumerate(texts):
            if not np.array_equal(outs[i], encode(t)):
                fail(f"{name} grouped decompression: job {i} differs")
        st = dict(graphs.STATS)
        offered = reg.value("spec.drafted_tokens")
        res[name] = dict(
            wall_s=wall, step_replays=st["step_replays"],
            verify_replays=st["verify_replays"], captures=st["captures"],
            capture_ms=st["capture_ms"], rounds=reg.value("spec.rounds"),
            offered=offered, accepted=reg.value("spec.drafted_accepted"),
            fallthroughs=reg.value("spec.lockstep_fallthroughs"),
            launches=dict(ops.LAUNCHES))
    spec = res["speculative"]
    if spec["verify_replays"] <= 0 or spec["rounds"] != \
            spec["verify_replays"]:
        fail(f"speculative decode: {spec['rounds']} rounds but "
             f"{spec['verify_replays']} verify replays")
    acc = spec["accepted"] / spec["offered"] if spec["offered"] else 0.0
    lock = res.get("lock-step")
    base = "lock-step not run" if lock is None else (
        f"lock-step {lock['wall_s'] * 1e3:.0f} ms ({lock['step_replays']} "
        f"captured steps)")
    ratio = "" if lock is None else \
        f" ({spec['wall_s'] / lock['wall_s']:.2f}x)"
    log(f"[spec] {label(pred.cfg)} grouped decompress of {len(blobs)} "
        f"containers, byte-identical: {base}; speculative (draft_k=4) "
        f"{spec['wall_s'] * 1e3:.0f} ms{ratio}: {spec['rounds']} "
        f"rounds = {spec['verify_replays']} verify replays + "
        f"{spec['step_replays']} lock-step steps (fall-throughs "
        f"{spec['fallthroughs']}), draft acceptance {acc:.1%} "
        f"({spec['accepted']} of {spec['offered']}); captures "
        f"{spec['captures']} ({spec['capture_ms']:.0f} ms); launches "
        f"{spec['launches']}")
    return res


def profile_calls(fn, n: int = 5):
    """torch.profiler over ``n`` calls of ``fn``: logs the operators by
    device time; returns, per call, device ms, kernels run on the device
    and host launch calls (kernel launches and graph launches). A session
    whose trace came back without device events is taken again, as in
    ``device_ms``; after five, device ms and kernels are None (not
    measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(5):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        api = sum(e.count for e in ka if e.key.startswith(
            ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")))
        dev = [e for e in ka if _on_device(e)]
        dev_us = sum(e.self_device_time_total for e in dev)
        if dev_us > 0:
            log(ka.table(sort_by="self_cuda_time_total", row_limit=12))
            kernels = sum(e.count for e in dev
                          if not e.key.startswith(("Memcpy", "Memset")))
            return dev_us / 1e3 / n, kernels / n, api / n
        log(f"[profiler] session {attempt + 1} saw no device events")
    log("[profiler] device time not measured (five sessions recorded no "
        "device events)")
    return None, None, api / n


def _idle(dev, host: float) -> str:
    return "not measured" if dev is None else f"{1 - dev / host:.1%}"


def _count(x) -> str:
    return "not measured" if x is None else f"{x:.0f}"


def decompress_in_fresh_process(order: str, *pairs) -> int:
    """The second half of phases 3, 8, 15 and 17, run by a new
    interpreter: for each ``WORK=ARCH`` of ``pairs``, ARCH (a ``config``
    spec) from seed 0 again, the containers saved in WORK decompressed in
    ``order`` (job numbers, comma-separated), the tokens saved beside
    them; each model freed before the next."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.serve.engine import ModelPredictor
    from repro_torch.service import CompressionService
    for pair in pairs:
        work, arch = pair.rsplit("=", 1)
        work = pathlib.Path(work)
        pred = ModelPredictor.random_init(config(arch), seed=0,
                                          device="cuda")
        svc = CompressionService(pred, slots=16, chunk_size=128, topk=48)
        handles = {int(i): svc.submit_decompress(
            (work / f"job{i}.llmc").read_bytes()) for i in order.split(",")}
        for i, h in handles.items():
            np.save(work / f"job{i}.npy", h.result())
        del pred, svc, handles
        _free_card()
    return 0


def _digest(tensors) -> str:
    """First 16 hex digits of the sha256 of the tensors' raw bytes: tells
    two runs (other machines, other driver versions) whether their
    weights, or their logits, differ at all."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ----------------------------------------------------------- phase 4
# Tolerance of teacher-forced scoring against the decode program, both
# bf16 with fp32 accumulation. The two run different GEMM shapes (M =
# B*S against M = B, so cuBLAS picks other kernels and sum orders) and
# different attention kernels, so each bf16-rounded activation (half an
# ulp is 2**-9 relative) can land one ulp apart, and 28 residual layers
# compound such differences. SCORE_TOL bounds max |difference| relative
# to the largest |logit| of the decode program: 2**-4 is 16 bf16 ulps of
# the logit scale. The shares of positions whose top-1 id and top-48 id
# sets agree are printed, not held: in a random model at V = 151936 the
# leading logits sit closer together than that tolerance.
SCORE_TOL = 2.0 ** -4
# mamba2-130m is not held to that bound: its first chip run missed it
# under the prefix (max |dlogit| 31.5 of 168), and the JAX package's own
# forward and decode programs of this model sit as far apart in bf16
# (tests/test_torch_ssm.py holds the port's gap to the reference's). In
# a random 24-layer SSM a rounding difference grows from layer to layer
# (dt feeds exp(dt A) with |A| up to 16). So the function is held in
# fp32, where the two programs agree to SCORE_TOL_FP32 of max |logit|;
# and in bf16 the distance between scoring and the decode program, mean
# and max, is held to twice the distance bf16 rounding alone puts
# between the decode program and its fp32 twin (same seed): each bf16
# program carries a rounding error of about that size.
# The moe family is held through its fp32 twin too, for another reason:
# a router near-tie. Where the two programs' roundings break a near-tie
# among a token's k-th and (k+1)-th experts differently, the token goes
# to another expert: a jump, not a rounding difference, and it reaches
# the lane's later positions through attention. In bf16 the router's
# logits are rounded, so such ties are common among 32-128 experts
# (qwen3-moe cut to 4 layers, on an H100: max |dlogit| 0.512 against
# SCORE_TOL's 0.338, mean 0.013); in fp32 they are rare but not absent
# (granite-moe's twin: one position at 0.067, mean 2.2e-5). So the fp32
# twin is held routing by routing (``_moe_twin_check``): the two
# programs' router decisions are recorded; every position before a
# lane's first differing decision is held to SCORE_TOL_FP32, and each
# lane's first differing decision must be a near-tie that rounding alone
# breaks (the two programs' router logits there within SCORE_TOL_FP32 of
# their scale).
SCORE_TOL_FP32 = 2.0 ** -10
#: positions of an fp32 moe twin's check that lie before their lane's
#: first router difference, at least (else the check would hold little)
MOE_CLEAN_SHARE = 0.5


def _compare_logits(what: str, scored, decoded, tol=SCORE_TOL,
                    fp32_twin=None) -> dict:
    """max |scored - decoded| <= tol x max |decoded|; or, given the
    decode program's logits in fp32 (``fp32_twin``), mean and max
    |scored - decoded| <= 2 x those of |decoded - fp32_twin|."""
    import torch
    a, b = scored.float(), decoded.float()
    diff = (a - b).abs()
    scale = b.abs().max().item()
    top = lambda x: torch.topk(x, 48, dim=-1).indices.sort(  # noqa: E731
        dim=-1).values
    r = dict(max_abs_diff=diff.max().item(), mean_abs_diff=diff.mean()
             .item(), max_abs_logit=scale,
             top1_agree=(a.argmax(-1) == b.argmax(-1)).float().mean().item(),
             top48_sets_agree=(top(a) == top(b)).all(-1).float().mean()
             .item())
    if fp32_twin is None:
        held = f"tol {tol} x max |logit| {scale:.4g}"
        ok = r["max_abs_diff"] <= tol * scale
    else:
        rd = (b - fp32_twin.float()).abs()
        r.update(twin_mean_abs_diff=rd.mean().item(),
                 twin_max_abs_diff=rd.max().item())
        held = (f"max |logit| {scale:.4g}; held to 2 x the bf16-vs-fp32 "
                f"decode distance, mean {r['twin_mean_abs_diff']:.3g} max "
                f"{r['twin_max_abs_diff']:.4g}")
        ok = r["mean_abs_diff"] <= 2 * r["twin_mean_abs_diff"] \
            and r["max_abs_diff"] <= 2 * r["twin_max_abs_diff"]
    log(f"[score] {what}: max |dlogit| {r['max_abs_diff']:.4g} ({held}), "
        f"mean {r['mean_abs_diff']:.3g}; top-1 ids agree "
        f"{r['top1_agree']:.4f}, top-48 id sets agree "
        f"{r['top48_sets_agree']:.4f}")
    if not ok:
        fail(f"{what}: scoring disagrees with the decode program: {r}")
    return r


def _decode_logits(pred, chunks, prefix=None):
    """The decode program's logits for ``chunks`` (B, C): the steps the
    service takes, after ``begin_decode(prefix)``."""
    import numpy as np
    import torch
    B, C = chunks.shape
    state = pred.begin_decode(B, prefix=prefix)
    prev = prefix[:, -1] if prefix is not None else np.full(B, pred.bos_id)
    out = []
    for t in range(C):
        lg, state = pred.decode_step(state, prev)
        out.append(lg.clone())       # the captured step's buffer: copy it
        prev = chunks[:, t]
    return torch.stack(out, dim=1)


def score_launches(cfg) -> dict:
    """The kernels of each family's teacher-forced forward and their
    launches per forward: ``flash_attention`` per attention block,
    ``ssd_intra`` per SSD layer (zamba2-7b: 6 and 81)."""
    out = {}
    if attention_blocks(cfg):
        out["flash_attention"] = attention_blocks(cfg)
    if cfg.family in ("ssm", "hybrid"):
        out["ssd_intra"] = cfg.n_layers
    return out


def _check_score_launches(cfg, launches, what: str, forwards: int = 1):
    for k, per in score_launches(cfg).items():
        if launches[k] != per * forwards:
            fail(f"{what} launched {k} {launches[k]} times, not {per} per "
                 f"forward x {forwards}")


def phase_scoring(pred) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import LLMCompressor
    from repro_torch.data.synthetic import human_like
    from repro_torch.data.tokenizer import encode
    from repro_torch.kernels import ops
    B, C, P = 16, 128, 32
    toks = encode(human_like("wiki", 3 * B * C, seed=11))
    chunks = toks[:B * C].reshape(B, C).astype(np.int64)
    prefix = toks[B * C:B * (C + P)].reshape(B, P).astype(np.int64)
    pred.set_decode_len(C + P + 1)
    ops.reset_launches()
    scored = pred.score_chunks(chunks)
    torch.cuda.synchronize()
    _check_score_launches(pred.cfg, ops.LAUNCHES, "score_chunks")
    if not bool(torch.isfinite(scored).all()):
        fail(f"{pred.cfg.name}: score_chunks gave non-finite logits "
             f"({int((~torch.isfinite(scored)).sum())} of {scored.numel()})")
    t0 = time.perf_counter()
    for _ in range(5):
        pred.score_chunks(chunks)
    torch.cuda.synchronize()
    score_ms = (time.perf_counter() - t0) / 5 * 1e3
    score_dev_ms, score_launches, _ = profile_calls(
        lambda: pred.score_chunks(chunks), 3)
    if pred.cfg.family == "dense":
        fresh = _compare_logits("fresh context", scored,
                                _decode_logits(pred, chunks))
        pre = _compare_logits("32-token prefix",
                              pred.score_chunks(chunks, prefix=prefix),
                              _decode_logits(pred, chunks, prefix))
    else:
        fresh, pre = _compare_with_fp32_twin(pred, chunks, prefix)
    comp = LLMCompressor(pred, chunk_size=C, topk=48, decode_batch=B)
    ops.reset_launches()
    blob_x, st_x = comp.compress(chunks.ravel())
    blob_e, st_e = comp.compress(chunks.ravel(), exact=False)
    torch.cuda.synchronize()
    _check_score_launches(pred.cfg, ops.LAUNCHES, "compress(exact=False)")
    log(f"[score] {pred.cfg.name} score_chunks ({B} x {C}) "
        f"{score_ms:.2f} ms, of it on the "
        f"device {_ms(score_dev_ms, 2)} (idle "
        f"{_idle(score_dev_ms, score_ms)}), {_count(score_launches)} kernel "
        f"launches; "
        f"compress(exact=True) {len(blob_x)} B, compress(exact=False) "
        f"{len(blob_e)} B ({len(blob_e) / len(blob_x) - 1:+.4%}); ideal "
        f"{st_x.ideal_bits / 8:.0f} / {st_e.ideal_bits / 8:.0f} B")
    return dict(score_ms=score_ms, score_device_ms=score_dev_ms,
                score_launches=score_launches, fresh=fresh, prefix=pre,
                exact_bytes=len(blob_x), estimate_bytes=len(blob_e))


def _compare_with_fp32_twin(pred, chunks, prefix):
    """Scoring against the decode program for a model whose bf16 programs
    drift apart, or whose bf16 router ties break apart (see
    SCORE_TOL_FP32): the fp32 twin (same config and seed in float32; the
    fp32 kernels) held to SCORE_TOL_FP32, then the bf16 model held
    against its twin."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ModelPredictor
    twin = ModelPredictor.random_init(pred.cfg.with_(dtype="float32"),
                                      seed=0, device="cuda")
    out = []
    for what, pre in (("fresh context", None), ("32-token prefix", prefix)):
        if twin.cfg.family == "moe":
            d32 = _moe_twin_check(twin, chunks, pre, f"fp32 {what}")
        else:
            ops.reset_launches()
            s32 = twin.score_chunks(chunks, prefix=pre)
            torch.cuda.synchronize()
            _check_score_launches(twin.cfg, ops.LAUNCHES,
                                  "fp32 score_chunks")
            d32 = _decode_logits(twin, chunks, pre)
            _compare_logits(f"fp32 {what}", s32, d32, tol=SCORE_TOL_FP32)
        out.append(_compare_logits(
            what, pred.score_chunks(chunks, prefix=pre),
            _decode_logits(pred, chunks, pre), fp32_twin=d32))
    del twin
    _free_card()
    return out


def _with_routes(fn):
    """``fn()`` with the moe router's decisions recorded: (its result,
    [(router logits (T, E) fp32, experts (T, k))] per ``moe.route`` call,
    in call order). The logits are the router's product computed once
    more on the same input (the same shapes: the same bits)."""
    from repro_torch.models import moe
    store, route = [], moe.route

    def recording(x_flat, router_w, top_k):
        out = route(x_flat, router_w, top_k)
        store.append(((x_flat @ router_w).float(), out[1]))
        return out
    moe.route = recording
    try:
        return fn(), store
    finally:
        moe.route = route


def _moe_twin_check(twin, chunks, prefix, what: str):
    """fp32 moe scoring against the fp32 decode program, router decision
    by router decision (see SCORE_TOL_FP32): scoring and the eager decode
    program (bit-identical to the captured step, phases 3 and 19-20) run
    with their routes recorded over the same N inputs [BOS, prefix,
    chunk[:-1]]. A lane's positions before its first differing expert
    set (any layer) are held to SCORE_TOL_FP32 of max |logit|, and that
    first difference must be a rounding-size near-tie: the two programs'
    router logits there within SCORE_TOL_FP32 of the decode program's
    largest |router logit|. At least MOE_CLEAN_SHARE of the scored
    positions must lie before their lane's first difference. Returns the
    decode program's logits of the chunk positions."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    B, C = chunks.shape
    L = twin.cfg.n_layers
    inp = np.concatenate([np.full((B, 1), twin.bos_id)]
                         + ([] if prefix is None else [prefix])
                         + [chunks[:, :-1]], 1)
    N = inp.shape[1]
    ops.reset_launches()
    scored, rs = _with_routes(lambda: twin.score_chunks(chunks,
                                                        prefix=prefix))
    torch.cuda.synchronize()
    _check_score_launches(twin.cfg, ops.LAUNCHES, "fp32 score_chunks")
    cache = twin._init_cache(B, N)
    decoded, rd = _with_routes(lambda: torch.stack(
        [twin._eager_decode_step(cache, inp[:, t])[0].clone()
         for t in range(N)], 1))
    if len(rs) % L or len(rd) != N * L:
        fail(f"{what}: {len(rs)} and {len(rd)} router calls for {L} "
             f"layers and {N} steps")
    per = len(rs) // L                  # dispatch groups a layer

    def stacked(calls, i):              # scoring: layer-major, groups
        return torch.stack([torch.cat([c[i] for c in calls[l * per:
                                                           (l + 1) * per]])
                            for l in range(L)]).view(L, B, N, -1)
    ls, es = stacked(rs, 0), stacked(rs, 1)
    # decode: step-major, a layer a call, (B, .) each
    ld = torch.stack([c[0] for c in rd]).view(N, L, B, -1).permute(1, 2, 0,
                                                                   3)
    ed = torch.stack([c[1] for c in rd]).view(N, L, B, -1).permute(1, 2, 0,
                                                                   3)
    flip = (es.sort(-1).values != ed.sort(-1).values).any(-1)   # (L, B, N)
    lane_flip = flip.any(0)                                      # (B, N)
    clean = lane_flip.cumsum(-1) == 0    # before the lane's first flip
    router_scale = ld.abs().max().item()
    first = []
    for b in range(B):
        if bool(lane_flip[b].any()):
            t = int(lane_flip[b].float().argmax().item())
            layer = int(flip[:, b, t].float().argmax().item())
            first.append((ls[layer, b, t] - ld[layer, b, t]).abs().max()
                         .item())
    dec = decoded[:, N - C:]
    keep = clean[:, N - C:]
    diff = (scored.float() - dec.float()).abs().amax(-1)         # (B, C)
    scale = dec.abs().max().item()
    held = diff[keep].max().item() if bool(keep.any()) else 0.0
    share = keep.float().mean().item()
    worst = max(first, default=0.0)
    log(f"[score] {what}: {int(flip.sum())} of {flip.numel()} router "
        f"decisions differ between scoring and the decode program, "
        f"{len(first)} of {B} lanes; first differences at router-logit "
        f"distance <= {worst:.3g} (limit {SCORE_TOL_FP32 * router_scale:.3g}"
        f"); the {share:.1%} of positions before them: max |dlogit| "
        f"{held:.4g} (tol {SCORE_TOL_FP32} x max |logit| {scale:.4g}); all "
        f"positions: max {diff.max().item():.4g}, mean "
        f"{(scored.float() - dec.float()).abs().mean().item():.3g}")
    if held > SCORE_TOL_FP32 * scale or worst > SCORE_TOL_FP32 * \
            router_scale or share < MOE_CLEAN_SHARE:
        fail(f"{what}: scoring disagrees with the decode program beyond "
             f"router near-ties (clean max {held}, first router distance "
             f"{worst}, clean share {share})")
    return dec


# ----------------------------------------------------------- phase 5
def routed_jobs():
    """Two mixed jobs for the routed service: synthetic text, random
    bytes and long runs of one byte, so that each fallback has a reason
    to win some chunk (at most 64 chunks of 128 each)."""
    import numpy as np
    from repro_torch.data.synthetic import human_like
    from repro_torch.data.tokenizer import encode
    rng = np.random.default_rng(21)
    a = np.concatenate([encode(human_like("web", 1500, seed=21)),
                        rng.integers(0, 256, 768), np.full(640, 65)])
    b = np.concatenate([np.full(900, 32), rng.integers(0, 256, 640),
                        encode(human_like("code", 1300, seed=22))])
    return [a.astype(np.int32), b.astype(np.int32)]


def phase_routed(pred) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import read_header, read_index
    from repro_torch.core.cdf import to_numpy
    from repro_torch.core.router import estimate_chunk_bits
    from repro_torch.kernels import ops
    from repro_torch.service import CompressionService
    jobs = routed_jobs()
    kw = dict(slots=16, chunk_size=128, topk=48)
    svc = CompressionService(pred, route="auto", **kw)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = [svc.submit_compress(t) for t in jobs]
    blobs = [h.result()[0] for h in handles]
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    svc = CompressionService(pred, **kw)
    order = list(reversed(range(len(jobs))))
    t0 = time.perf_counter()
    handles = {i: svc.submit_decompress(blobs[i]) for i in order}
    outs = {i: handles[i].result() for i in order}
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    for i, t in enumerate(jobs):
        if not np.array_equal(outs[i], t):
            fail(f"routed round trip: job {i} differs after decompress")
    # one probe (a teacher-forced forward) per job
    _check_score_launches(pred.cfg, launches, "routed compress", len(jobs))
    counts: dict = {}
    for b in blobs:
        for e in read_index(b, read_header(b)).entries:
            counts[e.codec_name] = counts.get(e.codec_name, 0) + 1
    # the probe of job 0 alone, timed: its device scoring, then the
    # host's float64 estimate
    C, P = 128, 32
    t = jobs[0]
    n = -(-t.size // C)
    chunks = np.zeros((n, C), np.int32)
    chunks.ravel()[:t.size] = t
    valid = np.minimum(C, t.size - C * np.arange(n))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg = pred.score_chunks(chunks[:, :P])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    estimate_chunk_bits(to_numpy(lg), chunks, valid, P)
    t2 = time.perf_counter()
    n_chunks = sum(counts.values())
    log(f"[routed] {pred.cfg.name}: {len(jobs)} jobs, "
        f"{sum(t.size for t in jobs)} tokens, "
        f"{n_chunks} chunks: decisions {counts}; compress {t_c:.2f} s, "
        f"decompress (other service, order {order}) {t_d:.2f} s, "
        f"byte-identical; probe of job 0 ({n} chunks): score "
        f"{(t1 - t0) * 1e3:.2f} ms + host estimate {(t2 - t1) * 1e3:.1f} "
        f"ms; launches {launches}")
    return dict(decisions=counts, launches=launches, compress_s=t_c,
                decompress_s=t_d, probe_chunks=n,
                probe_score_ms=(t1 - t0) * 1e3,
                probe_estimate_ms=(t2 - t1) * 1e3)


# ---------------------------------------------------------- phase 11
def phase_shared_prefix(pred) -> dict:
    """Two jobs through one service with the same 32-token shared prefix:
    the second restores the prefilled cache lane from the radix prefix
    cache (``prefix_cache.hits`` rises while it runs), both round-trip
    byte for byte, and the second's container equals the one a fresh
    service, whose cache misses, writes for it."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import human_like
    from repro_torch.data.tokenizer import encode
    from repro_torch.service import CompressionService
    sp = encode(human_like("article", 64, seed=21))[:32]
    jobs = [encode(human_like("wiki", 1500, seed=31)),
            encode(human_like("web", 1200, seed=32))]
    # the cache counts tokens, not bytes: a small capacity keeps a
    # zamba2-7b lane snapshot (~149 MB of SSM state) to a few entries
    kw = dict(slots=16, chunk_size=128, topk=48, prefix_cache_tokens=256)
    svc = CompressionService(pred, **kw)
    reg = svc.registry
    t0 = time.perf_counter()
    blob0 = svc.submit_compress(jobs[0], shared_prefix=sp).result()[0]
    hits0 = reg.value("prefix_cache.hits")
    blob1 = svc.submit_compress(jobs[1], shared_prefix=sp).result()[0]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hits1 = reg.value("prefix_cache.hits") - hits0
    if hits1 < 1:
        fail(f"shared prefix: the second job hit the prefix cache {hits1} "
             f"times")
    for i, blob in enumerate((blob0, blob1)):
        if not np.array_equal(svc.submit_decompress(blob).result(),
                              jobs[i]):
            fail(f"shared prefix: job {i} differs after decompress")
    fresh = CompressionService(pred, **kw)
    again = fresh.submit_compress(jobs[1], shared_prefix=sp).result()[0]
    if again != blob1:
        fail("shared prefix: a fresh service (cache miss) writes another "
             "container for the second job")
    if not np.array_equal(CompressionService(pred, **kw).submit_decompress(
            blob1).result(), jobs[1]):
        fail("shared prefix: a fresh service decodes job 1 differently")
    snap = svc.prefix_cache.lookup(sp)[1]
    snap_bytes = sum(t.numel() * t.element_size() for t in snap.values())
    log(f"[prefix] {label(pred.cfg)}: 2 jobs with one 32-token shared "
        f"prefix in {dt:.2f} s; the second hit the cache {hits1} times "
        f"(hits {reg.value('prefix_cache.hits')}, misses "
        f"{reg.value('prefix_cache.misses')}, tokens reused "
        f"{reg.value('prefix_cache.tokens_reused')}); both round-trip, "
        f"and a fresh service writes job 1's {len(blob1)} B byte for "
        f"byte; a stored snapshot (S=160) is {snap_bytes} B on the card")
    return dict(hits=hits1, snapshot_bytes=snap_bytes)


# ----------------------------------------------------------- phase 6
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


def phase_mismatch() -> dict:
    """A pred-base top-k archive decoded under another seed's weights:
    ``LLMCompressor`` and ``CompressionService`` raise ``ContainerError``
    (an escape id past the vocabulary is caught on the host, before the
    embedding gather would assert on the card), and the CUDA context
    then decodes the archive under the right weights byte for byte."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_predictors import PRED_BASE
    from repro_torch.core import LLMCompressor
    from repro_torch.core.compressor import ContainerError
    from repro_torch.serve.engine import ModelPredictor
    from repro_torch.service import CompressionService
    # 16 chunks: the archive records 16 lanes, the services' slot count
    toks = np.random.default_rng(7).integers(0, 256, 2048).astype(np.int32)
    kw = dict(chunk_size=128, topk=48)
    writer = ModelPredictor.random_init(PRED_BASE, seed=0, device="cuda")
    other = ModelPredictor.random_init(PRED_BASE, seed=1, device="cuda")
    blob, _ = LLMCompressor(writer, decode_batch=16, container_version=4,
                            **kw).compress(toks)
    errors = {}
    for what, run in (
            ("LLMCompressor", lambda: LLMCompressor(
                other, decode_batch=16, **kw).decompress(blob)),
            ("CompressionService", lambda: CompressionService(
                other, slots=16, **kw).submit_decompress(blob).result())):
        try:
            run()
        except ContainerError as e:
            errors[what] = str(e)
        else:
            fail(f"{what} decoded a top-k archive under other weights "
                 f"without ContainerError")
    torch.cuda.synchronize()        # a device-side assert would show here
    back = CompressionService(writer, slots=16, **kw).submit_decompress(
        blob).result()
    torch.cuda.synchronize()
    if not np.array_equal(back, toks):
        fail("the right weights failed to decode after a mismatched one")
    for what, msg in errors.items():
        log(f"[mismatch] {what}: ContainerError: {msg}")
    log("[mismatch] the CUDA context then decoded the archive under the "
        "writer's weights byte for byte")
    return errors


# ----------------------------------------------------------- phase 7
def _cli_env(cache=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if cache is not None:
        env["REPRO_TORCH_CACHE"] = str(cache)
    return env


def _start_cli(cmd, env, predictor=True):
    """``python -m repro_torch.cli CMD`` started in a new process."""
    args = [*cmd, "--predictor", "pred-base"] if predictor else cmd
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.cli", *args],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, cmd, time.perf_counter()


def _finish_cli(started) -> str:
    """Wait for a command of ``_start_cli``; fails on a non-zero exit;
    logs its stdout and its time with start-up."""
    proc, cmd, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"llmc-torch {cmd[0]} ran past 600 s")
    flags = " ".join([cmd[0]] + [c for c in cmd[1:] if not c.startswith(
        str(ROOT))])
    if proc.returncode != 0:
        fail(f"llmc-torch {flags} exited {proc.returncode}:\n{out}\n{err}")
    short = out.strip()
    short = short if len(short) < 400 else f"{short[:200]} ... {short[-150:]}"
    log(f"[cli] {flags}: {short} ({time.perf_counter() - t0:.1f} s with "
        f"start-up)")
    return out


def _run_clis(*jobs) -> list[str]:
    """Commands (cmd, env[, predictor]) run side by side, each a new
    process (most of a command's time is its start-up); their stdouts in
    order."""
    started = [_start_cli(*job) for job in jobs]
    return [_finish_cli(st) for st in started]


def _in_process_cli(argv) -> tuple[str, dict, dict]:
    """``repro_torch.cli.main(argv)`` in this process, with the kernel
    launch counters and the graph counters set to 0 just before and read
    just after; returns (stdout, launches, graph stats)."""
    import contextlib
    import io
    import torch
    from repro_torch import cli as tcli
    from repro_torch.kernels import ops
    from repro_torch.serve import graphs
    buf = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launches()
    graphs.reset_stats()
    with contextlib.redirect_stdout(buf):
        rc = tcli.main([*argv, "--predictor", "pred-base"])
    torch.cuda.synchronize()
    launches, st = dict(ops.LAUNCHES), dict(graphs.STATS)
    if rc != 0:
        fail(f"in-process llmc-torch {argv[0]} returned {rc}")
    return buf.getvalue(), launches, st


def phase_cli() -> None:
    """``llmc-torch`` as a user runs it, each command a new process on the
    trained ``pred-base``: the three round trips (plain, ``--route auto``,
    context flags with ``--draft``), then every other verb and flag, and
    ``range`` / ``stats`` once more in this process with the launch
    counts read, and the span mirror under ``torch.profiler``. The first
    command trains ``pred-base`` alone; the rest run in two waves of
    processes side by side (the compressions and ``stats``, then what
    reads their archives)."""
    import numpy as np
    from repro_torch.data.synthetic import human_like
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    env = _cli_env()
    rng = np.random.default_rng(9)
    mixed = human_like("novel", 1200, seed=8) + bytes(
        rng.integers(0, 256, 600).astype(np.uint8)) + b"=" * 500
    pref = work / "prefix.txt"
    pref.write_bytes(b"Chapter one of a novel, as the corpus stores it.")
    ctx = ["--context-window", "16", "--shared-prefix", str(pref)]
    trips = (("", human_like("novel", 1500, seed=7), [], []),
             ("routed", mixed, ["--route", "auto"], []),
             ("context", human_like("novel", 1500, seed=6), ctx,
              ["--draft", "4"]))
    for tag, data, _, _ in trips:
        (work / f"in{tag}.txt").write_bytes(data)
    src, routed = work / "in.txt", work / "inrouted.txt"
    data = src.read_bytes()
    v3, arc_side = work / "in_v3.llmc", work / "in_side.llmc"
    trace = work / "in_side.trace.json"
    raw = work / "in_raw.llmc"
    n_chunks = -(-len(data) // 128)

    # the plain compress trains pred-base into the run's cache
    _run_clis((["compress", str(src), str(work / "in.llmc")], env))
    # wave 1: every other compression, stats in its three formats, and
    # what reads the plain archive
    outs = _run_clis(
        *[(["compress", str(work / f"in{tag}.txt"),
            str(work / f"in{tag}.llmc"), *extra], env)
          for tag, _, extra, _ in trips[1:]],
        (["compress", str(src), str(v3), "--v3"], env),
        (["compress", str(src), str(arc_side), "--sidecar", "--trace",
          str(trace)], env),
        (["compress", str(src), str(raw), "--route", "raw"], env),
        (["decompress", str(work / "in.llmc"), str(work / "back.txt")],
         env),
        (["range", str(work / "in.llmc"), str(work / "in.part"),
          "--chunks", "3:7"], env),
        (["stats"], env), (["stats", "--format", "prom"], env),
        (["stats", "--format", "text"], env))
    out_side, snap, prom, text = outs[3], json.loads(outs[7]), outs[8], \
        outs[9]
    side = json.loads((work / "in_side.llmc.diag.json").read_text())
    if side["kind"] != "compress" or len(side["chunks"]) != n_chunks:
        fail(f"compress sidecar: {side['kind']}, {len(side['chunks'])} "
             f"chunks, want {n_chunks}")
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("ph") == "X"}
    want = {"service.step", "service.refill", "model.decode_step",
            "coder.step", "service.finish_slot"}
    if not want <= names or "phases (" not in out_side:
        fail(f"--trace: spans {sorted(names)}, want {sorted(want)}; "
             f"stdout {out_side!r}")
    log(f"[cli] --trace: {len(names)} span names {sorted(names)}")
    done = snap["scheduler"]["chunks_completed"]
    if done != 2 * -(-2048 // 64):
        fail(f"stats: chunks_completed {done}, want 64")
    if "repro_scheduler_model_steps" not in prom or "occupancy" not in text:
        fail("stats --format prom / text: missing series")

    # wave 2: what reads wave 1's archives; the all-fallback archive by a
    # process with an empty cache: no predictor is trained or loaded (F7)
    empty = work / "empty_cache"
    shutil.rmtree(empty, ignore_errors=True)
    empty.mkdir()
    outs = _run_clis(
        *[(["decompress", str(work / f"in{tag}.llmc"),
            str(work / f"back{tag}.txt"), *dextra], env)
          for tag, _, _, dextra in trips[1:]],
        (["decompress", str(v3), str(work / "back_v3.txt")], env),
        (["decompress", str(arc_side), str(work / "back_side.txt"),
          "--sidecar"], env),
        (["range", str(work / "inrouted.llmc"),
          str(work / "inrouted.part"), "--chunks", "5:13"], env),
        (["decompress", str(raw), str(work / "back_raw.txt")],
         _cli_env(empty), False))
    for tag, data_t, extra, dextra in trips:
        size = (work / f"in{tag}.llmc").stat().st_size
        if (work / f"back{tag}.txt").read_bytes() != data_t:
            fail(f"CLI {tag or 'plain'} round trip: decompressed file "
                 f"differs")
        log(f"[cli] {' '.join(['compress', *extra])} -> "
            f"{' '.join(['decompress', *dextra])} byte-identical "
            f"({len(data_t)} B -> {size} B)")
    if v3.read_bytes()[4] != 3 or \
            (work / "back_v3.txt").read_bytes() != data:
        fail("CLI --v3 round trip differs (or wrote no v3 container)")
    log(f"[cli] --v3 byte-identical ({len(data)} B -> {v3.stat().st_size}"
        f" B; v4 {(work / 'in.llmc').stat().st_size} B)")
    side = json.loads((work / "in_side.llmc.diag.json").read_text())
    if side["kind"] != "decompress" or len(side["chunks"]) != n_chunks \
            or (work / "back_side.txt").read_bytes() != data:
        fail("decompress --sidecar: wrong sidecar or bytes")
    # range over an interior interval of the plain and the routed archive
    for name, source, (lo, hi) in (("in", data, (3, 7)),
                                   ("inrouted", routed.read_bytes(),
                                    (5, 13))):
        if (work / f"{name}.part").read_bytes() != \
                source[lo * 128:hi * 128]:
            fail(f"range {lo}:{hi} of {name}.llmc is not the source slice")
    if (work / "back_raw.txt").read_bytes() != data \
            or "model-free" not in outs[-1] or any(empty.iterdir()):
        fail(f"model-free decompress: bytes, stdout {outs[-1]!r} or cache "
             f"{sorted(p.name for p in empty.iterdir())}")

    # range and stats once more in this process, counts read
    out, sl, sst = _in_process_cli(["stats"])
    if sl["cdf_points"] <= 0 or sl["decode_attention"] <= 0:
        fail(f"in-process stats launched {sl}")
    part = work / "in.part"
    _, rl, rst = _in_process_cli(["range", str(work / "in.llmc"), str(part),
                                  "--chunks", "3:7"])
    want = 6 * (rst["step_replays"] + rst["warmup_steps"])
    if rl["topk_cdf"] <= 0 or rl["decode_attention"] != want \
            or part.read_bytes() != data[384:896]:
        fail(f"in-process range: launches {rl}, graphs {rst}; "
             f"decode_attention should be 6 x (replays + warm-up) = {want}")
    log(f"[cli] in-process stats: launches {sl}, graphs {sst}")
    log(f"[cli] in-process range 3:7: launches {rl}, graphs {rst}: "
        f"decode_attention {rl['decode_attention']} = 6 x "
        f"({rst['step_replays']} replays + {rst['warmup_steps']} warm-up)")
    profile_mirror(work)


def profile_mirror(work) -> None:
    """One ``LLMCompressor.compress`` of 4 KiB of text by the trained
    ``pred-base`` under ``torch.profiler`` (CPU and CUDA), at a (lanes,
    length) no earlier phase used, so that the decode step's graph is
    captured inside the profile: the spans must be ``record_function``
    events, a ``decode_attention`` kernel must have been launched inside
    a ``model.decode_step`` span, no ``mirror=False`` span may appear, and
    the bytes must equal those of the same compress with no profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import LLMCompressor
    from repro_torch.data.synthetic import human_like
    from repro_torch.data.tokenizer import encode
    from repro_torch.serve import graphs
    from repro_torch.train import prep
    pred = prep.predictor("pred-base", device="cuda")
    toks = encode(human_like("wiki", 4096, seed=11))
    comp = LLMCompressor(pred, chunk_size=96, topk=48, decode_batch=12)
    graphs.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        blob, _ = comp.compress(toks)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    captures = graphs.STATS["captures"]
    path = work / "mirror_trace.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    plain, _ = comp.compress(toks)
    if blob != plain:
        fail("profiled compress wrote other bytes than the same compress "
             "without a profiler")
    ann = [e for e in evs if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in ann}
    steps = [e for e in ann if e["name"] == "model.decode_step"]
    runtime = {e["args"]["correlation"]: e for e in evs
               if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    kernels = [e for e in evs if e.get("cat") == "kernel"
               and "decode_attention" in e.get("name", "")]

    def inside(ev, spans):
        return any(s["tid"] == ev["tid"] and s["ts"] <= ev["ts"]
                   <= s["ts"] + s["dur"] for s in spans)
    launched_in = sum(
        1 for k in kernels
        if k.get("args", {}).get("correlation") in runtime
        and inside(runtime[k["args"]["correlation"]], steps))
    gpu_ann = [e for e in evs if e.get("cat") == "gpu_user_annotation"
               and e["name"] == "model.decode_step"]
    on_gpu = sum(1 for k in kernels if any(
        a["ts"] <= k["ts"] and k["ts"] + k["dur"] <= a["ts"] + a["dur"]
        for a in gpu_ann))
    quiet = names & {"coder.step", "service.refill", "service.finish_slot",
                     "prefix_cache.lookup"}
    log(f"[mirror] compress of {toks.size} tokens (chunk 96, 12 lanes) "
        f"under torch.profiler in {wall:.2f} s, {captures} capture(s) "
        f"inside; {len(evs)} trace events; record_function spans "
        f"{sorted(names)}; {len(steps)} model.decode_step spans; "
        f"{len(kernels)} decode_attention kernels, {launched_in} launched "
        f"inside a model.decode_step span, {on_gpu} inside one of its "
        f"{len(gpu_ann)} GPU-side annotations")
    if captures < 1:
        fail("the profiled compress captured no graph")
    if not {"compress.job", "model.decode_step"} <= names:
        fail(f"profile lacks compress.job / model.decode_step: {names}")
    if launched_in < 1 and on_gpu < 1:
        fail("no decode_attention kernel inside a model.decode_step span")
    if quiet:
        fail(f"mirror=False spans on the profile: {sorted(quiet)}")


# ---------------------------------------------------------- phase 13
def _named(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def check_grads(grads, what: str) -> None:
    """Every leaf's gradient finite and nonzero, each leaf named."""
    import torch
    rows = []
    for name, g in _named(grads):
        finite = bool(torch.isfinite(g).all())
        amax = float(g.float().abs().max())
        rows.append(f"{name} {amax:.3g}")
        if not finite or amax == 0.0:
            fail(f"{what}: gradient of {name} is "
                 f"{'not finite' if not finite else 'zero'}")
    log(f"[train] {what}: every leaf's gradient finite and nonzero (max "
        f"|g|): " + ", ".join(rows))


def time_train_steps(step_fn, params, opt_state, batch, n: int = 10):
    """Host ms per train step (a synchronised host clock over ``n``
    steps, after 2 warm-up steps), device ms and kernels per step
    (``torch.profiler``, 3 steps) and the peak memory of the window."""
    import torch
    state = [params, opt_state]

    def one():
        state[0], state[1], m = step_fn(state[0], state[1], batch)
        return m
    for _ in range(2):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        one()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated()
    dev, kernels, api = profile_calls(one, 3)
    return dict(host_ms=host, device_ms=dev, kernels=kernels,
                host_launch_calls=api, peak_bytes=peak)


def phase_paper() -> dict:
    """The paper's experiment on the card at the JAX recipe's sizes:
    ``pred-base`` trained by ``train/prep.py`` into a fresh cache, its
    checkpoint reloaded bit for bit, ``llm_dataset("wiki", 4096)``
    generated through the captured decode step, compressed by
    ``LLMCompressor(chunk_size=64, topk=32, decode_batch=16)`` and by
    ``llmc-torch compress`` (CLI defaults), both decompressed by fresh
    processes that load the checkpoint; the ratio held above gzip's
    (``tests/test_system.py``'s headline check)."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_predictors import PRED_BASE
    from repro_torch.core import LLMCompressor, entropy
    from repro_torch.core.baselines import gzip_ratio
    from repro_torch.data.synthetic import human_like_ood
    from repro_torch.data.tokenizer import encode
    from repro_torch.kernels import ops
    from repro_torch.models import api as model_api
    from repro_torch.serve import graphs
    from repro_torch.train import prep
    from repro_torch.train.checkpoint import restore_latest
    from repro_torch.train.optimizer import AdamWConfig, tree_map
    from repro_torch.train.train_loop import (init_train_state,
                                              make_train_step,
                                              value_and_grad)
    name, cfg = "pred-base", PRED_BASE
    work = ROOT / "build" / "chip_smoke" / "paper"
    shutil.rmtree(work, ignore_errors=True)
    cache = work / "cache"
    cache.mkdir(parents=True)
    out = {}

    # step 0: the recipe's first batch on the recipe's initial weights
    pipe = prep.corpus_pipeline(0)
    batch0 = {"tokens": pipe.global_batch_array(0)}
    params0 = model_api.init_params(cfg, 0, "cuda")
    before = dict(ops.LAUNCHES)
    loss0, grads0 = value_and_grad(params0, cfg, batch0)
    check_grads(grads0, f"{name} step 0 (loss {float(loss0):.4f})")
    del grads0, params0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _ = prep.train_predictor(name, seed=0, device="cuda",
                                     cache_dir=cache, log=log)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    if ops.LAUNCHES != before:
        fail(f"training launched kernels: {before} -> {ops.LAUNCHES}")
    steps = prep.TRAIN_STEPS[name]
    restored, step = restore_latest(
        prep.checkpoint_dir(name, 0, cache),
        {"params": params, "losses": torch.zeros(steps)})
    if restored is None or step != steps:
        fail(f"checkpoint of {name} not found after training ({step})")
    for (k, a), (_, b) in zip(_named(params), _named(restored["params"])):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"reloaded checkpoint: {k} differs from the trained leaf")
    losses = restored["losses"].numpy()
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    if not last < first:
        fail(f"{name} loss did not fall: first 10 steps {first:.4f}, last "
             f"10 {last:.4f}")
    tok_step = prep.BATCH * (prep.SEQ_LEN + 1)
    log(f"[train] {name}: {steps} steps in {out['train_s']:.1f} s "
        f"(corpus build and checkpoint included); loss mean of the first "
        f"10 steps {first:.4f}, last 10 {last:.4f}; every 50: "
        + ", ".join(f"{i}: {losses[i]:.4f}" for i in range(0, steps, 50))
        + f"; checkpoint reloaded bit for bit")

    opt = AdamWConfig(learning_rate=3e-3, warmup_steps=20,
                      total_steps=steps)
    _, opt_state = init_train_state(cfg, 0, "cuda", opt)
    tr = time_train_steps(make_train_step(cfg, opt=opt),
                          tree_map(lambda p: p.clone(), params), opt_state,
                          {"tokens": pipe.global_batch_array(1)})
    tr["tokens_per_s"] = tok_step / tr["host_ms"] * 1e3
    out["step"] = tr
    log(f"[train] {name} train step (16 x 193 tokens, fp32): host "
        f"{tr['host_ms']:.3f} ms, device {_ms(tr['device_ms'], 3)} (idle "
        f"{_idle(tr['device_ms'], tr['host_ms'])}), {_count(tr['kernels'])}"
        f" kernels and {tr['host_launch_calls']:.0f} host launch calls per "
        f"step; {tr['tokens_per_s']:.0f} tokens/s; peak memory "
        f"{tr['peak_bytes'] / 2**20:.1f} MiB")
    del params, opt_state

    # generation through the captured decode step
    ops.reset_launches()
    graphs.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = prep.llm_dataset("wiki", 4096, device="cuda", cache_dir=cache)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches, st = dict(ops.LAUNCHES), dict(graphs.STATS)
    want = cfg.n_layers * (st["step_replays"] + st["warmup_steps"])
    if launches["decode_attention"] != want or launches["decode_attention"] \
            <= 0:
        fail(f"generation: decode_attention launches "
             f"{launches['decode_attention']} != {cfg.n_layers} x "
             f"({st['step_replays']} replays + {st['warmup_steps']} "
             f"warm-up steps)")
    n_docs = -(-4096 // 384)
    gen_tokens = n_docs * (384 - 128)
    out["generate"] = dict(seconds=gen_s, tokens=gen_tokens,
                           tokens_per_s=gen_tokens / gen_s,
                           launches=launches, graph_stats=st)
    log(f"[generate] llm_dataset('wiki', 4096): {n_docs} documents x (128 "
        f"prompt + 256 sampled) tokens in {gen_s:.2f} s (checkpoint load "
        f"and capture included): {gen_tokens / gen_s:.0f} sampled tokens/s;"
        f" {st['step_replays']} replays + {st['warmup_steps']} warm-up "
        f"steps, decode_attention {launches['decode_attention']} = "
        f"{cfg.n_layers} x {st['step_replays'] + st['warmup_steps']}")

    pred = prep.predictor(name, device="cuda", cache_dir=cache, log=log)
    data = encode(raw)
    gz = gzip_ratio(raw)
    ops.reset_launches()
    comp = LLMCompressor(pred, chunk_size=64, topk=32, decode_batch=16)
    blob, _ = comp.compress(data)
    out["launches"] = dict(ops.LAUNCHES)
    if not np.array_equal(comp.decompress(blob), data):
        fail("LLMCompressor round trip of the generated text differs")
    ratio = len(raw) / len(blob)
    (work / "gen.txt").write_bytes(raw)
    (work / "gen64.llmc").write_bytes(blob)

    # the CLI, defaults (pred-base, chunk 128, top-k 48, 16 slots, v4)
    env = dict(os.environ, REPRO_TORCH_CACHE=str(cache))
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    for cmd in (["compress", "gen.txt", "gen.llmc"],
                ["decompress", "gen.llmc", "back.txt"]):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.cli", *cmd],
                           env=env, cwd=work, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0 or "loaded" not in r.stderr \
                or "training" in r.stderr:
            fail(f"llmc-torch {cmd[0]} (exit {r.returncode}) did not load "
                 f"the trained checkpoint:\n{r.stdout}\n{r.stderr}")
        log(f"[paper] llmc-torch {cmd[0]}: {r.stdout.strip()} "
            f"({time.perf_counter() - t0:.1f} s with start-up)")
    if (work / "back.txt").read_bytes() != raw:
        fail("CLI round trip of the generated text differs")
    cli_ratio = len(raw) / (work / "gen.llmc").stat().st_size
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke"
         ".decompress_paper_in_fresh_process(sys.argv[1]))", str(work)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0 or "loaded" not in r.stderr:
        fail(f"fresh-process decompression of the LLMCompressor archive "
             f"exited {r.returncode}:\n{r.stdout}\n{r.stderr}")
    if not np.array_equal(np.load(work / "gen64.npy"), data):
        fail("fresh-process decompression of the generated text differs")
    log(f"[paper] {len(raw)} B of pred-base's own wiki text: "
        f"LLMCompressor(chunk 64, top-k 32, 16 lanes) {len(blob)} B, ratio "
        f"{ratio:.3f}; CLI defaults (chunk 128, top-k 48, v4) ratio "
        f"{cli_ratio:.3f}; gzip_ratio {gz:.3f}; both decompressed byte for "
        f"byte by fresh processes that loaded the checkpoint; launches "
        f"{out['launches']}")
    if not ratio > gz:
        fail(f"trained pred-base's ratio {ratio:.3f} on its own text is not "
             f"above gzip's {gz:.3f}")

    # printed, not held
    by_chunk = {}
    for c in (16, 128):
        b, _ = LLMCompressor(pred, chunk_size=c, topk=32,
                             decode_batch=16).compress(data)
        by_chunk[c] = len(raw) / len(b)
    human = encode(human_like_ood("wiki", 3072, seed=99))
    b_h, _ = comp.compress(human)
    b_o, _ = comp.compress(data[:3072])
    est, _ = comp.compress(data, exact=False)
    ana = entropy.analyze(raw.decode("utf-8", "replace"))
    out.update(ratio=ratio, cli_ratio=cli_ratio, gzip_ratio=gz,
               ratio_chunk16=by_chunk[16], ratio_chunk128=by_chunk[128],
               own_ratio_3072=3072 / len(b_o),
               human_ood_ratio_3072=3072 / len(b_h),
               exact_bytes=len(blob), estimate_bytes=len(est),
               entropy=ana)
    log(f"[paper] ratio at chunk 16 {by_chunk[16]:.3f}, 64 {ratio:.3f}, 128 "
        f"{by_chunk[128]:.3f}; own text (3072 B) {out['own_ratio_3072']:.3f}"
        f" against human_like_ood('wiki', 3072, seed=99) "
        f"{out['human_ood_ratio_3072']:.3f}; exact=True {len(blob)} B, "
        f"exact=False {len(est)} B ({len(est) / len(blob) - 1:+.2%}); "
        f"entropy.analyze {ana}")
    del pred, comp
    torch.cuda.empty_cache()
    return out


def decompress_paper_in_fresh_process(work: str) -> int:
    """Phase 13's LLMCompressor archive decoded by a new interpreter that
    loads the trained pred-base from the cache."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import LLMCompressor
    from repro_torch.train import prep
    work = pathlib.Path(work)
    pred = prep.predictor("pred-base", device="cuda", cache_dir=work / "cache")
    comp = LLMCompressor(pred, chunk_size=64, topk=32, decode_batch=16)
    np.save(work / "gen64.npy",
            comp.decompress((work / "gen64.llmc").read_bytes()))
    return 0


# ---------------------------------------------------------- phase 14
def phase_train_full_width() -> dict:
    """Five AdamW steps of qwen3-1.7b at full width (bf16 parameters, fp32
    moments, per-layer remat) on one fixed 8 x 256 batch: every leaf's
    gradient finite and nonzero at step 1, the loss falling from step 1
    to step 5, the step's time, tokens/s, peak memory and model FLOP
    share."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.schema import count_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import (init_train_state,
                                              make_train_step,
                                              value_and_grad)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-1.7b")
    B, S = 8, 256
    batch = {"tokens": np.random.default_rng(14).integers(
        0, cfg.vocab_size, (B, S))}
    # lr 1e-3: an update below half a bf16 ulp of its weight (2**-9
    # relative) would round away
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=1, total_steps=5)
    params, opt_state = init_train_state(cfg, 0, "cuda", opt)
    before = dict(ops.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    loss1, grads = value_and_grad(params, cfg, batch)
    check_grads(grads, f"qwen3-1.7b step 1 (loss {float(loss1):.4f})")
    del grads
    step = make_train_step(cfg, opt=opt)
    losses, host = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        host.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    dev, kernels, _ = profile_calls(lambda: step(params, opt_state, batch),
                                    1)
    if ops.LAUNCHES != before:
        fail(f"full-width training launched kernels: {before} -> "
             f"{ops.LAUNCHES}")
    if not losses[-1] < losses[0]:
        fail(f"qwen3-1.7b loss did not fall over 5 steps: {losses}")
    n = count_params(cfg)
    # the input embedding is a lookup, no matmul: N counts the rest
    n_mm = n - cfg.padded_vocab * cfg.d_model
    step_ms = float(np.median(host[1:]))
    mfu = 6 * n_mm * B * S / (step_ms / 1e3) / BF16_FLOPS
    log(f"[train] qwen3-1.7b full width ({n / 1e9:.3f} B params, bf16, fp32"
        f" m/v, remat per layer), {B} x {S} tokens: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; step host ms " + ", ".join(f"{x:.1f}" for x in host)
        + f" (median of steps 2-5 {step_ms:.1f} ms, "
        f"{B * S / step_ms * 1e3:.0f} tokens/s); peak memory "
        f"{peak / 2**30:.2f} GiB; 6 N tokens / step time (N = "
        f"{n_mm / 1e9:.3f} B without the input embedding) = "
        f"{mfu:.1%} of 989 TFLOP/s; one more step under the profiler: "
        f"device {_ms(dev, 1)} (idle {_idle(dev, step_ms)}), "
        f"{_count(kernels)} kernels")
    del params, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, step_host_ms=host, step_ms=step_ms,
                tokens_per_s=B * S / step_ms * 1e3, peak_bytes=peak,
                params=n, matmul_params=n_mm, mfu=mfu, device_ms=dev,
                kernels=kernels)


# ---------------------------------------------------------- phase 16
def phase_model_paths(arch: str, *, scoring: bool = True,
                      routed: bool = True) -> dict:
    """Phases 4, 5 and 11 for a large model at full width (phase 16 for
    zamba2-7b; phase 17 for h2o-danube-3-4b, deepseek-7b and qwen3-14b,
    without the routed service): ``score_chunks`` against the decode
    program (fresh and under a 32-token prefix: SCORE_TOL for the dense
    family, the fp32 twin for the hybrid and moe families),
    ``compress(exact=False)``, the routed service, and two shared-prefix
    jobs (a prefix-cache hit), with the peak device memory of each
    (phases 19-20 for the moe configs, without the routed service)."""
    import torch
    from repro_torch.serve.engine import ModelPredictor
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    pred = ModelPredictor.random_init(config(arch), seed=0, device="cuda")
    out = {}
    if scoring:
        out["scoring"] = phase_scoring(pred)
        out["scoring"]["peak_bytes"] = _peak(f"{arch} scoring")
        _free_card()
    if routed:
        torch.cuda.reset_peak_memory_stats()
        out.update(phase_routed(pred))
        out["peak_bytes"] = _peak(f"{arch} routed service")
    torch.cuda.reset_peak_memory_stats()
    out["prefix"] = phase_shared_prefix(pred)
    out["prefix"]["peak_bytes"] = _peak(f"{arch} shared-prefix jobs")
    del pred
    _free_card()
    return out


# ---------------------------------------------------------- phase 17
#: the depth cuts of phases 15-18 (the 1200 s budget; full width, each
#: config's trait kept): zamba2-7b's 81 SSD layers to 29 (two
#: applications of its shared block, then its 3 trailing SSD layers, as
#: 81 = 6 x 13 + 3), and the dense configs of phases 17-18 to 8 layers
#: (h2o's window and ring, deepseek's MHA and int8 twin, qwen3-14b's 48
#: padded heads and qk-norm are per layer)
ZAMBA_CUT = "zamba2-7b@29"
DENSE_CUT = 8
#: phase 17's configs: the dense ones the port gained with the int8 and
#: ring caches, and deepseek-7b (MHA: the most cache bytes per token)
#: once more with the int8 cache
DENSE_17 = tuple(f"{a}@{DENSE_CUT}" for a in (
    "h2o-danube-3-4b", "deepseek-7b", "deepseek-7b+int8", "qwen3-14b"))


def phase_dense_configs() -> dict:
    """Phase 17: each of DENSE_17 at full width, cut to DENSE_CUT layers
    (random weights from seed 0, bf16) through the service at 16 slots
    (23 chunks),
    captured against eager steps, the captured step's times, speculative
    decompression and the shared-prefix jobs; scoring against the decode
    program (not for the int8 twin, whose forward is deepseek-7b's). Each
    model is freed before the next; then one fresh process decompresses
    the four configs' containers (the eager step's profile, the traced
    jobs and the lock-step baseline are left to phases 3, 8 and 15: the
    script's 1200 s)."""
    out, fresh = {}, {}
    for arch in DENSE_17:
        t0 = time.perf_counter()
        svc = phase_service(arch, SHORT_JOBS, baselines=False, fresh=False)
        fresh[arch] = svc.pop("fresh")
        paths = phase_model_paths(arch, scoring="+" not in arch,
                                  routed=False)
        out[arch] = dict(svc, **paths)
        log(f"[time] 17 {arch}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fresh_decompress(fresh)
    log(f"[time] 17 fresh process: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------- phase 18
def _steps_of(pred, state, toks):
    """Captured decode steps of toks (B, n), a column a step: the logits
    (B, n, V), each copied out of the step's static buffer."""
    import torch
    out = []
    for t in range(toks.shape[1]):
        lg, _ = pred.decode_step(state, toks[:, t])
        out.append(lg.clone())
    return torch.stack(out, 1)


def phase_window() -> dict:
    """Phase 18: h2o-danube-3-4b (window W = 4096) past its window. Two
    lanes decode W + 256 positions through the captured step, so the ring
    of W slots wraps after position W - 1, and their logits are held
    against the windowed teacher-forced scoring of the same tokens
    (``score_chunks``: one ``forward`` through the flash kernel, window
    W) to SCORE_TOL, over all positions and over the 256 past the
    window. Then one speculative round past the wrap: a captured verify
    of 5 steps, lanes rolled back to 1 and 3 of its inputs, then 8 more
    steps, against captured lock-step caches restored from the lanes'
    snapshots before the round that took only the kept inputs: logits
    and lane caches bit for bit."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import human_like
    from repro_torch.data.tokenizer import encode
    from repro_torch.kernels import ops
    from repro_torch.serve import graphs
    from repro_torch.serve.engine import ModelPredictor
    arch = f"h2o-danube-3-4b@{DENSE_CUT}"
    cfg = config(arch)
    W, B = cfg.sliding_window, 2
    N = W + 256
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    pred = ModelPredictor.random_init(cfg, seed=0, device="cuda")
    toks = encode(human_like("wiki", 3 * B * N, seed=18))[:B * N]
    toks = toks.reshape(B, N).astype(np.int64)
    pred.set_decode_len(N + 8)
    g = pred.begin_decode(B)
    if g["k"].shape[2] != W:
        fail(f"{arch}: a cache of {N + 8} positions holds "
             f"{g['k'].shape[2]} slots, not a ring of {W}")
    inp = np.concatenate([np.full((B, 1), pred.bos_id), toks[:, :-1]], 1)
    ops.reset_launches()
    graphs.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decoded = _steps_of(pred, g, inp)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    launches, stats = dict(ops.LAUNCHES), dict(graphs.STATS)
    if stats["step_replays"] != N or launches["decode_attention"] != \
            cfg.n_layers * (N + stats["warmup_steps"]):
        fail(f"{arch} past the window: {stats} and {launches} for {N} "
             f"captured steps")
    ops.reset_launches()
    t0 = time.perf_counter()
    scored = pred.score_chunks(toks)
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t0
    if ops.LAUNCHES["flash_attention"] != cfg.n_layers:
        fail(f"{arch}: windowed scoring launched flash_attention "
             f"{ops.LAUNCHES['flash_attention']} times")
    every = _compare_logits(f"{arch} decode of {N} positions (ring of {W})"
                            f" vs windowed scoring", scored, decoded)
    past = _compare_logits(f"{arch} the {N - W} positions past the window",
                           scored[:, W:], decoded[:, W:])
    del scored, decoded
    # one speculative round past the wrap against lock-step
    rng = np.random.default_rng(18)
    T, acc = 5, np.array([1, 3])
    seq = np.concatenate([toks[:, -1:], rng.integers(0, 256, (B, T - 1))],
                         1)
    after = rng.integers(0, 256, (B, 8))
    pre = [pred.snapshot_slot(g, b) for b in range(B)]
    lv, snaps = pred.verify_steps(g, seq)
    lv = lv.clone()
    pred.rollback(snaps, acc)
    kept = [pred.snapshot_slot(g, b) for b in range(B)]
    got = _steps_of(pred, g, after)
    for b in range(B):
        h = pred.begin_decode(B)
        pred.restore_slot(h, pre[b], np.ones(B, bool))
        lock = _steps_of(pred, h, seq[:, :acc[b]])
        if not torch.equal(lock[b], lv[b, :acc[b]]):
            fail(f"{arch}: verify logits of lane {b} differ from lock-step")
        mine = pred.snapshot_slot(h, b)
        for k in mine:
            if not torch.equal(mine[k], kept[b][k]):
                fail(f"{arch}: after the rollback lane {b}'s {k} differs "
                     f"from a lock-step cache's")
        if not torch.equal(_steps_of(pred, h, after)[b], got[b]):
            fail(f"{arch}: lane {b} decodes other logits after the "
                 f"rollback than lock-step")
        del h
    peak = _peak(f"{arch} past the window (2 lanes, {N} positions)")
    log(f"[window] {arch}: {N} captured steps of {B} lanes through a ring "
        f"of {W} slots in {t_dec:.2f} s ({t_dec / N * 1e3:.3f} ms a step; "
        f"decode_attention {launches['decode_attention']} = "
        f"{cfg.n_layers} x ({N} + {stats['warmup_steps']} warm-up)); "
        f"windowed scoring of the same tokens {t_score * 1e3:.1f} ms; a "
        f"verify round past the wrap (T = {T}), lanes rolled back to "
        f"{acc.tolist()}, equals lock-step bit for bit, logits and caches")
    del g, pred, pre, kept, snaps, lv, got
    _free_card()
    twin = _window_fp32_twin(cfg, inp, toks)
    return dict(steps=N, step_ms=t_dec / N * 1e3, score_ms=t_score * 1e3,
                every=every, past=past, launches=launches, peak_bytes=peak,
                fp32_twin=twin)


def _window_fp32_twin(cfg, inp, toks) -> dict:
    """Phase 18's ring where bf16 rounding does not hide it. In bf16 the
    decode program and scoring sit ~0.1 apart (SCORE_TOL is 0.34 here),
    and with random weights attention is spread over ~4k keys, so a ring
    that kept the 256 evicted positions, or wrote a wrong slot, would
    move the logits by less than that. The fp32 twin (same config and
    seed in float32) decodes the same W + 256 positions through its
    captured step and is held to SCORE_TOL_FP32 against its own windowed
    scoring. The control: the twin's scoring of the same tokens with no
    window (what a ring that evicts nothing attends) must lie outside
    that limit past the window, or the check could not tell."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import api as model_api
    from repro_torch.serve.engine import ModelPredictor
    W, (B, N) = cfg.sliding_window, toks.shape
    torch.cuda.reset_peak_memory_stats()
    twin = ModelPredictor.random_init(cfg.with_(dtype="float32"), seed=0,
                                      device="cuda")
    twin.set_decode_len(N + 8)
    g = twin.begin_decode(B)
    ops.reset_launches()
    t0 = time.perf_counter()
    decoded = _steps_of(twin, g, inp)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    if ops.LAUNCHES["decode_attention"] < cfg.n_layers * N:
        fail(f"fp32 {cfg.name}: decode_attention launched "
             f"{ops.LAUNCHES['decode_attention']} times for {N} steps")
    del g
    ops.reset_launches()
    scored = twin.score_chunks(toks)
    opened = model_api.forward(
        twin.params, twin.cfg.with_(sliding_window=None),
        {"tokens": twin._tokens(inp)})[..., :cfg.vocab_size]
    torch.cuda.synchronize()
    if ops.LAUNCHES["flash_attention"] != 2 * cfg.n_layers:
        fail(f"fp32 {cfg.name}: scoring with and without the window "
             f"launched flash_attention {ops.LAUNCHES['flash_attention']} "
             f"times")
    every = _compare_logits(f"fp32 {cfg.name} decode of {N} positions vs "
                            f"windowed scoring", scored, decoded,
                            tol=SCORE_TOL_FP32)
    past = _compare_logits(f"fp32 {cfg.name} the {N - W} positions past "
                           f"the window", scored[:, W:], decoded[:, W:],
                           tol=SCORE_TOL_FP32)
    limit = SCORE_TOL_FP32 * past["max_abs_logit"]
    control = (opened[:, W:] - scored[:, W:]).abs().max().item()
    inside = (opened[:, :W] - scored[:, :W]).abs().max().item()
    log(f"[window] fp32 twin: {N} captured steps in {t_dec:.2f} s; "
        f"control: scoring with no window is {control:.4g} from windowed "
        f"scoring past the window ({control / limit:.1f} x the limit "
        f"{limit:.3g}), {inside:.3g} before it; the decode program "
        f"{past['max_abs_diff']:.3g}")
    if not control > limit:
        fail(f"fp32 {cfg.name}: scoring with no window is {control} from "
             f"windowed scoring past the window, not above the limit "
             f"{limit}: the check cannot tell a ring that keeps the "
             f"positions it should evict")
    peak = _peak(f"fp32 {cfg.name} past the window")
    del twin, decoded, scored, opened
    _free_card()
    return dict(every=every, past=past, step_ms=t_dec / N * 1e3,
                control_max_abs_diff=control, limit=limit, peak_bytes=peak)


# ------------------------------------------------------- phases 19-20
#: the moe family: granite-moe-1b-a400m at full width and depth (phase
#: 19), qwen3-moe-235b-a22b at full width cut to 4 of its 94 layers
#: (phase 20: ~470 GB of bf16 whole, 22.4 GB at 4 layers)
MOE_CONFIGS = (("19", "granite-moe-1b-a400m"), ("20", "qwen3-moe-235b-a22b@4"))


def phase_moe_configs() -> dict:
    """Phases 19-20: each of MOE_CONFIGS (random weights from seed 0,
    bf16; dropless dispatch, the experts as batched products) through
    the service at 16 slots (23 chunks; lane permutations bit for bit,
    lane 0 among them), captured against eager steps, the captured
    step's times against its bound, speculative decompression; then
    scoring against the decode program (through the fp32 twin:
    SCORE_TOL_FP32) and the shared-prefix jobs, with the peak memory of
    each part. Each model is freed before
    the next; then one fresh process decompresses both configs'
    containers."""
    out, fresh = {}, {}
    for phase, arch in MOE_CONFIGS:
        t0 = time.perf_counter()
        svc = phase_service(arch, SHORT_JOBS, baselines=False, fresh=False)
        fresh[arch] = svc.pop("fresh")
        paths = phase_model_paths(arch, routed=False)
        out[arch] = dict(svc, **paths)
        log(f"[time] {phase} {arch}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fresh_decompress(fresh)
    log(f"[time] 19-20 fresh process: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if os.environ.get("PYTHONHASHSEED") != "0":
        # the same synthetic texts in every run and in every child
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
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
    t_run = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    # the CLI's pred-* predictors train at first use: into a cache of this
    # run's own, by the full recipe
    cache = ROOT / "build" / "chip_smoke" / "torch_cache"
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["REPRO_TORCH_CACHE"] = str(cache)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    log(card)
    drv = subprocess.run(["nvidia-smi", "--query-gpu=driver_version",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, driver "
        f"{drv}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
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
    jobs = routed_jobs()
    times = {}

    def timed(name, fn, *args, **kw):
        """Run a phase and log its wall seconds (the 1200 s budget)."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        times[name] = round(time.perf_counter() - t0, 1)
        log(f"[time] {name}: {times[name]} s")
        return out

    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ModelPredictor

    def paths_of(arch):
        """Phases 4, 5 and 11 (9 for mamba2-130m) on one predictor."""
        pred = ModelPredictor.random_init(get_config(arch), seed=0,
                                          device="cuda")
        phase_scoring(pred)
        routed = phase_routed(pred)
        if arch == "qwen3-1.7b":
            phase_shared_prefix(pred)
        del pred
        torch.cuda.empty_cache()
        return routed

    kern = timed("2 kernels", phase_kernels, gen, -(-jobs[0].size // 128))
    svc = timed("3+10 qwen3-1.7b service", phase_service, "qwen3-1.7b")
    routed = timed("4+5+11 qwen3-1.7b paths", paths_of, "qwen3-1.7b")
    full = timed("6 full CDF", phase_full_cdf)
    timed("6 mismatched archive", phase_mismatch)
    timed("7 CLI", phase_cli)
    timed("8+10 mamba2-130m service", phase_service, "mamba2-130m")
    routed_ssm = timed("9 mamba2-130m paths", paths_of, "mamba2-130m")
    timed("13 paper", phase_paper)
    timed("14 qwen3-1.7b training", phase_train_full_width)
    svc_h = timed("15 zamba2-7b service", phase_service, ZAMBA_CUT,
                  SHORT_JOBS)
    routed_h = timed("16 zamba2-7b paths", phase_model_paths, ZAMBA_CUT)
    dense = timed("17 dense configs", phase_dense_configs)
    window = timed("18 past the window", phase_window)
    moe = timed("19+20 moe configs", phase_moe_configs)

    paths = {"cdf_points": full, "flash_attention": routed,
             "ssd_intra": routed_ssm}
    # zamba2-7b's paths: the service (phase 15) and the routed service
    # (phase 16); cdf_points is not on them (--topk 0 only)
    hybrid_paths = {"flash_attention": routed_h, "ssd_intra": routed_h}
    # the int8 variant's main path: deepseek-7b's service with the int8
    # cache (phase 17)
    paths["decode_attention_int8"] = dense[f"deepseek-7b+int8@{DENSE_CUT}"]
    rows = []
    for name, (src, replaces) in SOURCES.items():
        r = kern[name]
        main_launches = paths.get(name, svc)["launches"]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": int(main_launches[name]),
               "launches_zamba2": int(hybrid_paths.get(
                   name, svc_h)["launches"].get(name, 0)),
               # phase 17's service round trips, phase 18's ring
               "launches_phase17": {a: int(d["launches"][name])
                                    for a, d in dense.items()},
               "launches_phase18": int(window["launches"][name]),
               # phases 19-20's service round trips (the moe family)
               "launches_moe": {a: int(d["launches"][name])
                                for a, d in moe.items()},
               "max_abs_err": r["max_abs_err"], "tol": r["tol"],
               # attention: error over its row's max |value| (the bf16
               # limit), at every shape, and a planted skipped tile's
               "rel_err": {k: v["rel_err"] for k, v in kern.items()
                           if k.split("@")[0] == name and "rel_err" in v}
               or None,
               "planted_rel_err": {
                   k: v["planted_rel_err"] for k, v in kern.items()
                   if k.split("@")[0] == name and "planted_rel_err" in v}
               or None,
               "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"],
               "library_ms": r["library_ms"],
               "device_ms": r["device_ms"],
               "library_device_ms": r["library_device_ms"]}
        if "bf16_kernel_ms" in r:
            row.update(bf16_kernel_ms=r["bf16_kernel_ms"],
                       bf16_kernel_device_ms=r["bf16_kernel_device_ms"])
        rows.append(row)
    log(f"[done] every phase in {time.perf_counter() - t_run:.1f} s, the "
        f"build included; by phase {times}")
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
