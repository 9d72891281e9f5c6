#!/usr/bin/env python3
"""Where the port's bf16 flash-attention kernel spends its time, on one
CUDA card.

    python3 tools/kernel_probe.py [--out chiprun_out/kernel_probe.json]

Two probes of ``src/repro_torch/kernels/csrc/flash_attention.cu`` at the
qwen3-1.7b scoring shapes (16 lanes, 16 q-heads, 8 kv-heads, hd 128,
bf16, causal; S = 128 and 160, the launch geometry of
``ops.flash_geometry``), each compiled from a patched copy of the source
under ``build/kernel_probe/``:

* phases: every CTA records ``%globaltimer`` at its start, once its Q
  copies are issued, when its first K/V tile has landed, after its last
  tile and after its stores, into a buffer past the output. Printed:
  the median of each phase over the CTAs, and the launch's span.
* cost doubling: the kernel with every ``mma`` issued twice, or the
  online softmax run twice; the growth of its device time
  (``torch.profiler``, as ``chip_smoke.py`` measures) is what that part
  costs where it sits.

Prints the card's name and power limit first. Needs the CUDA toolkit
(``nvcc``); not used by the port.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SHAPES = {128: 16, 160: 16}          # S -> lanes
H, K, HD = 16, 8, 128

_NOW = 'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tt[{i}]));\n'
_PHASES = ("issue Q", "first K/V tile landed", "tiles", "stores")


def _patch(src: str, anchor: str, insert: str) -> str:
    """``insert`` after ``anchor`` (ValueError: the kernel has changed)."""
    j = src.index(anchor) + len(anchor)
    return src[:j] + insert + src[j:]


def phase_source(src: str) -> str:
    """The kernel with per-CTA timestamps written past the output."""
    src = _patch(src, "flash_bf16_kernel(const Params p) {\n",
                 "  unsigned long long tt[5];\n  " + _NOW.format(i=0))
    src = _patch(src, "      stage16(sQ + r * LD + c, src, pos < p.Sq && "
                      "c < p.hd, qb, p.vec);\n    }\n  }\n",
                 "  " + _NOW.format(i=1))
    src = _patch(src, "    const bf16* sK = sKV + (j % kStages) * 2 * "
                      "kBK16 * LD;\n", "    if (j == 0) " + _NOW.format(i=2))
    src = _patch(src, "  cp_async_wait<0>();\n", "  " + _NOW.format(i=3))
    tail = ("      for (int jj = 0; jj < 8; ++jj) dst[jj] = tmp[jj];\n"
            "    }\n  }\n")
    return _patch(src, tail, (
        "  __syncthreads();\n  if (threadIdx.x == 0) {\n    "
        + _NOW.format(i=4) +
        "    unsigned long long* rec = reinterpret_cast<unsigned long long*>"
        "(static_cast<bf16*>(p.o) + (long long)gridDim.y * p.o_sb) + 5 * "
        "(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * "
        "blockIdx.z));\n    for (int q = 0; q < 5; ++q) rec[q] = tt[q];\n"
        "  }\n"))


def doubled(src: str, what: str) -> str:
    lines = {"mma": ["          mma16816(s[n], a, bk[0], bk[1]);\n",
                     "          mma16816(acc[n], a, bv[0], bv[1]);\n"],
             "softmax": ["      online_softmax(s, m, l, acc, vlo, vhi, "
                         "k0 + 2 * t, masked, nt, sl2);\n"]}[what]
    for ln in lines:
        src = _patch(src, ln, ln)
    return src


def compile_all(variants: dict) -> dict:
    """{tag: source} -> {tag: C entry point}, one nvcc each, in parallel."""
    from repro_torch.kernels import build
    name = "flash_attention"
    procs = {}
    for tag, src in variants.items():
        d = ROOT / "build" / "kernel_probe" / tag
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        (d / build.KERNELS[name][0]).write_text(src)
        lib = d / f"lib{name}.so"
        cmd = [build.nvcc(), *build._flags(name), "-o", str(lib),
               str(d / build.KERNELS[name][0])]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    entries = {}
    for tag, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{tag}: nvcc exited {p.returncode}\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), build.KERNELS[name][2])
        fn.argtypes = build.KERNELS[name][3]
        fn.restype = ctypes.c_int
        entries[tag] = fn
    return entries


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="JSON results file")
    args = ap.parse_args()
    import torch
    import chip_smoke
    from repro_torch.kernels import build, ops
    from repro_torch.obs.logs import console
    if not torch.cuda.is_available():
        console("kernel_probe: no CUDA device", err=True)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    console(smi)
    base = (build.CSRC / build.KERNELS["flash_attention"][0]).read_text()
    fns = compile_all({"base": base, "phases": phase_source(base),
                       "mma2x": doubled(base, "mma"),
                       "softmax2x": doubled(base, "softmax")})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf = torch.bfloat16
    out = {"card": smi, "shapes": {}}
    for S, B in SHAPES.items():
        hg, bq = ops.flash_geometry(S, H // K, bf)
        n_cta = K * (H // K // hg) * B * (-(-S // bq))
        q, k, v = (torch.randn((B, S, h, HD), generator=gen, device="cuda")
                   .to(bf).transpose(1, 2) for h in (H, K, K))
        buf = torch.zeros(B * S * H * HD + 20 * n_cta, dtype=bf,
                          device="cuda")
        o = buf[:B * S * H * HD].view(B, S, H, HD).transpose(1, 2)

        def call(fn):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                    *o.stride()[:3], B, H, K, S, S, HD, 1, 0, 1,
                    HD ** -0.5, 1, hg, bq,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed ({rc})")
        row = {"geometry": [hg, bq], "ctas": n_cta}
        for tag in ("base", "mma2x", "softmax2x"):
            row[f"{tag}_device_ms"] = chip_smoke.device_ms(
                lambda: call(fns[tag]), "flash_bf16_kernel")
        for _ in range(3):
            call(fns["phases"])
        torch.cuda.synchronize()
        t = buf[B * S * H * HD:].view(torch.int64)[:5 * n_cta].view(
            n_cta, 5).cpu().double()
        row["phase_median_us"] = dict(zip(
            _PHASES, ((t[:, 1:] - t[:, :-1]) / 1e3).median(0).values
            .tolist()))
        row["span_us"] = (t[:, 4].max() - t[:, 0].min()).item() / 1e3
        out["shapes"][S] = row
        console(f"[probe] S={S} (heads per CTA, rows) {(hg, bq)}, {n_cta} "
                f"CTAs: device {row['base_device_ms']:.5f} ms; every mma "
                f"twice {row['mma2x_device_ms']:.5f} ms, softmax twice "
                f"{row['softmax2x_device_ms']:.5f} ms; phase medians (us) "
                + ", ".join(f"{k} {v:.2f}" for k, v in
                            row["phase_median_us"].items())
                + f"; span {row['span_us']:.2f} us")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
