"""Per-CTA phase times of the bf16 ``ssd_intra`` kernel, on a card.

    python -m repro_torch.kernels.ssd_probe [--shape R Q H P N]

Builds an instrumented copy of ``csrc/ssd_intra.cu`` in which thread 0
of every CTA records ``%globaltimer`` at its phase boundaries, runs it
at the shape given (default: mamba2-130m's scoring shape, 16 chunks of
128), and prints for each CTA role (the y tiles, the state CTAs) the
10th, 50th and 90th percentiles, in microseconds, of: its start (from
the first CTA's), its prologue (copies issued, dt staged and scanned),
each step (the wait for its copies, then its products), the last
step's products and the staging, the stores, and its end; and how many
CTAs each SM ran. The kernel the port launches is not changed; the
copy is built beside the port's libraries. Nothing runs at import.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from ..obs.logs import console
from . import build, ops

_STAMP = ("[&]{unsigned long long _t; asm volatile(\"mov.u64 %0, "
          "%%globaltimer;\" : \"=l\"(_t)); return _t;}()")

# (anchor in csrc/ssd_intra.cu, text put after it); slot 0 start, 1 after
# the prologue, 2 + s after step s's copies are in, 10 before staging,
# 11 after the stores, 13 the role, 14 whether it is a state CTA, 15 SM
_MARKS = [
    ("  const int T = ytiles;                        // j tiles in the "
     "chunk\n",
     "  unsigned long long* D = g_probe + (((size_t)blockIdx.z * gridDim.y "
     "+ blockIdx.y) * gridDim.x + blockIdx.x) * 16;\n"
     f"  if (threadIdx.x == 0) {{ D[0] = {_STAMP}; unsigned sm; asm "
     "volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm)); D[15] = sm; "
     "D[14] = role >= 1 && role <= parts; D[13] = role; }\n"),
    ("    if (T > 1) issue(1);\n    stage_cum<bf16, HG>(p, r, h0, qpad, "
     "sDt, sCum);\n",
     f"    if (threadIdx.x == 0) D[1] = {_STAMP};\n"),
    ("  if ((it + 1) * HW > 1) issue(1);\n  stage_cum<bf16, HG>(p, r, h0, "
     "qpad, sDt, sCum);\n",
     f"  if (threadIdx.x == 0) D[1] = {_STAMP};\n"),
    ("      __syncthreads();              // this step's tiles (and e) are "
     "in\n",
     f"      if (threadIdx.x == 0 && jt < 8) D[2 + jt] = {_STAMP};\n"),
    ("      __syncthreads();              // this step's tiles are in\n",
     f"      if (threadIdx.x == 0 && s < 8) D[2 + s] = {_STAMP};\n"),
    ("      __syncthreads();              // slot jt & 1 is free for step "
     "jt + 2\n    }\n",
     f"    if (threadIdx.x == 0) D[10] = {_STAMP};\n"),
    ("      __syncthreads();              // slot s & 1 (and G) free for "
     "reuse\n    }\n  }\n",
     f"  if (threadIdx.x == 0) D[10] = {_STAMP};\n"),
]


def instrumented_source() -> str:
    s = (build.CSRC / "ssd_intra.cu").read_text()
    for anchor, text in _MARKS:
        if s.count(anchor) != 1:
            raise RuntimeError(f"ssd_probe: anchor not found once: "
                               f"{anchor!r}")
        s = s.replace(anchor, anchor + text)
    # after the stores: the state branch returns, the y branch ends
    state_end = "    }\n    return;\n  }\n\n  // ---- y for rows [i0, i0 + 64)"
    y_end = ("yrow[f + q] = sY[row * LDY + hh * PP + pc];\n      }\n"
             "    }\n  }\n")
    stop = (f"__syncthreads();\n  if (threadIdx.x == 0) D[11] = "
            f"{_STAMP};\n")
    for anchor, new in ((state_end, state_end.replace(
            "    return;", "    " + stop + "    return;")),
                        (y_end, y_end + "  " + stop)):
        if s.count(anchor) != 1:
            raise RuntimeError(f"ssd_probe: anchor not found once: "
                               f"{anchor!r}")
        s = s.replace(anchor, new)
    s = s.replace("namespace {\n", "__device__ unsigned long long "
                  "g_probe[1 << 20];\nnamespace {\n", 1)
    return s + ("\nextern \"C\" int probe_copy(void* dst, long long n) {\n"
                "  return (int)cudaMemcpyFromSymbol(dst, g_probe, n * 8);\n"
                "}\n"
                "extern \"C\" int probe_clear() {\n"
                "  void* d;\n"
                "  cudaError_t e = cudaGetSymbolAddress(&d, g_probe);\n"
                "  return (int)(e ? e : cudaMemset(d, 0, sizeof(g_probe)));\n"
                "}\n")


def load():
    out = build.BUILD_DIR / "ssd_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd_probe.cu").write_text(instrumented_source())
    r = subprocess.run([build.nvcc(), *build.ARCH, *build.BASE_FLAGS, "-I",
                        str(build.CSRC), "-o", str(out / "libssd_probe.so"),
                        str(out / "ssd_probe.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"ssd_probe: nvcc failed\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(out / "libssd_probe.so"))
    lib.repro_ssd_intra.argtypes = build.KERNELS["ssd_intra"][3]
    lib.repro_ssd_intra.restype = ctypes.c_int
    lib.probe_copy.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return lib


def phases(lib, R, Q, H, P, N, seed=0) -> str:
    """Run the instrumented kernel at (R, Q, H, P, N), inputs as the
    model passes them (views of one conv output), and format the phases."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    conv = torch.randn((R, Q, H * P + 2 * N), generator=gen,
                       device="cuda").bfloat16()
    x, Bm, Cm = torch.split(conv, [H * P, N, N], dim=-1)
    x = x.reshape(R, Q, H, P)
    dt = (0.05 + 0.75 * torch.rand((R, Q, H), generator=gen,
                                   device="cuda")).bfloat16()
    A = -(0.3 + 1.7 * torch.rand((H,), generator=gen, device="cuda"))
    y = torch.empty((R, Q, H, P), device="cuda")
    st = torch.empty((R, H, P, N), device="cuda")
    geo = ops.ssd_geometry(Q, H, P, N, torch.bfloat16)
    _, heads, ytiles, parts = geo
    ncta = (ytiles + parts) * -(-H // heads) * R
    if lib.probe_clear():           # no stamps of an earlier shape
        raise RuntimeError("ssd_probe: clearing the stamps failed")
    for _ in range(5):
        rc = lib.repro_ssd_intra(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), st.data_ptr(), *x.stride()[:3],
            *dt.stride(), *Bm.stride()[:2], *Cm.stride()[:2], R, Q, H, P, N,
            1, 1, *geo, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ssd_probe: launch failed ({rc})")
    torch.cuda.synchronize()
    buf = np.zeros(ncta * 16, np.uint64)
    if lib.probe_copy(buf.ctypes.data, ncta * 16):
        raise RuntimeError("ssd_probe: copy of the stamps failed")
    D = buf.reshape(ncta, 16).astype(np.int64)
    t0 = D[:, 0].min()

    def q(a):
        a = np.asarray(a) / 1e3
        return "/".join(f"{np.percentile(a, k):.2f}" for k in (10, 50, 90))
    lines = [f"shape {(R, Q, H, P, N)} geometry {geo}: {ncta} CTAs, span "
             f"{(D[:, 11].max() - t0) / 1e3:.2f} us (percentiles 10/50/90, "
             f"us)"]
    roles = [(f"y tile {ytiles - 1 - (z - parts if z else 0)}", z)
             for z in [0] + list(range(parts + 1, ytiles + parts))]
    roles += [(f"state {z - 1}", z) for z in range(1, parts + 1)]
    for name, z in roles:
        d = D[D[:, 13] == z]
        steps = [c for c in range(2, 10) if (d[:, c] > 0).all()]
        line = (f"  {name:9s} n={len(d)} start {q(d[:, 0] - t0)} prologue "
                f"{q(d[:, 1] - d[:, 0])}")
        prev = 1
        for c in steps:
            line += f" step{c - 2} {q(d[:, c] - d[:, prev])}"
            prev = c
        line += (f" last+stage {q(d[:, 10] - d[:, prev])} stores "
                 f"{q(d[:, 11] - d[:, 10])} end {q(d[:, 11] - t0)}")
        lines.append(line)
    per_sm = np.bincount(D[:, 15].astype(int))
    lines.append(f"  CTAs per SM: {per_sm.min()}-{per_sm.max()} over "
                 f"{(per_sm > 0).sum()} SMs")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", type=int, nargs=5, action="append",
                    metavar=("R", "Q", "H", "P", "N"))
    args = ap.parse_args(argv)
    lib = load()
    for shape in args.shape or [(16, 128, 24, 64, 128)]:
        console(phases(lib, *shape))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
