// Mamba2 SSD (state-space duality), intra-chunk part.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:51 (`ssd_intra`,
// kernel `_ssd_kernel`): for every chunk r and head h, with a zero
// entering state,
//   cum_i   = sum_{k <= i} dt_k * A_h                  (fp32, in the chunk)
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   state   = sum_j exp(cum_{Q-1} - cum_j) dt_j x_j (x) B_j      (P x N)
// x (R, Q, H, P), dt (R, Q, H), B and C (R, Q, N) in fp32 or bf16, A (H,)
// fp32; y (R, Q, H, P) and state (R, H, P, N) fp32. Heads share B and C
// (one group).
//
// Bound on the H100: bytes. At the scoring path's shapes (Q = 128, H =
// 24, P = 64, N = 128, bf16 in) a chunk moves ~2 MB (x and B/C in, y and
// the state out in fp32) for at most ~200 MFLOP (C B^T per head over the
// full Q x Q, as the TPU kernel computes it): under ~100 flop/byte, below
// the card's ~295 flop/byte bf16 ridge.
//
// Design. The TPU kernel built the whole Q x Q decay matrix in VMEM; at
// Q = 256 that is 256 KB of fp32, above the 227 KB a block may use. Here
// one CTA takes one (64-row tile of i, head, chunk) and walks the column
// tiles j <= i up to the diagonal, as flash_attention.cu walks its KV
// tiles (no softmax): G = C_i B_j^T, W = G * exp(cum_i - cum_j) * dt_j
// with acausal and out-of-range entries set to 0 explicitly BEFORE any
// exp (they are large and positive and would overflow), y_i += W x_j.
// One more CTA per (head, chunk) reduces the chunk-end state over all
// j tiles in order. No atomics: every sum runs in a fixed order, and the
// split of work depends on the static shapes only, so a chunk's result
// does not depend on the other chunks or lanes of the call.
//   * cum is a scan: every CTA of a (chunk, head) computes it for the
//     whole chunk in the same fixed order (warp 0, ceil(Q / 32) positions
//     per lane sequentially, then lane totals by shuffles), so every row
//     tile sees the same bits. dt * A is rounded before it is added, as
//     the reference computes it.
//   * x, B and C are read through the caller's strides (the model passes
//     views of its conv output), with the ragged edge of Q, P and N
//     zero-filled in shared memory: any Q, P <= 64, N <= 128.
//   * bf16: 4 warps x 16 rows; C B^T, W x and x^T B run on the tensor
//     cores (mma.sync m16n8k16, fp32 accumulate). C, B and x are exact in
//     bf16; the fp32 factors (W, and x * exp * dt for the state) are
//     split into a bf16 high part and a bf16 remainder, two products
//     each, so the result keeps ~16 bits of those factors instead of 8.
//   * fp32: CUDA-core FMAs on 32-row tiles, full fp32 products.
// Heads share B and C, yet this kernel recomputes C B^T for every head:
// reusing it across heads is work for a later change.
//
// Plain C interface, bound from Python with ctypes (kernels/ops.py).
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
using bf16 = __nv_bfloat16;

struct Params {
  const void* x;
  const void* dt;
  const float* A;
  const void* b;
  const void* c;
  float* y;
  float* state;
  long long x_sr, x_sq, x_sh;       // strides in elements; unit over P
  long long dt_sr, dt_sq, dt_sh;
  long long b_sr, b_sq;             // unit over N
  long long c_sr, c_sq;
  int Q, H, P, N;
  int vec;                          // 16-byte loads of x/B/C rows aligned
};

// dt and cum of chunk r, head h for positions [0, qpad): zero past Q.
// Fixed order (see the note at the top): warp 0 alone.
template <typename T>
__device__ void chunk_cum(const Params& p, int r, int h, int qpad,
                          float* sDt, float* sCum) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const T* dtb = static_cast<const T*>(p.dt) + r * p.dt_sr + h * p.dt_sh;
    const float A = p.A[h];
    const int per = (p.Q + 31) / 32;
    float run = 0.0f;
    for (int k = 0; k < per; ++k) {
      const int j = lane * per + k;
      if (j < p.Q) {
        const float d = repro::to_float(dtb[j * p.dt_sq]);
        sDt[j] = d;
        run = __fadd_rn(run, __fmul_rn(d, A));
        sCum[j] = run;
      }
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = __fadd_rn(incl, u);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    for (int k = 0; k < per; ++k) {
      const int j = lane * per + k;
      if (j < p.Q && lane > 0) sCum[j] = __fadd_rn(excl, sCum[j]);
    }
    for (int j = p.Q + lane; j < qpad; j += 32) {
      sDt[j] = 0.0f;
      sCum[j] = 0.0f;
    }
  }
  __syncthreads();
}

// rows x W values of src (row k at src + (row0 + k) * rs, unit column
// stride) into dst (row stride LD), zero past nvalid rows and ncols
// columns.
template <typename T, int W, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs,
                                          int row0, int nvalid, int rows,
                                          int ncols, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = W / kVec;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int k = i / kChunks, c = (i % kChunks) * kVec;
    const int pos = row0 + k;
    T v[kVec];
    if (pos < nvalid && vec && c + kVec <= ncols) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + pos * rs + c);
      memcpy(v, &u, sizeof(u));
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        v[j] = (pos < nvalid && c + j < ncols)
                   ? src[pos * rs + c + j] : repro::from_float<T>(0.0f);
    }
    T* d = dst + k * LD + c;
    if constexpr ((LD * sizeof(T)) % 16 == 0) {
      uint4 u;
      memcpy(&u, v, sizeof(u));
      *reinterpret_cast<uint4*>(d) = u;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = v[j];
    }
  }
}

// ------------------------------------------------------------ bf16 path
constexpr int kT16 = 64;            // rows of i (4 warps x 16) and of j

__device__ __forceinline__ uint32_t ld32(const bf16* q) {
  return *reinterpret_cast<const uint32_t*>(q);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// (hi, lo) bf16 pairs of two fp32 values: v ~= hi + lo to ~16 bits
__device__ __forceinline__ void split2(float v0, float v1, uint32_t* hi,
                                       uint32_t* lo) {
  const bf16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  *hi = pack2(h0, h1);
  *lo = pack2(__float2bfloat16_rn(v0 - __bfloat162float(h0)),
              __float2bfloat16_rn(v1 - __bfloat162float(h1)));
}

// d = a (16x16, row) * b (16x8, col) + d, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NP, int PP>
__global__ void __launch_bounds__(kThreads)
ssd_bf16_kernel(const Params p, int qpad) {
  constexpr int LDN = NP + 8;       // +16 bytes: conflict-free fragments
  constexpr int LDP = PP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);     // [64][LDN]
  bf16* sB = sC + kT16 * LDN;                       // [64][LDN]
  bf16* sX = sB + kT16 * LDN;                       // [64][LDP]
  float* sDt = reinterpret_cast<float*>(sX + kT16 * LDP);
  float* sCum = sDt + qpad;

  const int h = blockIdx.y, r = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* xb = static_cast<const bf16*>(p.x) + r * p.x_sr + h * p.x_sh;
  const bf16* bb = static_cast<const bf16*>(p.b) + r * p.b_sr;
  chunk_cum<bf16>(p, r, h, qpad, sDt, sCum);

  if (blockIdx.x == gridDim.x - 1) {
    // ---- chunk-end state: S (P x N) = sum_j (x_j e_j)^T B_j, warp w
    // owning rows p in [16w, 16w + 16)
    const int pw = warp * 16;
    const float cend = sCum[p.Q - 1];
    float acc[NP / 8][4];
#pragma unroll
    for (int n = 0; n < NP / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    for (int j0 = 0; j0 < p.Q; j0 += kT16) {
      __syncthreads();
      load_tile<bf16, NP, LDN>(sB, bb, p.b_sq, j0, p.Q, kT16, p.N, p.vec);
      load_tile<bf16, PP, LDP>(sX, xb, p.x_sq, j0, p.Q, kT16, p.P, p.vec);
      __syncthreads();
      if (pw >= PP) continue;
#pragma unroll
      for (int kk = 0; kk < kT16 / 16; ++kk) {
        // A = (x e)^T: element (row p, col j); e_j = 0 past Q
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int jl = kk * 16 + 2 * t + (q & 1) + ((q >> 2) ? 8 : 0);
          const int pr = pw + g + (((q >> 1) & 1) ? 8 : 0);
          const int j = j0 + jl;
          const float e = j < p.Q ? expf(cend - sCum[j]) * sDt[j] : 0.0f;
          v[q] = __bfloat162float(sX[jl * LDP + pr]) * e;
        }
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split2(v[2 * q], v[2 * q + 1], &ahi[q],
                                           &alo[q]);
        const bf16* bp = sB + (kk * 16 + 2 * t) * LDN + g;
#pragma unroll
        for (int n = 0; n < NP / 8; ++n) {
          const bf16* bn = bp + n * 8;
          const uint32_t b0 = pack2(bn[0], bn[LDN]);
          const uint32_t b1 = pack2(bn[8 * LDN], bn[9 * LDN]);
          mma16816(acc[n], ahi, b0, b1);
          mma16816(acc[n], alo, b0, b1);
        }
      }
    }
    if (pw >= PP) return;
    float* sb = p.state + ((long long)r * p.H + h) * p.P * p.N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pr = pw + g + 8 * half;
      if (pr >= p.P) continue;
#pragma unroll
      for (int n = 0; n < NP / 8; ++n) {
        const int c = n * 8 + 2 * t;
        if (c < p.N) sb[pr * p.N + c] = acc[n][2 * half];
        if (c + 1 < p.N) sb[pr * p.N + c + 1] = acc[n][2 * half + 1];
      }
    }
    return;
  }

  // ---- y for rows [i0, i0 + 64)
  const bf16* cb = static_cast<const bf16*>(p.c) + r * p.c_sr;
  const int i0 = blockIdx.x * kT16;
  load_tile<bf16, NP, LDN>(sC, cb, p.c_sq, i0, p.Q, kT16, p.N, p.vec);
  __syncthreads();
  const int r0 = warp * 16 + g;     // this thread's rows: r0 and r0 + 8
  uint32_t cf[NP / 16][4];
#pragma unroll
  for (int ks = 0; ks < NP / 16; ++ks) {
    const bf16* base = sC + r0 * LDN + ks * 16 + 2 * t;
    cf[ks][0] = ld32(base);
    cf[ks][1] = ld32(base + 8 * LDN);
    cf[ks][2] = ld32(base + 8);
    cf[ks][3] = ld32(base + 8 * LDN + 8);
  }
  const int ipos[2] = {i0 + r0, i0 + r0 + 8};
  const float icum[2] = {sCum[ipos[0]], sCum[ipos[1]]};
  float acc[PP / 8][4];
#pragma unroll
  for (int n = 0; n < PP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int j0 = 0; j0 <= i0; j0 += kT16) {
    __syncthreads();                // the previous tile is consumed
    load_tile<bf16, NP, LDN>(sB, bb, p.b_sq, j0, p.Q, kT16, p.N, p.vec);
    load_tile<bf16, PP, LDP>(sX, xb, p.x_sq, j0, p.Q, kT16, p.P, p.vec);
    __syncthreads();
    // G = C_i B_j^T (element e of n-tile n: row e >> 1, column j0 + 8n +
    // 2t + (e & 1)), then W = G exp(cum_i - cum_j) dt_j or 0
    float s[kT16 / 8][4];
#pragma unroll
    for (int n = 0; n < kT16 / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < NP / 16; ++ks) {
        const bf16* bp = sB + (n * 8 + g) * LDN + ks * 16 + 2 * t;
        mma16816(s[n], cf[ks], ld32(bp), ld32(bp + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ipos[e >> 1];
        const int j = j0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = (j <= i && i < p.Q)
                      ? s[n][e] * expf(icum[e >> 1] - sCum[j]) * sDt[j]
                      : 0.0f;
      }
    }
    // y += W x_j: W's accumulator layout is the A fragment of 16 j's
#pragma unroll
    for (int kk = 0; kk < kT16 / 16; ++kk) {
      uint32_t ahi[4], alo[4];
      split2(s[2 * kk][0], s[2 * kk][1], &ahi[0], &alo[0]);
      split2(s[2 * kk][2], s[2 * kk][3], &ahi[1], &alo[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], &ahi[2], &alo[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], &ahi[3], &alo[3]);
      const bf16* xp = sX + (kk * 16 + 2 * t) * LDP + g;
#pragma unroll
      for (int n = 0; n < PP / 8; ++n) {
        const bf16* xn = xp + n * 8;
        const uint32_t b0 = pack2(xn[0], xn[LDP]);
        const uint32_t b1 = pack2(xn[8 * LDP], xn[9 * LDP]);
        mma16816(acc[n], ahi, b0, b1);
        mma16816(acc[n], alo, b0, b1);
      }
    }
  }

  const long long row_stride = (long long)p.H * p.P;
  float* yb = p.y + (long long)r * p.Q * row_stride + (long long)h * p.P;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (ipos[half] >= p.Q) continue;
    float* yrow = yb + ipos[half] * row_stride;
#pragma unroll
    for (int n = 0; n < PP / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < p.P) yrow[c] = acc[n][2 * half];
      if (c + 1 < p.P) yrow[c + 1] = acc[n][2 * half + 1];
    }
  }
}

// ------------------------------------------------------------ fp32 path
constexpr int kT32 = 32;            // rows of i and of j; a row per 4 threads
constexpr int kLDW = kT32 + 1;

template <int NP, int PP>
__global__ void __launch_bounds__(kThreads)
ssd_f32_kernel(const Params p, int qpad) {
  constexpr int LDN = NP + 1;       // odd row strides: no bank conflicts
  constexpr int LDP = PP + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sC = reinterpret_cast<float*>(smem_raw);   // [32][LDN]
  float* sB = sC + kT32 * LDN;                      // [32][LDN]
  float* sX = sB + kT32 * LDN;                      // [32][LDP]
  float* sW = sX + kT32 * LDP;                      // [32][kLDW]
  float* sDt = sW + kT32 * kLDW;
  float* sCum = sDt + qpad;

  const int h = blockIdx.y, r = blockIdx.z;
  const float* xb = static_cast<const float*>(p.x) + r * p.x_sr + h * p.x_sh;
  const float* bb = static_cast<const float*>(p.b) + r * p.b_sr;
  chunk_cum<float>(p, r, h, qpad, sDt, sCum);

  if (blockIdx.x == gridDim.x - 1) {
    // ---- chunk-end state: output idx = threadIdx.x + 128 m -> (p, n)
    constexpr int M = (PP * NP + kThreads - 1) / kThreads;
    const float cend = sCum[p.Q - 1];
    float acc[M];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = 0.0f;
    for (int j0 = 0; j0 < p.Q; j0 += kT32) {
      __syncthreads();
      load_tile<float, NP, LDN>(sB, bb, p.b_sq, j0, p.Q, kT32, p.N, p.vec);
      load_tile<float, PP, LDP>(sX, xb, p.x_sq, j0, p.Q, kT32, p.P, p.vec);
      if (threadIdx.x < kT32) {
        const int j = j0 + threadIdx.x;
        sW[threadIdx.x] = j < p.Q ? expf(cend - sCum[j]) * sDt[j] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int idx = threadIdx.x + kThreads * m;
        if (idx >= PP * NP) break;
        const int pr = idx / NP, n = idx % NP;
        float s = 0.0f;
#pragma unroll 8
        for (int c = 0; c < kT32; ++c)
          s += (sX[c * LDP + pr] * sW[c]) * sB[c * LDN + n];
        acc[m] += s;
      }
    }
    float* sb = p.state + ((long long)r * p.H + h) * p.P * p.N;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int idx = threadIdx.x + kThreads * m;
      if (idx >= PP * NP) break;
      const int pr = idx / NP, n = idx % NP;
      if (pr < p.P && n < p.N) sb[pr * p.N + n] = acc[m];
    }
    return;
  }

  // ---- y for rows [i0, i0 + 32): thread (row rr, columns c4 + 4m)
  const float* cb = static_cast<const float*>(p.c) + r * p.c_sr;
  const int i0 = blockIdx.x * kT32;
  const int rr = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const int i = i0 + rr;
  load_tile<float, NP, LDN>(sC, cb, p.c_sq, i0, p.Q, kT32, p.N, p.vec);
  const float icum = sCum[i];
  float acc[PP / 4];
#pragma unroll
  for (int m = 0; m < PP / 4; ++m) acc[m] = 0.0f;
  for (int j0 = 0; j0 <= i0; j0 += kT32) {
    __syncthreads();
    load_tile<float, NP, LDN>(sB, bb, p.b_sq, j0, p.Q, kT32, p.N, p.vec);
    load_tile<float, PP, LDP>(sX, xb, p.x_sq, j0, p.Q, kT32, p.P, p.vec);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kT32 / 4; ++m) {
      const int c = c4 + 4 * m, j = j0 + c;
      float w = 0.0f;
      if (j <= i && i < p.Q) {
        float dot = 0.0f;
#pragma unroll 8
        for (int n = 0; n < NP; ++n) dot += sC[rr * LDN + n] * sB[c * LDN + n];
        w = dot * expf(icum - sCum[j]) * sDt[j];
      }
      sW[rr * kLDW + c] = w;
    }
    __syncwarp();                   // row rr's four threads share a warp
#pragma unroll
    for (int m = 0; m < PP / 4; ++m) {
      const int d = c4 + 4 * m;
      float o = 0.0f;
#pragma unroll 8
      for (int c = 0; c < kT32; ++c) o += sW[rr * kLDW + c] * sX[c * LDP + d];
      acc[m] += o;
    }
  }
  if (i < p.Q) {
    float* yrow = p.y + ((long long)r * p.Q + i) * p.H * p.P +
                  (long long)h * p.P;
#pragma unroll
    for (int m = 0; m < PP / 4; ++m) {
      const int d = c4 + 4 * m;
      if (d < p.P) yrow[d] = acc[m];
    }
  }
}

template <typename Kern>
cudaError_t launch(Kern kern, const Params& p, int R, int rows, int qpad,
                   size_t smem, cudaStream_t stream) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // one CTA per row tile of y, and one more for the chunk-end state
  const dim3 grid((p.Q + rows - 1) / rows + 1, p.H, R);
  kern<<<grid, kThreads, smem, stream>>>(p, qpad);
  return cudaGetLastError();
}

template <int NP, int PP>
cudaError_t dispatch(int dtype, const Params& p, int R, cudaStream_t st) {
  if (dtype == repro::kBFloat16) {
    const int qpad = (p.Q + kT16 - 1) / kT16 * kT16;
    const size_t smem = sizeof(bf16) * kT16 * (2 * (NP + 8) + (PP + 8)) +
                        sizeof(float) * 2 * qpad;
    return launch(ssd_bf16_kernel<NP, PP>, p, R, kT16, qpad, smem, st);
  }
  const int qpad = (p.Q + kT32 - 1) / kT32 * kT32;
  const size_t smem = sizeof(float) * (kT32 * (2 * (NP + 1) + (PP + 1) +
                                              kLDW) + 2 * qpad);
  return launch(ssd_f32_kernel<NP, PP>, p, R, kT32, qpad, smem, st);
}

template <int NP>
cudaError_t dispatch_p(int dtype, const Params& p, int R, cudaStream_t st) {
  if (p.P <= 32) return dispatch<NP, 32>(dtype, p, R, st);
  return dispatch<NP, 64>(dtype, p, R, st);
}

}  // namespace

// x (R, Q, H, P) by its (chunk, position, head) strides, dt (R, Q, H) by
// its strides, A (H,) contiguous fp32, B and C (R, Q, N) by their
// (chunk, position) strides, all strides in elements with unit stride
// over P and N; y (R, Q, H, P) and state (R, H, P, N) contiguous fp32.
// x, dt, B and C share the dtype (0 fp32, 1 bf16). vec != 0 promises
// that every x, B and C row starts on 16 bytes. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int repro_ssd_intra(
    const void* x, const void* dt, const void* A, const void* b,
    const void* c, void* y, void* state, long long x_sr, long long x_sq,
    long long x_sh, long long dt_sr, long long dt_sq, long long dt_sh,
    long long b_sr, long long b_sq, long long c_sr, long long c_sq, int R,
    int Q, int H, int P, int N, int dtype, int vec, void* stream) {
  if (R <= 0 || Q <= 0 || Q > 4096 || H <= 0 || P <= 0 || P > 64 ||
      N <= 0 || N > 128 || R > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype != repro::kFloat32 && dtype != repro::kBFloat16)
    return (int)cudaErrorInvalidValue;
  Params p{x,     dt,    static_cast<const float*>(A), b, c,
           static_cast<float*>(y), static_cast<float*>(state),
           x_sr,  x_sq,  x_sh,  dt_sr, dt_sq, dt_sh, b_sr, b_sq, c_sr, c_sq,
           Q,     H,     P,     N,     vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 32) return (int)dispatch_p<32>(dtype, p, R, st);
  if (N <= 64) return (int)dispatch_p<64>(dtype, p, R, st);
  return (int)dispatch_p<128>(dtype, p, R, st);
}
