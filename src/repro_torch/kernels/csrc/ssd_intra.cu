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
// Bound on the H100: bytes. At the scoring path's shapes (R = 16, Q =
// 128, H = 24, P = 64, N = 128, bf16 in) the call moves ~32.5 MB, 25 MB
// of it the fp32 y and state it writes, for ~1.2 GFLOP: 9.7 us of HBM
// time against 1.3 us at the bf16 tensor rate.
//
// Design (bf16, the scoring path). The TPU kernel took one (chunk, head)
// per grid step and built the whole Q x Q decay matrix in VMEM. Here the
// work of a chunk is split by static shapes only (kernels/ops.py
// `ssd_geometry`): a CTA of 8 warps owns a chunk, a group of HG = 2 HW
// heads (4 from H = 4 up, to Q = 2048) and either a 64-row tile i of y
// for all of them or the chunk-end state of two of them. So a head group
// reads C and makes C B^T once, not once per head. The heaviest CTAs go
// first (the last y tile, then the state, then the other y tiles):
// blockIdx.z is the role.
//   * y CTA (i tile t): C_i is staged once; the j tiles 0..t follow, and
//     for each one G = C_i B_j^T runs once on the tensor cores (each warp
//     a 16 x 32 quarter) into shared memory, where every warp reads its
//     16 rows of G for each head. Then for each head of the group, W =
//     G exp(cum_i - cum_j) dt_j and y_i += W x_j. Warps
//     0-3 take heads 0..HW-1 of the group and warps 4-7 the others, 16
//     rows each. On a 16 x 16 block of W on the diagonal the exp is taken
//     per entry, with the exponent of acausal and out-of-range entries
//     set to -inf BEFORE the exp (they are large and positive and would
//     overflow; a select, not a branch per entry). Below the diagonal
//     blocks it factors as exp(cum_i - cum_r) b_j, r the block's last
//     position and b_j = exp(cum_r - cum_j) dt_j made once per CTA: two
//     exps a thread per block instead of sixteen, both factors at most 1
//     since dt A <= 0. A warp skips the blocks wholly above its rows.
//   * state CTA (heads q and HW + q of the group): S_h = (x_h e_h)^T B_j
//     summed over the j tiles in order, e_j = exp(cum_{Q-1} - cum_j) dt_j;
//     warp half w takes one head, its warps 16 P rows by all N columns.
//   * Copies overlap compute: a step is (j tile, head of each warp half)
//     in a y CTA and a j tile in a state CTA, and the next step's x tiles
//     (and B tile) go into the other half of a two-slot ring by 16-byte
//     `cp.async` while this step's MMAs run; the first two steps' copies
//     are issued together, before the scan of dt.
//   * Fragments come from shared memory by `ldmatrix` (x4; `.trans` for
//     x and for B as the state's K x N operand). mma.sync m16n8k16 with
//     ldmatrix, not wgmma: W, the product's A operand, is made in
//     registers per head (exp, mask, split), and m64 wgmma tiles would
//     tie each warpgroup to 64 rows of one head with the accumulators of
//     all its heads live. What bounds the kernel is not the tensor rate
//     but its CTAs' phases (copies in, products, stores out) running in
//     step across the card (PERF.md section 7).
//   * y and the state are staged in shared memory and written with
//     16-byte streaming stores (st.global.cs: written once, never read
//     here, so they should not push the re-read x, B and C tiles out of
//     L2), a row of y covering the group's HG x P contiguous floats.
//   * C, B and x are exact in bf16; the fp32 factors (W, and x * e for
//     the state) are split into a bf16 high part and a bf16 remainder,
//     two products each, so the result keeps ~16 bits of those factors
//     instead of 8.
//   * cum is a scan: every CTA of a (chunk, head) computes it for the
//     whole chunk in the same fixed order (dt staged by all threads at
//     once, then one warp per head, ceil(Q / 32) positions per lane
//     sequentially, then lane totals by shuffles), so every tile sees
//     the same bits; the first tiles' copies are in flight meanwhile.
//     dt * A is rounded before it is added, as the reference computes
//     it.
//   * x, B and C are read through the caller's strides (the model passes
//     views of its conv output), with the ragged edge of Q, P and N
//     zero-filled in shared memory: any Q <= 4096, P <= 64, N <= 128.
// fp32 (the fp32 twin's scoring check only): the CUDA-core kernel of the
// first port, one (32-row tile, head, chunk) per CTA and one more CTA per
// (head, chunk) for the state; `ssd_geometry` gives it 1 head per CTA.
// No atomics: every sum runs in a fixed order (G over N, y over j tiles
// then j within a tile, the state over j tiles in order), and the split
// depends on the static shapes only, so a chunk's result does not depend
// on the other chunks or lanes of the call, nor on the head grouping.
//
// Plain C interface, bound from Python with ctypes (kernels/ops.py).
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;       // fp32 kernel
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

// dt and cum of chunk r for heads h0 .. h0 + HG - 1 (zeros for heads past
// H): dt is copied into sDt by every thread at once (one round trip),
// then warp w scans head h0 + w: ceil(Q / 32) positions per lane in
// order, lane totals by shuffles (a fixed order, so every CTA of a chunk
// and head gets the same bits). sDt and sCum are [HG][qpad], zero past
// Q. Ends on a block barrier.
template <typename T, int HG>
__device__ void stage_cum(const Params& p, int r, int h0, int qpad,
                          float* sDt, float* sCum) {
  const T* dtr = static_cast<const T*>(p.dt) + r * p.dt_sr;
  for (int i = threadIdx.x; i < HG * qpad; i += blockDim.x) {
    const int j = i / HG, hh = i % HG, h = h0 + hh;
    sDt[hh * qpad + j] = j < p.Q && h < p.H
        ? repro::to_float(dtr[j * p.dt_sq + h * p.dt_sh]) : 0.0f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < HG) {
    const float* dtv = sDt + warp * qpad;
    float* cum = sCum + warp * qpad;
    const float A = h0 + warp < p.H ? p.A[h0 + warp] : 0.0f;
    const int per = (p.Q + 31) / 32;
    float run = 0.0f;
    for (int k = 0; k < per; ++k) {
      const int j = lane * per + k;
      if (j < p.Q) {
        run = __fadd_rn(run, __fmul_rn(dtv[j], A));
        cum[j] = run;
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
      if (j < p.Q && lane > 0) cum[j] = __fadd_rn(excl, cum[j]);
    }
    for (int j = p.Q + lane; j < qpad; j += 32) cum[j] = 0.0f;
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
constexpr int kT16 = 64;            // rows of an i tile and of a j tile
constexpr int kThreads16 = 256;     // 8 warps: 4 row groups x 2 head halves

__device__ __forceinline__ uint32_t smem_u32(const void* q) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(q));
}

// 16-byte cp.async of src into dst, or 16 zero bytes when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address
// of row (l & 7) of matrix l >> 3. Plain: lane gets (row l >> 2, columns
// 2 (l & 3), +1) of each; `.trans`: (rows 2 (l & 3), +1; column l >> 2).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* q) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(q))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* q) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(q))
      : "memory");
}

// (hi, lo) bf16 pairs of two fp32 values: v ~= hi + lo to ~16 bits. The
// packed conversion (cvt.rn.bf16x2.f32) runs on the fast ALU pipe; one
// scalar conversion per value would queue on the 16-a-clock one.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t* hi,
                                       uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h),
                                                 v1 - __high2float(h));
  memcpy(hi, &h, sizeof(*hi));
  memcpy(lo, &l, sizeof(*lo));
}

// the bf16 pair (lo, hi) of `u` times (e0, e1), split as above
__device__ __forceinline__ void scale_split(uint32_t u, float e0, float e1,
                                            uint32_t* hi, uint32_t* lo) {
  split2(__uint_as_float(u << 16) * e0, __uint_as_float(u & 0xffff0000u) * e1,
         hi, lo);
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

// A 64 x W tile of src (row k at src + (row0 + k) * rs) into dst (row
// stride LD), zero past nvalid rows and ncols columns: 16-byte cp.async
// where the rows are aligned and the 8 columns whole, scalar loads
// otherwise. All threads of the block take part.
template <int W, int LD>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src,
                                           long long rs, int row0,
                                           int nvalid, int ncols, bool vec) {
  constexpr int kChunks = W / 8;
  for (int i = threadIdx.x; i < kT16 * kChunks; i += kThreads16) {
    const int k = i / kChunks, c = (i % kChunks) * 8;
    const int pos = row0 + k;
    bf16* d = dst + k * LD + c;
    if (vec && c + 8 <= ncols) {
      const bool ok = pos < nvalid;
      cp_async16_zfill(d, ok ? src + pos * rs + c : src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (pos < nvalid && c + j < ncols) ? src[pos * rs + c + j]
                                               : __float2bfloat16_rn(0.0f);
    }
  }
}

// Shared-memory layout of the bf16 kernel (bytes), as the host sizes it.
template <int NP, int PP, int HW>
struct Bf16Layout {
  static constexpr int HG = 2 * HW;
  static constexpr int LDN = NP + 8;          // +16 bytes: conflict-free
  static constexpr int LDP = PP + 8;
  static constexpr int LDG = kT16 + 8;        // fp32 rows: 8 mod 32 words
  static constexpr int LDY = HG * PP + 8;
  static constexpr int NB = HW == 1 ? 2 : 1;  // B slots of a y CTA
  static constexpr size_t kTileN = sizeof(bf16) * kT16 * LDN;
  static constexpr size_t kTileP = sizeof(bf16) * kT16 * LDP;
  static constexpr size_t y_loop = kTileN * (1 + NB) + 4 * kTileP +
                                   sizeof(float) * kT16 * LDG;
  static constexpr size_t y_stage = sizeof(float) * kT16 * LDY;
  static constexpr size_t s_loop = 2 * kTileN + 4 * kTileP;
  static constexpr size_t s_stage = sizeof(float) * 2 * PP * LDN;
  static constexpr size_t m1 = y_loop > y_stage ? y_loop : y_stage;
  static constexpr size_t m2 = s_loop > s_stage ? s_loop : s_stage;
  static constexpr size_t work = m1 > m2 ? m1 : m2;
  // cum, dt and W's column factor of the group's heads, then the work area
  static size_t total(int qpad) {
    return sizeof(float) * 3 * HG * qpad + work;
  }
};

template <int NP, int PP, int HW>
__global__ void __launch_bounds__(kThreads16, 2)
ssd_bf16_kernel(const Params p, int qpad, int ytiles) {
  using L = Bf16Layout<NP, PP, HW>;
  constexpr int HG = L::HG, LDN = L::LDN, LDP = L::LDP, LDG = L::LDG,
                LDY = L::LDY, NB = L::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sCum = reinterpret_cast<float*>(smem_raw);   // [HG][qpad]
  float* sDt = sCum + HG * qpad;                       // [HG][qpad]
  float* sFb = sDt + HG * qpad;                        // [HG][qpad]
  unsigned char* work = reinterpret_cast<unsigned char*>(sFb + HG * qpad);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3;          // row group: 16 rows of i (or of p)
  const int wg = warp >> 2;         // head half: heads wg * HW + k
  // blockIdx.z is the CTA's role, heaviest first so that the longest
  // CTAs start in the first wave: the last y tile (most j tiles), the
  // state CTAs, then the other y tiles, last to first
  const int r = blockIdx.x, h0 = blockIdx.y * HG, role = blockIdx.z;
  const int parts = gridDim.z - ytiles;
  const bf16* xr = static_cast<const bf16*>(p.x) + r * p.x_sr;
  const bf16* bb = static_cast<const bf16*>(p.b) + r * p.b_sr;
  const int T = ytiles;                        // j tiles in the chunk

  // x tiles of step (jt, k): head h0 + w * HW + k for warp half w, into
  // ring slot `slot` (heads past H read as zeros)
  auto load_x = [&](bf16* slot, int jt, int k) {
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int h = h0 + w * HW + k;
      const bool ok = h < p.H;
      tile_async<PP, LDP>(slot + w * kT16 * LDP, xr + (ok ? h : 0) * p.x_sh,
                          p.x_sq, jt * kT16, ok ? p.Q : 0, p.P, p.vec);
    }
  };

  if (role >= 1 && role <= parts) {
    // ---- chunk-end state of heads q and HW + q of the group (warp halves
    // 0 and 1), all N columns, one step per j tile
    const int q = role - 1;
    bf16* sB = reinterpret_cast<bf16*>(work);          // [2][64][LDN]
    bf16* sX = sB + 2 * kT16 * LDN;                    // [2][2][64][LDP]
    float* sSt = reinterpret_cast<float*>(work);       // [2][PP][LDN]
    float acc[NP / 8][4];
#pragma unroll
    for (int n = 0; n < NP / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    // step jt: B_jt and the two heads' x tiles into slot jt & 1
    auto issue = [&](int jt) {
      tile_async<NP, LDN>(sB + (jt & 1) * kT16 * LDN, bb, p.b_sq, jt * kT16,
                          p.Q, p.N, p.vec);
      load_x(sX + (jt & 1) * 2 * kT16 * LDP, jt, q);
      cp_async_commit();
    };
    issue(0);                       // both slots' copies overlap the scan
    if (T > 1) issue(1);
    stage_cum<bf16, HG>(p, r, h0, qpad, sDt, sCum);
    // e_j = exp(cum_{Q-1} - cum_j) dt_j (0 past Q) of the two heads, in
    // place of dt
    for (int i = threadIdx.x; i < 2 * qpad; i += kThreads16) {
      const int hh = i / qpad * HW + q, j = i % qpad, at = hh * qpad + j;
      const float cend = sCum[hh * qpad + p.Q - 1];
      sDt[at] = j < p.Q ? expf(cend - sCum[at]) * sDt[at] : 0.0f;
    }
    const float* e = sDt + (wg * HW + q) * qpad;
    for (int jt = 0; jt < T; ++jt) {
      if (jt + 1 < T) {
        if (jt > 0) issue(jt + 1);  // into the slot step jt - 1 freed
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();              // this step's tiles (and e) are in
      if (rg * 16 < PP) {
        const bf16* bt = sB + (jt & 1) * kT16 * LDN;
        const bf16* xt = sX + ((jt & 1) * 2 + wg) * kT16 * LDP;
#pragma unroll
        for (int kk = 0; kk < kT16 / 16; ++kk) {
          // A = (x e)^T: rows p (16 rg + ...), columns j (16 kk + ...)
          const int j = jt * kT16 + kk * 16 + 2 * t;
          uint32_t a[4], ahi[4], alo[4];
          ldsm_x4_t(a, xt + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * LDP +
                           rg * 16 + ((lane >> 3) & 1) * 8);
          const float2 e01 = *reinterpret_cast<const float2*>(e + j);
          const float2 e23 = *reinterpret_cast<const float2*>(e + j + 8);
          scale_split(a[0], e01.x, e01.y, &ahi[0], &alo[0]);
          scale_split(a[1], e01.x, e01.y, &ahi[1], &alo[1]);
          scale_split(a[2], e23.x, e23.y, &ahi[2], &alo[2]);
          scale_split(a[3], e23.x, e23.y, &ahi[3], &alo[3]);
#pragma unroll
          for (int np = 0; np < NP / 16; ++np) {
            uint32_t b[4];          // B_j: rows j, columns n
            ldsm_x4_t(b, bt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  LDN + np * 16 + (lane >> 4) * 8);
            mma16816(acc[2 * np], ahi, b[0], b[1]);
            mma16816(acc[2 * np], alo, b[0], b[1]);
            mma16816(acc[2 * np + 1], ahi, b[2], b[3]);
            mma16816(acc[2 * np + 1], alo, b[2], b[3]);
          }
        }
      }
      __syncthreads();              // slot jt & 1 is free for step jt + 2
    }
    // stage [head][p][column], then 16-byte rows of the state
    if (rg * 16 < PP) {
#pragma unroll
      for (int n = 0; n < NP / 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = wg * PP + rg * 16 + g + 8 * half;
          *reinterpret_cast<float2*>(sSt + row * LDN + n * 8 + 2 * t) =
              make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
        }
    }
    __syncthreads();
    float* sb = p.state + (long long)r * p.H * p.P * p.N;
    const bool v4 = (p.N & 3) == 0;
    for (int i = threadIdx.x; i < 2 * PP * (NP / 4); i += kThreads16) {
      const int row = i / (NP / 4), c = (i % (NP / 4)) * 4;
      const int w = row / PP, pr = row % PP, h = h0 + w * HW + q;
      if (h >= p.H || pr >= p.P || c >= p.N) continue;
      const float* src = sSt + row * LDN + c;
      float* dst = sb + ((long long)h * p.P + pr) * p.N + c;
      if (v4) {
        __stcs(reinterpret_cast<float4*>(dst),
               *reinterpret_cast<const float4*>(src));
      } else {
        for (int k = 0; k < 4 && c + k < p.N; ++k) dst[k] = src[k];
      }
    }
    return;
  }

  // ---- y for rows [i0, i0 + 64): j tiles 0 .. it
  const int it = role == 0 ? ytiles - 1 : ytiles - 1 - (role - parts);
  const int i0 = it * kT16;
  const bf16* cb = static_cast<const bf16*>(p.c) + r * p.c_sr;
  bf16* sC = reinterpret_cast<bf16*>(work);            // [64][LDN]
  bf16* sB = sC + kT16 * LDN;                          // [NB][64][LDN]
  bf16* sX = sB + NB * kT16 * LDN;                     // [2][2][64][LDP]
  float* sG = reinterpret_cast<float*>(sX + 4 * kT16 * LDP);  // [64][LDG]
  float* sY = reinterpret_cast<float*>(work);          // [64][LDY]
  float acc[HW][PP / 8][4];
#pragma unroll
  for (int k = 0; k < HW; ++k)
#pragma unroll
    for (int n = 0; n < PP / 8; ++n)
      acc[k][n][0] = acc[k][n][1] = acc[k][n][2] = acc[k][n][3] = 0.0f;
  // step s = jt * HW + k: C_i with s == 0, B_jt with k == 0 (one slot
  // when HW > 1: step (jt, 1) loads nothing of B, and step (jt + 1, 0)'s
  // copy is issued after G of jt is made), x tiles into slot s & 1. Steps
  // 0 and 1 are issued at once; step s + 1 at the start of step s.
  auto issue = [&](int s) {
    const int jt = s / HW, k = s % HW;
    if (s == 0)
      tile_async<NP, LDN>(sC, cb, p.c_sq, i0, p.Q, p.N, p.vec);
    if (k == 0)
      tile_async<NP, LDN>(sB + (NB == 2 ? (jt & 1) : 0) * kT16 * LDN, bb,
                          p.b_sq, jt * kT16, p.Q, p.N, p.vec);
    load_x(sX + (s & 1) * 2 * kT16 * LDP, jt, k);
    cp_async_commit();
  };
  const int ia = i0 + rg * 16 + g, ib = ia + 8;     // this thread's rows
  issue(0);                         // both slots' copies overlap the scan
  if ((it + 1) * HW > 1) issue(1);
  stage_cum<bf16, HG>(p, r, h0, qpad, sDt, sCum);
  // W's column factor below the diagonal blocks: b_j = exp(cum_r - cum_j)
  // dt_j, r = min(the last position of j's 16-block, Q - 1), so that
  // exp(cum_i - cum_j) dt_j = exp(cum_i - cum_r) b_j for every i past
  // the block, both factors at most 1 (dt A <= 0, as in Mamba2)
  for (int i = threadIdx.x; i < HG * qpad; i += kThreads16) {
    const int hh = i / qpad, j = i % qpad;
    const float cr = sCum[hh * qpad + min(j | 15, p.Q - 1)];
    sFb[i] = j < p.Q ? expf(cr - sCum[i]) * sDt[i] : 0.0f;
  }
  for (int jt = 0; jt <= it; ++jt) {
#pragma unroll
    for (int k = 0; k < HW; ++k) {
      const int s = jt * HW + k;
      if (s + 1 < (it + 1) * HW) {
        if (s > 0) issue(s + 1);    // into the slot step s - 1 freed
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();              // this step's tiles are in
      if (k == 0 && !(jt == it && wg * 32 > rg * 16 + 15)) {
        // G = C_i B_j^T once, into sG: warp (rg, wg) makes rows 16 rg..,
        // columns 32 wg.. (K = NP in 16-wide steps, in order); on the
        // diagonal tile a quarter wholly above the diagonal is never read
        const bf16* bt = sB + (NB == 2 ? (jt & 1) : 0) * kT16 * LDN;
        float q[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          q[n][0] = q[n][1] = q[n][2] = q[n][3] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < NP / 16; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, sC + (rg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              LDN + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t b[4];
            ldsm_x4(b, bt + (wg * 32 + np * 16 + (lane & 7) +
                             (lane >> 4) * 8) * LDN +
                           ks * 16 + ((lane >> 3) & 1) * 8);
            mma16816(q[2 * np], a, b[0], b[1]);
            mma16816(q[2 * np + 1], a, b[2], b[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            *reinterpret_cast<float2*>(
                sG + (rg * 16 + g + 8 * half) * LDG + wg * 32 + n * 8 +
                2 * t) = make_float2(q[n][2 * half], q[n][2 * half + 1]);
      }
      if (k == 0) __syncthreads();  // G of this j tile is in
      // head wg * HW + k: W = G exp(cum_i - cum_j) dt_j or 0, y += W x_j
      const int hh = wg * HW + k;
      const float* cum = sCum + hh * qpad;
      const float* dtv = sDt + hh * qpad;
      const float* fb = sFb + hh * qpad;
      const float ca = cum[ia], cb2 = cum[ib];
      const bf16* xt = sX + ((s & 1) * 2 + wg) * kT16 * LDP;
#pragma unroll
      for (int kk = 0; kk < kT16 / 16; ++kk) {
        if (jt == it && kk > rg) break;   // j > every row of this warp
        const int jb = jt * kT16 + kk * 16;      // the 16-block of j
        float gv[2][4];             // G rows ia, ib; columns jb + 8m + 2t
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 v = *reinterpret_cast<const float2*>(
                sG + (rg * 16 + g + 8 * half) * LDG + kk * 16 + m * 8 +
                2 * t);
            gv[m][2 * half] = v.x;
            gv[m][2 * half + 1] = v.y;
          }
        float w[2][4];
        if (jt == it && kk == rg) {
          // the diagonal block: exp per entry, the exponent of j > i (and
          // of rows past Q) -inf, a select and not a branch
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e < 2 ? ia : ib;
              const int j = jb + m * 8 + 2 * t + (e & 1);
              const float seg = (j <= i && i < p.Q)
                                    ? (e < 2 ? ca : cb2) - cum[j]
                                    : -INFINITY;
              w[m][e] = gv[m][e] * __expf(seg) * dtv[j];
            }
        } else {
          // below it: exp(cum_i - cum_r) b_j, two exps a thread
          const float cr = cum[min(jb + 15, p.Q - 1)];
          const float fa[2] = {ia < p.Q ? __expf(ca - cr) : 0.0f,
                               ib < p.Q ? __expf(cb2 - cr) : 0.0f};
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float2 b = *reinterpret_cast<const float2*>(
                fb + jb + m * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[m][e] = gv[m][e] * (e & 1 ? b.y : b.x) *
                        fa[e >> 1];
          }
        }
        // W's accumulator layout is the A fragment of 16 j's
        uint32_t ahi[4], alo[4];
        split2(w[0][0], w[0][1], &ahi[0], &alo[0]);
        split2(w[0][2], w[0][3], &ahi[1], &alo[1]);
        split2(w[1][0], w[1][1], &ahi[2], &alo[2]);
        split2(w[1][2], w[1][3], &ahi[3], &alo[3]);
#pragma unroll
        for (int np = 0; np < PP / 16; ++np) {
          uint32_t b[4];            // x_j: rows j, columns p
          ldsm_x4_t(b, xt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LDP + np * 16 + (lane >> 4) * 8);
          mma16816(acc[k][2 * np], ahi, b[0], b[1]);
          mma16816(acc[k][2 * np], alo, b[0], b[1]);
          mma16816(acc[k][2 * np + 1], ahi, b[2], b[3]);
          mma16816(acc[k][2 * np + 1], alo, b[2], b[3]);
        }
      }
      __syncthreads();              // slot s & 1 (and G) free for reuse
    }
  }

  // stage [row][head * PP + p], then 16-byte rows of y (the group's heads
  // are contiguous in a row of y)
#pragma unroll
  for (int k = 0; k < HW; ++k)
#pragma unroll
    for (int n = 0; n < PP / 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(sY + (rg * 16 + g + 8 * half) * LDY +
                                   (wg * HW + k) * PP + n * 8 + 2 * t) =
            make_float2(acc[k][n][2 * half], acc[k][n][2 * half + 1]);
  __syncthreads();
  const int nh = min(HG, p.H - h0);
  const bool v4 = (p.P & 3) == 0;
  for (int i = threadIdx.x; i < kT16 * (HG * PP / 4); i += kThreads16) {
    const int row = i / (HG * PP / 4), f = (i % (HG * PP / 4)) * 4;
    if (i0 + row >= p.Q || f >= nh * p.P) continue;
    float* yrow = p.y + ((long long)r * p.Q + i0 + row) * p.H * p.P +
                  (long long)h0 * p.P;
    if (v4) {
      const int hh = f / p.P, pc = f % p.P;
      __stcs(reinterpret_cast<float4*>(yrow + f),
             *reinterpret_cast<const float4*>(sY + row * LDY + hh * PP + pc));
    } else {
      for (int q = 0; q < 4 && f + q < nh * p.P; ++q) {
        const int hh = (f + q) / p.P, pc = (f + q) % p.P;
        yrow[f + q] = sY[row * LDY + hh * PP + pc];
      }
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
  stage_cum<float, 1>(p, r, h, qpad, sDt, sCum);

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

template <int NP, int PP, int HW>
cudaError_t launch_bf16(const Params& p, int R, int groups, int ytiles,
                        int parts, cudaStream_t st) {
  const int qpad = ytiles * kT16;
  const size_t smem = Bf16Layout<NP, PP, HW>::total(qpad);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = ssd_bf16_kernel<NP, PP, HW>;
  static size_t allowed = 48 * 1024;    // no static shared memory
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      (void)cudaGetLastError();           // leave no error behind
      return e;
    }
    allowed = smem;
  }
  // chunks, head groups, roles (ytiles y tiles and parts state CTAs)
  const dim3 grid(R, groups, ytiles + parts);
  kern<<<grid, kThreads16, smem, st>>>(p, qpad, ytiles);
  return cudaGetLastError();
}

template <int NP, int PP>
cudaError_t launch_f32(const Params& p, int R, int ytiles, cudaStream_t st) {
  const int qpad = ytiles * kT32;
  const size_t smem = sizeof(float) * (kT32 * (2 * (NP + 1) + (PP + 1) +
                                              kLDW) + 2 * qpad);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kern = ssd_f32_kernel<NP, PP>;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      (void)cudaGetLastError();
      return e;
    }
    allowed = smem;
  }
  // one CTA per row tile of y, and one more for the chunk-end state
  const dim3 grid(ytiles + 1, p.H, R);
  kern<<<grid, kThreads, smem, st>>>(p, qpad);
  return cudaGetLastError();
}

template <int PP>
cudaError_t dispatch_bf16(const Params& p, int R, int heads, int groups,
                          int ytiles, int parts, cudaStream_t st) {
  if (p.N <= 64) {
    return heads == 2 ? launch_bf16<64, PP, 1>(p, R, groups, ytiles, parts, st)
                      : launch_bf16<64, PP, 2>(p, R, groups, ytiles, parts, st);
  }
  return heads == 2 ? launch_bf16<128, PP, 1>(p, R, groups, ytiles, parts, st)
                    : launch_bf16<128, PP, 2>(p, R, groups, ytiles, parts, st);
}

template <int PP>
cudaError_t dispatch_f32(const Params& p, int R, int ytiles,
                         cudaStream_t st) {
  if (p.N <= 32) return launch_f32<32, PP>(p, R, ytiles, st);
  if (p.N <= 64) return launch_f32<64, PP>(p, R, ytiles, st);
  return launch_f32<128, PP>(p, R, ytiles, st);
}

}  // namespace

// x (R, Q, H, P) by its (chunk, position, head) strides, dt (R, Q, H) by
// its strides, A (H,) contiguous fp32, B and C (R, Q, N) by their
// (chunk, position) strides, all strides in elements with unit stride
// over P and N; y (R, Q, H, P) and state (R, H, P, N) contiguous fp32.
// x, dt, B and C share the dtype (0 fp32, 1 bf16). vec != 0 promises
// that every x, B and C row starts on 16 bytes. (rows, heads, ytiles,
// parts) is kernels/ops.py `ssd_geometry(Q, H, P, N, dtype)`: rows of a
// y tile, heads per CTA, y tiles and state CTAs per (chunk, head group);
// a geometry this kernel does not implement is refused. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int repro_ssd_intra(
    const void* x, const void* dt, const void* A, const void* b,
    const void* c, void* y, void* state, long long x_sr, long long x_sq,
    long long x_sh, long long dt_sr, long long dt_sq, long long dt_sh,
    long long b_sr, long long b_sq, long long c_sr, long long c_sq, int R,
    int Q, int H, int P, int N, int dtype, int vec, int rows, int heads,
    int ytiles, int parts, void* stream) {
  if (R <= 0 || Q <= 0 || Q > 4096 || H <= 0 || P <= 0 || P > 64 ||
      N <= 0 || N > 128 || R > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{x,     dt,    static_cast<const float*>(A), b, c,
           static_cast<float*>(y), static_cast<float*>(state),
           x_sr,  x_sq,  x_sh,  dt_sr, dt_sq, dt_sh, b_sr, b_sq, c_sr, c_sq,
           Q,     H,     P,     N,     vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16) {
    if (rows != kT16 || (heads != 2 && heads != 4) ||
        ytiles != (Q + kT16 - 1) / kT16 || parts != heads / 2)
      return (int)cudaErrorInvalidValue;
    const int groups = (H + heads - 1) / heads;
    if (P <= 32)
      return (int)dispatch_bf16<32>(p, R, heads, groups, ytiles, parts, st);
    return (int)dispatch_bf16<64>(p, R, heads, groups, ytiles, parts, st);
  }
  if (dtype != repro::kFloat32 || rows != kT32 || heads != 1 ||
      ytiles != (Q + kT32 - 1) / kT32 || parts != 1)
    return (int)cudaErrorInvalidValue;
  if (P <= 32) return (int)dispatch_f32<32>(p, R, ytiles, st);
  return (int)dispatch_f32<64>(p, R, ytiles, st);
}
