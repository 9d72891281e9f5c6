// Causal / sliding-window GQA prefill attention with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention` / `_flash_kernel`): for every lane b, query head h
// and query position i, o[b,h,i] = sum_j p_ij v[b,h/G,j] / max(l_i,
// 1e-30) with s_ij = q.k / sqrt(hd) in fp32, masked scores set to -1e30
// (key j visible iff j <= i when causal and j > i - window under a
// window; positions count from 0 on both sides), p_ij = exp(s_ij - m_i)
// for visible keys and 0 for masked ones, l_i = sum_j p_ij. Output in
// q's dtype.
//
// Bound on the H100: bytes at the model's shapes. Per (lane, kv-head)
// the function reads Sk * hd K and V values and Sq * G * hd q values and
// writes as many outputs; a causal 128-token chunk is ~2 * 64 * hd flops
// per byte moved, below the card's ~295 flop/byte bf16 ridge. What the
// kernel loses is overlap: each CTA walks only one to three K/V tiles,
// and at the model's shapes every CTA is resident at once, so loads,
// tensor-core work and stores run as three bursts in step.
//
// Design: the TPU carried (m, l, acc) in scratch across a sequential kv
// grid axis. Here a CTA loops over K/V tiles itself, from the window's
// first tile to the causal diagonal -- the same skip of fully masked
// blocks the TPU kernel makes. Q, K and V are read through the caller's
// strides (the model's (B, S, H, hd) projections pass as transposed
// views, no copy), the ragged edge of Sq and Sk zero-filled and masked.
//   * bf16: one CTA per (q tile, group of hg q-heads of one kv-head,
//     lane), 16 query rows per warp, up to 8 warps: each K/V tile is
//     staged once for the group (hg = G = 2 for qwen3), not once per
//     q-head. K/V tiles of 64 keys go through a 2-stage ring filled by
//     16-byte `cp.async`, so tile j+1 loads while tile j runs. Q, K and
//     V fragments come from shared memory by `ldmatrix` (`.trans` for
//     V); S = Q K^T and O += P V run on the tensor cores (mma.sync
//     m16n8k16, bf16 in, fp32 accumulate; P is rounded to bf16 for the
//     second product). The softmax runs in base 2 (`ex2.approx`) with
//     tree maxima and sums; a warp skips a tile masked for all its rows
//     and, on the diagonal, the 8-key groups past its last row, and masks
//     per element only tiles that need it. The output goes through shared
//     memory and out in 16-byte stores. Tiles are launched diagonal-most
//     first; the tile height is a function of Sq and G (kernels/ops.py
//     `flash_geometry`). hd is zero-padded to 32, 64 or 128.
//     `mma.sync` and not `wgmma`: the tensor cores are not what this
//     kernel waits on (tools/kernel_probe.py doubles every mma to show
//     it); 32 rows per warp (two m16 tiles sharing each fragment) need
//     255 registers and measured slower.
//   * fp32: one CTA per (32-row q tile, q-head, lane), CUDA-core FMAs on
//     32 x 32 tiles, so fp32 models (pred-base) keep full fp32 products.
// Determinism: no atomics; every sum runs in a fixed order (K/V tiles
// from key 0 in steps of 64, fixed trees, quad shuffles in lane order),
// and the split of work depends on the static shapes only, so a lane's
// output does not depend on the other lanes, nor on the tiling.
//
// Plain C interface, bound from Python with ctypes (kernels/ops.py).
#include <string.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;   // the reference's mask value
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;       // strides in elements; unit over hd
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, K, Sq, Sk, hd, causal, window;   // window 0 = none
  float scale;
  int vec;                          // 16-byte global loads are aligned
  int o_vec;                        // 16-byte output stores are aligned
  int hg, bq;                       // bf16: q-heads and positions per CTA
};

// Key range [begin, end) that any query row of [q0, q0 + rows) can see,
// begin rounded down to a tile edge: fully masked tiles are never
// loaded.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int rows,
                                         int bk, int* begin, int* end) {
  const int q_last = min(p.Sq, q0 + rows) - 1;
  int e = p.Sk;
  if (p.causal) e = min(e, q_last + 1);
  int b = 0;
  if (p.window > 0) b = max(0, q0 - p.window + 1);
  *begin = (b / bk) * bk;
  *end = e;
}

__device__ __forceinline__ bool visible(const Params& p, int qpos,
                                        int kpos) {
  return kpos < p.Sk && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// rows x HDP elements of src (row r at src + (row0 + r) * ss) into dst
// (row stride LD), zero past nvalid rows and past hd channels.
template <typename T, int HDP, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long ss, int row0,
                                          int nvalid, int rows, int hd,
                                          bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HDP / kVec;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    const int pos = row0 + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);     // zero bits: +0.0
    if (pos < nvalid && c < hd) {
      const T* s = src + pos * ss + c;
      if (vec) {
        u = *reinterpret_cast<const uint4*>(s);
      } else {
        T tmp[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) tmp[j] = s[j];     // hd % 8 == 0
        memcpy(&u, tmp, sizeof(u));
      }
    }
    T* d = dst + r * LD + c;
    if constexpr ((LD * sizeof(T)) % 16 == 0) {
      *reinterpret_cast<uint4*>(d) = u;
    } else {
      T tmp[kVec];
      memcpy(tmp, &u, sizeof(u));
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = tmp[j];
    }
  }
}

// ------------------------------------------------------------ bf16 path
constexpr int kBK16 = 64;           // keys per K/V tile
// 16 q rows per warp, up to 8 warps per CTA. (32 rows per warp, two
// m16 tiles sharing each K/V fragment, need 255 registers and one CTA per
// SM, and measured slower on the H100.)
constexpr int kMaxWarps16 = 8;
constexpr int kRows16 = 16 * kMaxWarps16;   // q rows per CTA at most
constexpr int kStages = 2;          // K/V ring depth

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (the
// source is then not read, but must be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two floats rounded to bf16 (lo in the low half) by one cvt instruction
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
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

// One 16-byte piece (8 channels from c) of a row into shared memory:
// cp.async when the rows are 16-byte aligned, else a synchronous gather;
// zeros when !ok (rows past Sq or Sk, channels past hd).
__device__ __forceinline__ void stage16(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, bool ok,
                                        const __nv_bfloat16* any,
                                        bool vec) {
  if (vec) {
    cp_async16(dst, ok ? src : any, ok);
    return;
  }
  uint4 u = make_uint4(0u, 0u, 0u, 0u);             // zero bits: +0.0
  if (ok) {
    __nv_bfloat16 tmp[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) tmp[j] = src[j];     // hd % 8 == 0
    memcpy(&u, tmp, sizeof(u));
  }
  *reinterpret_cast<uint4*>(dst) = u;
}

// Rows [k0, k0 + kBK16) of one kv-head's K or V (row stride ss) into a
// ring stage.
template <int HDP, int LD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ss, const Params& p,
                                           int k0) {
  constexpr int kChunks = HDP / 8;
  for (int i = threadIdx.x; i < kBK16 * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int pos = k0 + r;
    stage16(dst + r * LD + c, src + pos * ss + c, pos < p.Sk && c < p.hd,
            src, p.vec);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's cp.async groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

__device__ __forceinline__ float ex2(float x) {   // 2^x, +0 for x < -126
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keys [lo, hi) visible to query position q.
__device__ __forceinline__ void visible_range(const Params& p, int q,
                                              int* lo, int* hi) {
  *hi = p.causal ? min(p.Sk, q + 1) : p.Sk;
  *lo = p.window > 0 ? max(0, q - p.window + 1) : 0;
}

// Online softmax of one m16 tile of raw scores s (16 rows x kBK16 keys,
// the mma accumulator layout: element e of n-tile n is row e >> 1, key
// k0 + 8n + 2t + (e & 1)); m in log2 units; rescales acc and returns P
// in s. vlo/vhi: the visible key range of the thread's two rows, applied
// only when `masked`; a hidden score becomes -inf, whose weight ex2
// makes exactly 0 (m never leaves the finite kNegInf it starts at). n-tiles
// at or past `nt` hold no visible key for any row and are skipped.
// Maxima and sums are taken as fixed trees.
template <int NS, int NO>
__device__ __forceinline__ void online_softmax(float (&s)[NS][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&acc)[NO][4],
                                               const int (&vlo)[2],
                                               const int (&vhi)[2], int kt,
                                               bool masked, int nt,
                                               float sl2) {
  if (masked) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kpos = kt + n * 8 + (e & 1);
        const bool ok = (unsigned)(kpos - vlo[r]) <
                        (unsigned)max(vhi[r] - vlo[r], 0);
        s[n][e] = ok ? s[n][e] : -INFINITY;
      }
    }
  }
  float alpha[2], mneg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n)
      v[n] = fmaxf(s[n][2 * r], s[n][2 * r + 1]);
#pragma unroll
    for (int w = NS / 2; w > 0; w >>= 1)
#pragma unroll
      for (int n = 0; n < w; ++n) v[n] = fmaxf(v[n], v[n + w]);
    float mx = v[0];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * sl2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    mneg[r] = -m_new;
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = n < nt ? ex2(fmaf(s[n][e], sl2, mneg[e >> 1])) : 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) v[n] = s[n][2 * r] + s[n][2 * r + 1];
#pragma unroll
    for (int w = NS / 2; w > 0; w >>= 1)
#pragma unroll
      for (int n = 0; n < w; ++n) v[n] += v[n + w];
    l[r] = l[r] * alpha[r] + v[0];
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// One CTA per (q tile, group of p.hg q-heads sharing a kv-head, lane):
// warp w takes head h0 + w / (bq / 16) and 16 positions of the tile.
template <int HDP>
__global__ void __launch_bounds__(kMaxWarps16 * 32, 2)
flash_bf16_kernel(const Params p) {
  constexpr int LD = HDP + 8;       // +16 bytes: conflict-free ldmatrix
  constexpr int KS = HDP / 16;      // k-steps of Q K^T
  constexpr int NO = HDP / 8;       // n-tiles of the output
  constexpr int NS = kBK16 / 8;     // n-tiles of S
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = p.hg * p.bq;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);    // [rows][LD], then O
  bf16* sKV = sQ + rows * LD;                      // [stage][K|V][kBK16][LD]

  const int G = p.H / p.K, groups = G / p.hg;
  const int kh = blockIdx.x / groups;
  const int h0 = kh * G + (blockIdx.x % groups) * p.hg;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * p.bq;   // heaviest first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wph = p.bq / 16;                       // warps per head
  const int hw = h0 + warp / wph;                  // this warp's head
  const int p0 = q0 + (warp % wph) * 16;           // its first position
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;

  // Q rows (row r: head h0 + r / bq, position q0 + r % bq), then the
  // first K/V tile: one cp.async group
  {
    constexpr int kChunks = HDP / 8;
    const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb;
    for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const int pos = q0 + r % p.bq;
      const bf16* src = qb + (h0 + r / p.bq) * p.q_sh + pos * p.q_ss + c;
      stage16(sQ + r * LD + c, src, pos < p.Sq && c < p.hd, qb, p.vec);
    }
  }
  int kbeg, kend;
  kv_range(p, q0, p.bq, kBK16, &kbeg, &kend);
  const int nkv = kend > kbeg ? (kend - kbeg + kBK16 - 1) / kBK16 : 0;
  if (nkv > 0) {
    stage_rows<HDP, LD>(sKV, kb, p.k_ss, p, kbeg);
    stage_rows<HDP, LD>(sKV + kBK16 * LD, vb, p.v_ss, p, kbeg);
  }
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const bf16* qw = sQ + warp * 16 * LD;            // this warp's Q rows
  int vlo[2], vhi[2];                              // its rows' visible keys
  visible_range(p, p0 + g, &vlo[0], &vhi[0]);
  visible_range(p, p0 + g + 8, &vlo[1], &vhi[1]);
  // softmax in base 2: exp(x * scale - m) == exp2(x * sl2 - m / ln 2)
  const float sl2 = p.scale * 1.4426950408889634f;

  for (int j = 0; j < nkv; ++j) {
    const int k0 = kbeg + j * kBK16;
    if (j + 1 < nkv) {                             // the next tile loads
      bf16* nk = sKV + ((j + 1) % kStages) * 2 * kBK16 * LD;
      stage_rows<HDP, LD>(nk, kb, p.k_ss, p, k0 + kBK16);
      stage_rows<HDP, LD>(nk + kBK16 * LD, vb, p.v_ss, p, k0 + kBK16);
    }
    cp_async_commit();
    cp_async_wait<1>();              // ... while this one runs
    __syncthreads();
    const bf16* sK = sKV + (j % kStages) * 2 * kBK16 * LD;
    const bf16* sV = sK + kBK16 * LD;
    // a tile every key of which is masked for all 16 rows of the warp
    // would leave their state unchanged bit for bit: skip it
    bool live = p0 < p.Sq;
    if (p.causal) live = live && k0 <= p0 + 15;
    if (p.window > 0) live = live && k0 + kBK16 - 1 > p0 - p.window;
    if (live) {
      // 8-key n-tiles of this tile that some row of the warp can see
      // (causal: keys up to the warp's last row); the rest are skipped
      const int nt = p.causal ? min(NS, max(0, (p0 + 16 - k0 + 7) / 8))
                              : NS;
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, qw + (lane & 15) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          if (n >= nt) break;
          uint32_t bk[4];
          ldsm_x4(bk, sK + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD +
                          ks * 16 + ((lane >> 3) & 1) * 8);
          mma16816(s[n], a, bk[0], bk[1]);
          mma16816(s[n + 1], a, bk[2], bk[3]);
        }
      }
      // per-element masks only where some key is hidden from some row
      const bool masked = (p.causal && k0 + kBK16 - 1 > p0) ||
                          (p.window > 0 && k0 <= p0 + 15 - p.window) ||
                          k0 + kBK16 > p.Sk;
      online_softmax(s, m, l, acc, vlo, vhi, k0 + 2 * t, masked, nt, sl2);
      // O += P V: P's accumulator layout is the A fragment of 16 keys;
      // V's B fragments by ldmatrix.trans of the row-major tile
#pragma unroll
      for (int kk = 0; kk < kBK16 / 16; ++kk) {
        if (2 * kk >= nt) break;
        const uint32_t a[4] = {pack2f(s[2 * kk][0], s[2 * kk][1]),
                               pack2f(s[2 * kk][2], s[2 * kk][3]),
                               pack2f(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack2f(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, sV + (kk * 16 + (lane & 15)) * LD + n * 8 +
                                (lane >> 4) * 8);
          mma16816(acc[n], a, bv[0], bv[1]);
          mma16816(acc[n + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                 // the stage is consumed
  }
  cp_async_wait<0>();

  // the row sums of the quad, in lane order; O times one reciprocal per
  // row into the warp's own Q rows, then 16-byte stores. l is 0 (no
  // visible key, acc == 0) or >= 1 (the row's maximum adds exp2(0)), so
  // 1 / max(l, 1) gives what dividing by max(l, 1e-30) gives, without
  // the IEEE division's slow path, which 1 / 1e-30 takes
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = __fdividef(1.0f, fmaxf(l[r], 1.0f));
  }
  bf16* so = sQ + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(so + g * LD + c) =
        pack2f(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * LD + c) =
        pack2f(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + hw * p.o_sh;
  const int chunks = p.hd / 8;
  for (int i = lane; i < 16 * chunks; i += 32) {
    const int r = i / chunks, c = (i % chunks) * 8;
    if (p0 + r >= p.Sq) continue;
    bf16* dst = ob + (p0 + r) * p.o_ss + c;
    const uint4 u = *reinterpret_cast<const uint4*>(so + r * LD + c);
    if (p.o_vec) {
      *reinterpret_cast<uint4*>(dst) = u;
    } else {
      bf16 tmp[8];
      memcpy(tmp, &u, sizeof(u));
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) dst[jj] = tmp[jj];
    }
  }
}

// ------------------------------------------------------------ fp32 path
constexpr int kBQ32 = 32;           // a row per 4 threads
constexpr int kBK32 = 32;

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const Params p) {
  constexpr int LD = HDP + 1;       // odd row stride: no bank conflicts
  constexpr int NC = HDP / 4;       // output channels per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kBQ32 * LD;
  float* sV = sK + kBK32 * LD;
  float* sP = sV + kBK32 * LD;      // [kBQ32][kBK32 + 1]

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int q0 = blockIdx.x * kBQ32;
  const int r = threadIdx.x >> 2, c4 = threadIdx.x & 3;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kh * p.v_sh;

  load_rows<float, HDP, LD>(sQ, qb, p.q_ss, q0, p.Sq, kBQ32, p.hd, p.vec);
  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.0f;
  float m = kNegInf, l = 0.0f;
  const int qpos = q0 + r;

  int kbeg, kend;
  kv_range(p, q0, kBQ32, kBK32, &kbeg, &kend);
  for (int k0 = kbeg; k0 < kend; k0 += kBK32) {
    __syncthreads();
    load_rows<float, HDP, LD>(sK, kb, p.k_ss, k0, p.Sk, kBK32, p.hd, p.vec);
    load_rows<float, HDP, LD>(sV, vb, p.v_ss, k0, p.Sk, kBK32, p.hd, p.vec);
    __syncthreads();
    // this thread's scores: row r, keys c4 + 4j
    float s[8];
    float mx = kNegInf;
    uint32_t vis = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c4 + 4 * j;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < HDP; ++d) dot += sQ[r * LD + d] * sK[c * LD + d];
      const bool ok = visible(p, qpos, k0 + c);
      s[j] = ok ? dot * p.scale : kNegInf;
      vis |= (ok ? 1u : 0u) << j;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pe = ((vis >> j) & 1u) ? expf(s[j] - m) : 0.0f;
      l += pe;
      sP[r * (kBK32 + 1) + c4 + 4 * j] = pe;
    }
    __syncwarp();                   // row r's four threads share a warp
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d = c4 + 4 * i;
      float o = 0.0f;
#pragma unroll 8
      for (int c = 0; c < kBK32; ++c)
        o += sP[r * (kBK32 + 1) + c] * sV[c * LD + d];
      acc[i] = acc[i] * alpha + o;
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l = fmaxf(l, 1e-30f);
  if (qpos < p.Sq) {
    float* orow = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
                  qpos * p.o_ss;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d = c4 + 4 * i;
      if (d < p.hd) orow[d] = acc[i] / l;
    }
  }
}

cudaError_t set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int HDP>
cudaError_t dispatch(int dtype, const Params& p, int B, cudaStream_t st) {
  if (dtype == repro::kBFloat16) {
    const int rows = p.hg * p.bq;
    const size_t smem = sizeof(__nv_bfloat16) *
                        (rows + 2 * kStages * kBK16) * (HDP + 8);
    cudaError_t e = set_smem((const void*)flash_bf16_kernel<HDP>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(p.K * (p.H / p.K / p.hg), B, (p.Sq + p.bq - 1) / p.bq);
    flash_bf16_kernel<HDP><<<grid, rows * 2, smem, st>>>(p);   // 32 / 16
    return cudaGetLastError();
  }
  const size_t smem = sizeof(float) * ((kBQ32 + 2 * kBK32) * (HDP + 1) +
                                       kBQ32 * (kBK32 + 1));
  cudaError_t e = set_smem((const void*)flash_f32_kernel<HDP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.Sq + kBQ32 - 1) / kBQ32, p.H, B);
  flash_f32_kernel<HDP><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, hd), k/v (B, K, Sk, hd), o (B, H, Sq, hd), each given by
// its (lane, head, position) strides in elements with unit stride over
// hd. causal != 0 masks keys after the query; window > 0 masks keys at
// or before query - window. vec != 0 promises that every q/k/v row
// starts on 16 bytes. heads_per_cta q-heads of one kv-head and
// rows_per_tile positions per CTA: the geometry of kernels/ops.py
// `flash_geometry` (bf16: heads_per_cta divides H / K, rows_per_tile a
// multiple of 16, their product <= 128; fp32: 1 and 32). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int B, int H, int K,
    int Sq, int Sk, int hd, int causal, int window, int dtype, float scale,
    int vec, int heads_per_cta, int rows_per_tile, void* stream) {
  if (K <= 0 || H % K != 0 || hd <= 0 || hd % 8 != 0 || hd > 128 ||
      B <= 0 || Sq <= 0 || Sk <= 0 || window < 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int hg = heads_per_cta, bq = rows_per_tile;
  if (dtype == repro::kBFloat16) {
    if (hg < 1 || (H / K) % hg != 0 || bq < 16 || bq % 16 != 0 ||
        hg * bq > kRows16 || (Sq + bq - 1) / bq > 65535)
      return (int)cudaErrorInvalidValue;
  } else if (dtype == repro::kFloat32) {
    if (hg != 1 || bq != kBQ32) return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int o_vec = (reinterpret_cast<uintptr_t>(o) & 15u) == 0 &&
                    o_sb % 8 == 0 && o_sh % 8 == 0 && o_ss % 8 == 0;
  Params p{q,    k,    v,    o,    q_sb, q_sh,   q_ss,   k_sb,   k_sh,
           k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,   o_ss,   H,      K,
           Sq,   Sk,   hd,   causal, window, scale, vec, o_vec, hg, bq};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return (int)dispatch<32>(dtype, p, B, st);
  if (hd <= 64) return (int)dispatch<64>(dtype, p, B, st);
  return (int)dispatch<128>(dtype, p, B, st);
}
