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
// the CTAs read Sk * hd K and V values and Sq * G * hd q values and write
// as many outputs; a causal 128-token chunk is ~2 * 64 * hd flops per
// byte moved, below the card's ~295 flop/byte bf16 ridge.
//
// Design: the TPU carried (m, l, acc) in scratch across a sequential kv
// grid axis. Here one CTA takes one (q tile, q-head, lane) and loops over
// KV tiles itself. The loop starts at the window's first tile and stops
// at the causal diagonal -- the same skip of fully masked blocks the TPU
// kernel makes. Q, K and V tiles are staged in shared memory, read
// through the caller's strides (the model's (B, S, H, hd) projections
// pass as transposed views, no copy), with the ragged edge of Sq and Sk
// zero-filled and masked. The output is written through strides as well.
//   * bf16: 4 warps x 16 query rows; S = Q K^T and O += P V run on the
//     tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate; P is
//     rounded to bf16 for the second product), the softmax state in
//     fp32 registers. hd is zero-padded to 32, 64 or 128 in shared memory.
//   * fp32: CUDA-core FMAs on 32 x 32 tiles, so fp32 models (pred-base)
//     keep full fp32 products.
// Determinism: no atomics; every sum runs in a fixed order (quad shuffles
// in lane order), and the split of work depends on the static shapes
// only, so a lane's output does not depend on the other lanes.
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
constexpr int kBQ16 = 64;           // 4 warps x 16 query rows
constexpr int kBK16 = 64;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
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

template <int HDP>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const Params p) {
  constexpr int LD = HDP + 8;       // +16 bytes: conflict-free fragments
  constexpr int KS = HDP / 16;      // k-steps of Q K^T
  constexpr int NO = HDP / 8;       // n-tiles of the output
  constexpr int NS = kBK16 / 8;     // n-tiles of S
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ16 * LD;
  bf16* sV = sK + kBK16 * LD;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.H / p.K);
  const int q0 = blockIdx.x * kBQ16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;

  load_rows<bf16, HDP, LD>(sQ, qb, p.q_ss, q0, p.Sq, kBQ16, p.hd, p.vec);
  __syncthreads();
  const int r0 = warp * 16 + g;     // this thread's rows: r0 and r0 + 8
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* base = sQ + r0 * LD + ks * 16 + 2 * t;
    qf[ks][0] = ld32(base);
    qf[ks][1] = ld32(base + 8 * LD);
    qf[ks][2] = ld32(base + 8);
    qf[ks][3] = ld32(base + 8 * LD + 8);
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};

  int kbeg, kend;
  kv_range(p, q0, kBQ16, kBK16, &kbeg, &kend);
  for (int k0 = kbeg; k0 < kend; k0 += kBK16) {
    __syncthreads();                // the previous tile is consumed
    load_rows<bf16, HDP, LD>(sK, kb, p.k_ss, k0, p.Sk, kBK16, p.hd, p.vec);
    load_rows<bf16, HDP, LD>(sV, vb, p.v_ss, k0, p.Sk, kBK16, p.hd, p.vec);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bf16* kp = sK + (n * 8 + g) * LD + ks * 16 + 2 * t;
        mma16816(s[n], qf[ks], ld32(kp), ld32(kp + 8));
      }
    }
    // scale, mask, row max (element e of tile n: row e >> 1, key
    // k0 + 8n + 2t + (e & 1))
    uint32_t vis = 0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = visible(p, qpos[e >> 1], kpos);
        const float x = ok ? s[n][e] * p.scale : kNegInf;
        s[n][e] = x;
        vis |= (ok ? 1u : 0u) << (n * 4 + e);
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ((vis >> (n * 4 + e)) & 1u)
                             ? expf(s[n][e] - m[e >> 1]) : 0.0f;
        s[n][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P V: P's accumulator layout is the A fragment of 16 keys
#pragma unroll
    for (int kk = 0; kk < kBK16 / 16; ++kk) {
      const uint32_t a[4] = {pack2f(s[2 * kk][0], s[2 * kk][1]),
                             pack2f(s[2 * kk][2], s[2 * kk][3]),
                             pack2f(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack2f(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vp = sV + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* vn = vp + n * 8;
        mma16816(acc[n], a, pack2(vn[0], vn[LD]),
                 pack2(vn[8 * LD], vn[9 * LD]));
      }
    }
  }

  // the row sums of the quad, in lane order, then the output
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.Sq) continue;
    bf16* orow = ob + qpos[r] * p.o_ss;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t;
      if (c < p.hd) {
        orow[c] = __float2bfloat16_rn(acc[n][2 * r] / l[r]);
        orow[c + 1] = __float2bfloat16_rn(acc[n][2 * r + 1] / l[r]);
      }
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

template <typename Kern>
cudaError_t launch(Kern kern, const Params& p, int B, int bq, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Sq + bq - 1) / bq, p.H, B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t dispatch(int dtype, const Params& p, int B, cudaStream_t st) {
  if (dtype == repro::kBFloat16) {
    const size_t smem = sizeof(__nv_bfloat16) * (kBQ16 + 2 * kBK16) *
                        (HDP + 8);
    return launch(flash_bf16_kernel<HDP>, p, B, kBQ16, smem, st);
  }
  const size_t smem = sizeof(float) * ((kBQ32 + 2 * kBK32) * (HDP + 1) +
                                       kBQ32 * (kBK32 + 1));
  return launch(flash_f32_kernel<HDP>, p, B, kBQ32, smem, st);
}

}  // namespace

// q (B, H, Sq, hd), k/v (B, K, Sk, hd), o (B, H, Sq, hd), each given by
// its (lane, head, position) strides in elements with unit stride over
// hd. causal != 0 masks keys after the query; window > 0 masks keys at
// or before query - window. vec != 0 promises that every q/k/v row
// starts on 16 bytes. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int B, int H, int K,
    int Sq, int Sk, int hd, int causal, int window, int dtype, float scale,
    int vec, void* stream) {
  if (K <= 0 || H % K != 0 || hd <= 0 || hd % 8 != 0 || hd > 128 ||
      B <= 0 || Sq <= 0 || Sk <= 0 || window < 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype != repro::kFloat32 && dtype != repro::kBFloat16)
    return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    o,    q_sb, q_sh,   q_ss,   k_sb,
           k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,   o_sh,   o_ss,
           H,    K,    Sq,   Sk,   hd,   causal, window, scale, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return (int)dispatch<32>(dtype, p, B, st);
  if (hd <= 64) return (int)dispatch<64>(dtype, p, B, st);
  return (int)dispatch<128>(dtype, p, B, st);
}
