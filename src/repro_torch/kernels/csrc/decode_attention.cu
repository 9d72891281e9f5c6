// Single-token GQA decode attention over a per-lane KV cache, each lane's
// positions split over a thread-block cluster.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (`decode_attention` / `_decode_kernel`): for every lane b and query
// head h, o[b,h] = softmax(q[b,h] . k[b,:len_b,h/G] / sqrt(hd)) @
// v[b,:len_b,h/G], fp32 accumulation, output in q's dtype. Positions at
// or past lengths[b] are skipped, which is exact: the reference's masked
// terms are exp(-1e30 - m) == 0.
//
// Bound on the H100: bytes. Each (lane, kv-head) reads len_b * hd
// K and V values once and does 4 * G * hd flops per position, ~1 flop
// per byte in bf16 -- far below the card's ~295 flop/byte ridge, so the
// least time is the live K/V bytes over 3.35 TB/s (1.65 us at the
// qwen3-1.7b shape: 16 lanes, 8 kv-heads, hd 128, S 128).
//
// Design. The cache's allocated length S is cut into C slices of `per`
// positions (kernels/ops.py `decode_geometry`, a function of the static
// shapes only: at S = 128, 4 CTAs of 32 positions, so 16 lanes x 8
// kv-heads make 512 CTAs). A cluster of C CTAs takes one (kv-head, lane)
// and serves all G = H/K query heads of its group from one pass over its
// K/V, so no cache byte is read twice.
//   1. A CTA reads its lane's length, then issues the copies of q and of
//      every K and V row of its first tile of 32 positions at once:
//      16-byte `cp.async` into shared memory where the rows start on 16
//      bytes, scalar loads otherwise (zero-padded rows). Compute starts
//      when they have landed; a slice of more than one tile keeps the next
//      tile's copies in flight while it computes the current one. The
//      cache is read in the model's own (B, S, K, hd) layout through
//      strides (no transpose copy); rows are padded by 16 bytes so that
//      eight rows fall on eight different banks.
//   2. Scores. bf16 rows of a multiple of 16 channels: a warp's
//      tensor-core product (`mma.sync` m16n8k16, fp32 accumulate; the
//      products of bf16 values are exact, as in the fp32 reference) of
//      the group's q (the A rows; rows past G are zero) with eight key
//      rows. Up to G = 8 the upper eight A rows are zero registers; a
//      group of 9-16 heads (qwen3-moe-235b-a22b: 64 q-heads over 4
//      kv-heads) fills all sixteen, so one instruction serves the whole
//      group. Otherwise a group of lanes holds a key row as 16-byte
//      vectors, each lane sums its products in order, and a xor butterfly
//      finishes the dot product.
//   3. One online-softmax state (m, l) per q-head: a warp per head takes
//      the tile's max and the sum of exp in a fixed tree, and rescales.
//   4. Each thread owns channels of the output for all G heads and adds
//      the tile's p * v in position order, in fp32 as the reference does.
//   5. Every CTA pushes its (m, l, acc) into rank 0's shared memory over
//      distributed shared memory; after one cluster barrier rank 0 merges
//      the C states in rank order and writes the output. A CTA whose
//      positions all lie at or past the lane's length takes part with
//      m = -inf, l = 0 and never returns early: a cluster barrier that
//      one CTA skips hangs the others. The one exception is a lane whose
//      live positions all lie in rank 0's slice: there the merge would
//      return rank 0's own state bit for bit, so rank 0 writes it without
//      a barrier and the other CTAs of the cluster return at once.
// One launch per layer and step. The split depends on S, never on live
// lengths or on B, and every sum runs in a fixed order, so a lane's
// output is independent of the other lanes and reproducible bit for bit.
//
// The int8 cache (the JAX model's kv_cache_dtype="int8": rows quantized
// on write, one fp16 scale per (lane, position, kv-head)). Built from this
// same file with -DREPRO_KV_INT8 into a library of its own
// (kernels/build.py `decode_attention_int8`), whose entry point takes the
// two (B, S, K) scale arrays beside the int8 caches. Only step 1's tile
// loads change: each thread reads 4-byte words of int8 rows and the
// rows' scales into registers, several words in flight at once, and
// writes float(q) * float(scale), rounded once to the model dtype, into
// the same shared-memory tile the bf16 / fp32 kernel fills -- the value
// the plain version (kernels/ref.py `dequant_kv`) and the JAX model's
// `_dequant_kv(...).astype(dtype)` compute, bit for bit. Steps 2-5 are
// the kernel above, unchanged. So the cache is read from global memory
// as int8 once (hd + 2 bytes per row and kv-head against 2 hd in bf16),
// and no dequantized copy of it is ever written. These loads are plain
// (the values must pass through registers to be scaled), so unlike the
// cp.async path they do not overlap the previous tile's compute.
//
// Plain C interface, bound from Python with ctypes (kernels/ops.py).
#include <cooperative_groups.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;           // positions per tile (one per lane)
constexpr int kMaxG = 16;
constexpr int kMaxHd = 256;
constexpr int kMaxClusters = 8;
constexpr int kChan = kMaxHd / kThreads;    // output channels per thread
constexpr int kRowPad = 16;         // bytes past each q, K, V row (banks)
constexpr int kI8Words = 8;         // int8 words a thread has in flight
// A group of more than 8 heads takes q rows of at most this many bytes
// (hd 256 in bf16, 128 in fp32): sixteen rows' partial outputs from eight
// CTAs beside two K/V tiles must fit a CTA's 227 KB of shared memory.
constexpr int kWideRowBytes = 512;
#ifdef REPRO_KV_INT8
constexpr bool kInt8Cache = true;   // this library's caches are int8
#else
constexpr bool kInt8Cache = false;
#endif

// Head rows a CTA reserves (q rows, score rows, softmax states) for kG
// heads computed: 8 up to kG = 8 (the tensor-core path reads eight q rows
// whatever G is), 16 above.
__host__ __device__ constexpr int head_rows(int kG) { return kG > 8 ? 16 : 8; }

// Shared-memory layout of one CTA (bytes), the same on host and device.
// krow: a q or K/V row in bytes, padded; R: head_rows of the kernel.
struct Layout {
  int q, kv, s, alpha, pm, pl, fac, pacc, total;
  __host__ __device__ Layout(int krow, int R, int G, int nbuf, int C,
                             int hd) {
    q = 0;                                      // [R][krow]
    kv = q + R * krow;                          // [nbuf][2][kTile][krow]
    s = kv + nbuf * 2 * kTile * krow;           // [R][kTile] float
    alpha = s + R * kTile * 4;                  // [R] float
    pm = alpha + R * 4;                         // [C][R] float
    pl = pm + C * R * 4;                        // [C][R] float
    fac = pl + C * R * 4;                       // [C][R] float
    pacc = fac + C * R * 4;                     // [C][G][hd] float
    total = pacc + C * G * hd * 4;
  }
};

// 16 bytes of a shared-memory row as floats.
template <typename T>
__device__ __forceinline__ void vec_floats(const unsigned char* p,
                                           float (&x)[16 / sizeof(T)]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if constexpr (sizeof(T) == 2) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
}

// c += A (16 x 16, rows a0..a3) * B (16 x 8, b0 b1), bf16 in, fp32 out.
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// K and V rows of positions [p0, p0 + n) into one tile buffer, committed
// as one group of copies. rowb: the row's bytes rounded up to 16.
template <typename T, bool kVec>
__device__ __forceinline__ void load_tile(unsigned char* kbuf,
                                          unsigned char* vbuf, const T* kb,
                                          const T* vb, long long kv_ss,
                                          int p0, int n, int hd, int rowb,
                                          int krow) {
  if constexpr (kVec) {
    const int nvec = rowb / 16;
    for (int idx = threadIdx.x; idx < n * nvec; idx += kThreads) {
      const int j = idx / nvec, c = idx - j * nvec;
      const long long src = (p0 + j) * kv_ss + c * (16 / (int)sizeof(T));
      repro::cp_async16(kbuf + j * krow + c * 16, kb + src);
      repro::cp_async16(vbuf + j * krow + c * 16, vb + src);
    }
  } else {
    const int hdp = rowb / (int)sizeof(T), hdk = krow / (int)sizeof(T);
    T* ks = reinterpret_cast<T*>(kbuf);
    T* vs = reinterpret_cast<T*>(vbuf);
    for (int idx = threadIdx.x; idx < n * hdp; idx += kThreads) {
      const int j = idx / hdp, d = idx - j * hdp;
      const long long src = (p0 + j) * kv_ss + d;
      ks[j * hdk + d] = d < hd ? kb[src] : repro::from_float<T>(0.0f);
      vs[j * hdk + d] = d < hd ? vb[src] : repro::from_float<T>(0.0f);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// K and V rows of positions [p0, p0 + n) of an int8 cache into one tile
// buffer of T rows, dequantized: channel d of position p is
// float(q[p][d]) * float(scale[p]), rounded once to T; the row's padding
// past hd is zero. A thread takes 4-byte words of 4 channels (hd % 4 ==
// 0, rows on 4 bytes: checked by the wrapper), kI8Words of them loaded
// before any is converted, so that their loads are in flight together.
// sc_ss: the scales' stride over positions, in halves.
template <typename T>
__device__ __forceinline__ void load_tile_i8(
    unsigned char* kbuf, unsigned char* vbuf, const int8_t* kb,
    const int8_t* vb, const __half* ksb, const __half* vsb, long long kv_ss,
    long long sc_ss, int p0, int n, int hd, int rowb, int krow) {
  const int words = rowb / (int)sizeof(T) / 4;       // of the padded row
  const int hdk = krow / (int)sizeof(T);
  const int total = n * words;
  T* ks = reinterpret_cast<T*>(kbuf);
  T* vs = reinterpret_cast<T*>(vbuf);
  for (int base = threadIdx.x; base < total; base += kI8Words * kThreads) {
    char4 kw[kI8Words], vw[kI8Words];
    float sk[kI8Words], sv[kI8Words];
#pragma unroll
    for (int u = 0; u < kI8Words; ++u) {
      const int idx = base + u * kThreads;
      const int j = idx / words, d = 4 * (idx - j * words);
      kw[u] = vw[u] = make_char4(0, 0, 0, 0);
      sk[u] = sv[u] = 0.0f;
      if (idx < total && d < hd) {
        const long long p = p0 + j;
        kw[u] = *reinterpret_cast<const char4*>(kb + p * kv_ss + d);
        vw[u] = *reinterpret_cast<const char4*>(vb + p * kv_ss + d);
        sk[u] = __half2float(ksb[p * sc_ss]);
        sv[u] = __half2float(vsb[p * sc_ss]);
      }
    }
#pragma unroll
    for (int u = 0; u < kI8Words; ++u) {
      const int idx = base + u * kThreads;
      if (idx >= total) break;
      const int j = idx / words, d = 4 * (idx - j * words);
      T* kr = ks + j * hdk + d;
      T* vr = vs + j * hdk + d;
      kr[0] = repro::from_float<T>((float)kw[u].x * sk[u]);
      kr[1] = repro::from_float<T>((float)kw[u].y * sk[u]);
      kr[2] = repro::from_float<T>((float)kw[u].z * sk[u]);
      kr[3] = repro::from_float<T>((float)kw[u].w * sk[u]);
      vr[0] = repro::from_float<T>((float)vw[u].x * sv[u]);
      vr[1] = repro::from_float<T>((float)vw[u].y * sv[u]);
      vr[2] = repro::from_float<T>((float)vw[u].z * sv[u]);
      vr[3] = repro::from_float<T>((float)vw[u].w * sv[u]);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);   // the group count holds
}

// The K/V tile of positions [p0, p0 + n): copied (bf16 / fp32 cache) or
// dequantized (int8 cache, kI8).
template <typename T, bool kVec, bool kI8>
__device__ __forceinline__ void fill_tile(
    unsigned char* kbuf, unsigned char* vbuf, const void* kb, const void* vb,
    const __half* ksb, const __half* vsb, long long kv_ss, long long sc_ss,
    int p0, int n, int hd, int rowb, int krow) {
  if constexpr (kI8)
    load_tile_i8<T>(kbuf, vbuf, static_cast<const int8_t*>(kb),
                    static_cast<const int8_t*>(vb), ksb, vsb, kv_ss, sc_ss,
                    p0, n, hd, rowb, krow);
  else
    load_tile<T, kVec>(kbuf, vbuf, static_cast<const T*>(kb),
                       static_cast<const T*>(vb), kv_ss, p0, n, hd, rowb,
                       krow);
}

// kG: q-heads computed per group (G rounded up to 1, 2, 4, 8 or 16;
// heads past G are zero rows whose results are dropped), so that every
// loop over heads is unrolled. kMma: tensor-core scores (bf16, hd % 16 == 0, 16-byte rows);
// otherwise kVPL 16-byte vectors of a key row per lane. kVec: 16-byte
// copies (rows start on 16 bytes) or scalar ones. kI8: the caches are
// int8 (kc / vc int8, ksc / vsc their fp16 scales with strides sc_*);
// otherwise T, and the scales are unused.
template <typename T, int kG, bool kMma, int kVPL, bool kVec, bool kI8>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, long long q_sb,
                        long long q_sh, const void* __restrict__ kc,
                        const void* __restrict__ vc, long long kv_sb,
                        long long kv_ss, long long kv_sk,
                        const __half* __restrict__ ksc,
                        const __half* __restrict__ vsc, long long sc_sb,
                        long long sc_ss, long long sc_sk,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int K, int S, int hd, int per, int rowb,
                        int nbuf, float scale) {
  using CT = std::conditional_t<kI8, int8_t, T>;    // a cache element
  constexpr int kR = head_rows(kG);
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kE = 16 / sizeof(T);            // elements per vector
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int kh = blockIdx.x / C, b = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = rowb / 16;
  const int krow = rowb + kRowPad;              // row stride, bytes
  const Layout L(krow, kR, G, nbuf, C, hd);
  float* s_sc = reinterpret_cast<float*>(smem + L.s);
  float* s_alpha = reinterpret_cast<float*>(smem + L.alpha);

  // 1. the lane's length, then q of the group and this slice's first
  // tile: every copy in flight at once. q rows G..kG-1 are zero.
  int len = lengths[b];
  len = len < S ? len : S;
  // a lane whose live positions all lie in the first slice needs no
  // merge: rank 0 alone writes the output, the others return now, and
  // no CTA takes part in a cluster barrier (every CTA of the cluster
  // reads the same length, so all agree)
  const bool solo = len <= per;
  if (solo && rank != 0) return;
  // every CTA must have started before another writes into its shared
  // memory: arrive now, wait just before the writes
  if (!solo) repro::cluster_arrive_relaxed();
  const int lo = rank * per;
  const int hi = max(lo, min(lo + per, len));
  const int ntile = (hi - lo + kTile - 1) / kTile;
  const T* qb = q + b * q_sb + kh * G * q_sh;
  if constexpr (kVec) {
    for (int idx = tid; idx < G * nvec; idx += kThreads) {
      const int g = idx / nvec, c = idx - g * nvec;
      repro::cp_async16(smem + L.q + g * krow + c * 16,
                        qb + g * q_sh + c * kE);
    }
  } else {
    const int hdp = rowb / (int)sizeof(T), hdk = krow / (int)sizeof(T);
    T* sq = reinterpret_cast<T*>(smem + L.q);
    for (int idx = tid; idx < G * hdp; idx += kThreads) {
      const int g = idx / hdp, d = idx - g * hdp;
      sq[g * hdk + d] = d < hd ? qb[g * q_sh + d]
                               : repro::from_float<T>(0.0f);
    }
  }
  for (int idx = G * krow / 4 + tid; idx < kG * krow / 4; idx += kThreads)
    reinterpret_cast<float*>(smem + L.q)[idx] = 0.0f;
  if (tid < kR) s_alpha[tid] = 0.0f;
  const CT* kb = static_cast<const CT*>(kc) + b * kv_sb + kh * kv_sk;
  const CT* vb = static_cast<const CT*>(vc) + b * kv_sb + kh * kv_sk;
  const __half* ksb = kI8 ? ksc + b * sc_sb + kh * sc_sk : nullptr;
  const __half* vsb = kI8 ? vsc + b * sc_sb + kh * sc_sk : nullptr;
  const int tbytes = kTile * krow;
  if (ntile > 0)
    fill_tile<T, kVec, kI8>(smem + L.kv, smem + L.kv + tbytes, kb, vb, ksb,
                            vsb, kv_ss, sc_ss, lo, min(kTile, hi - lo), hd,
                            rowb, krow);

  // running softmax state of heads warp, warp + 4, ... (one warp per head)
  float m_run[kR / kWarps], l_run[kR / kWarps];
#pragma unroll
  for (int i = 0; i < kR / kWarps; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
  }
  // output channels tid, tid + 128 of every head
  float acc[kG][kChan];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int c = 0; c < kChan; ++c) acc[g][c] = 0.0f;

  for (int t = 0; t < ntile; ++t) {
    const int p0 = lo + t * kTile, n = min(kTile, hi - p0);
    unsigned char* kbuf = smem + L.kv + (t % nbuf) * 2 * tbytes;
    unsigned char* vbuf = kbuf + tbytes;
    if (t + 1 < ntile) {
      unsigned char* nk = smem + L.kv + ((t + 1) % nbuf) * 2 * tbytes;
      fill_tile<T, kVec, kI8>(nk, nk + tbytes, kb, vb, ksb, vsb, kv_ss,
                              sc_ss, p0 + kTile, min(kTile, hi - p0 - kTile),
                              hd, rowb, krow);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();

    // 2. scores of the tile's positions for every head of the group
    if constexpr (kMma) {
      // warp w: positions 8w..8w+7; lane (r, c4) = (lane / 4, lane % 4)
      // holds head r's scores of positions 2 c4, 2 c4 + 1 (and, from kG =
      // 16, head r + 8's)
      const int r = lane >> 2, c4 = lane & 3, n0 = warp * 8;
      const unsigned char* qr = smem + L.q + r * krow + 4 * c4;
      const unsigned char* kr = kbuf + (n0 + r) * krow + 4 * c4;
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (n0 < n) {
#pragma unroll 4
        for (int ks = 0; ks < hd / 16; ++ks) {
          const uint32_t a0 =
              *reinterpret_cast<const uint32_t*>(qr + 32 * ks);
          const uint32_t a2 =
              *reinterpret_cast<const uint32_t*>(qr + 32 * ks + 16);
          uint32_t a1 = 0u, a3 = 0u;
          if constexpr (kG > 8) {
            a1 = *reinterpret_cast<const uint32_t*>(qr + 8 * krow + 32 * ks);
            a3 = *reinterpret_cast<const uint32_t*>(qr + 8 * krow + 32 * ks +
                                                    16);
          }
          const uint32_t b0 =
              *reinterpret_cast<const uint32_t*>(kr + 32 * ks);
          const uint32_t b1 =
              *reinterpret_cast<const uint32_t*>(kr + 32 * ks + 16);
          mma16816(c, a0, a1, a2, a3, b0, b1);
        }
      }
      const int j = n0 + 2 * c4;
      if (r < kG && j < n) s_sc[r * kTile + j] = c[0] * scale;
      if (r < kG && j + 1 < n) s_sc[r * kTile + j + 1] = c[1] * scale;
      if constexpr (kG > 8) {
        if (j < n) s_sc[(r + 8) * kTile + j] = c[2] * scale;
        if (j + 1 < n) s_sc[(r + 8) * kTile + j + 1] = c[3] * scale;
      }
    } else {
      // groups of W lanes hold one key row as kVPL 16-byte vectors a lane;
      // a group takes two positions per pass (every lane of a warp runs
      // the same trips: the butterfly needs all)
      int W = 1;
      while (W < 32 && W * kVPL < nvec) W <<= 1;
      const int sub = lane / W, sl = lane - sub * W;
      const int stride = kWarps * (32 / W);     // positions per CTA pass
      for (int jb = warp * (32 / W); jb < n; jb += 2 * stride) {
        const int js[2] = {jb + sub, jb + stride + sub};
        float kr[2][kVPL][kE];
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int c = 0; c < kVPL; ++c) {
            const int vi = sl + c * W;
            if (js[p] < n && vi < nvec) {
              vec_floats<T>(kbuf + js[p] * krow + vi * 16, kr[p][c]);
            } else {
#pragma unroll
              for (int e = 0; e < kE; ++e) kr[p][c][e] = 0.0f;
            }
          }
        float part[2][kG];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          part[0][g] = 0.0f;
          part[1][g] = 0.0f;
#pragma unroll
          for (int c = 0; c < kVPL; ++c) {
            const int vi = sl + c * W;
            if (vi >= nvec) continue;
            float qv[kE];
            vec_floats<T>(smem + L.q + g * krow + vi * 16, qv);
#pragma unroll
            for (int e = 0; e < kE; ++e) {
              part[0][g] += qv[e] * kr[0][c][e];
              part[1][g] += qv[e] * kr[1][c][e];
            }
          }
        }
        for (int o = W >> 1; o > 0; o >>= 1)
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int g = 0; g < kG; ++g)
              part[p][g] += __shfl_xor_sync(0xffffffffu, part[p][g], o);
        if (sl == 0) {
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int g = 0; g < kG; ++g)
              if (js[p] < n) s_sc[g * kTile + js[p]] = part[p][g] * scale;
        }
      }
    }
    __syncthreads();

    // 3. online softmax, one warp per head
#pragma unroll
    for (int i = 0; i < kR / kWarps; ++i) {
      const int g = warp + i * kWarps;
      if (g >= G) break;
      const float sc = lane < n ? s_sc[g * kTile + lane] : -INFINITY;
      const float m_new = fmaxf(m_run[i], repro::warp_max(sc));
      const float alpha = expf(m_run[i] - m_new);
      const float p = lane < n ? expf(sc - m_new) : 0.0f;
      l_run[i] = l_run[i] * alpha + repro::warp_sum(p);
      m_run[i] = m_new;
      s_sc[g * kTile + lane] = p;
      if (lane == 0) s_alpha[g] = alpha;
    }
    __syncthreads();

    // 4. acc = acc * alpha + p . v, positions in order; each V element
    // is read once for all the heads
    const T* vs = reinterpret_cast<const T*>(vbuf);
    const int hdv = krow / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < kChan; ++c) {
      const int d = tid + c * kThreads;
      if (d >= hd) break;
      float a[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) a[g] = acc[g][c] * s_alpha[g];
      int j = 0;
      for (; j + 4 <= n; j += 4) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = repro::to_float(vs[(j + u) * hdv + d]);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(s_sc + g * kTile + j);
          a[g] += p4.x * v[0];
          a[g] += p4.y * v[1];
          a[g] += p4.z * v[2];
          a[g] += p4.w * v[3];
        }
      }
      for (; j < n; ++j) {
        const float v = repro::to_float(vs[j * hdv + d]);
#pragma unroll
        for (int g = 0; g < kG; ++g) a[g] += s_sc[g * kTile + j] * v;
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[g][c] = a[g];
    }
    __syncthreads();                  // before the next tile's loads land
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);   // no copy outlives the CTA

  // 5. alone, rank 0's state is the lane's: the merge below would weigh
  // it by exp(0) == 1 and add only zeros, so this is the same output bit
  // for bit
  float* pl_own = reinterpret_cast<float*>(smem + L.pl);
  if (solo) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kR / kWarps; ++i) {
        const int g = warp + i * kWarps;
        if (g < G) pl_own[g] = l_run[i];
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChan; ++c) {
      const int d = tid + c * kThreads;
      if (d >= hd) break;
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (g < G)
          out[((long long)b * H + kh * G + g) * hd + d] =
              repro::from_float<T>(acc[g][c] / fmaxf(pl_own[g], 1e-30f));
    }
    return;
  }

  // otherwise this CTA's state into rank 0's shared memory
  repro::cluster_wait();
  float* pm = cluster.map_shared_rank(reinterpret_cast<float*>(smem + L.pm), 0);
  float* pl = cluster.map_shared_rank(reinterpret_cast<float*>(smem + L.pl), 0);
  float* pacc =
      cluster.map_shared_rank(reinterpret_cast<float*>(smem + L.pacc), 0);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kR / kWarps; ++i) {
      const int g = warp + i * kWarps;
      if (g < G) {
        pm[rank * kR + g] = m_run[i];
        pl[rank * kR + g] = l_run[i];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kChan; ++c) {
    const int d = tid + c * kThreads;
    if (d >= hd) break;
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < G) pacc[(rank * G + g) * hd + d] = acc[g][c];
  }
  cluster.sync();                     // the states are in; others may go
  if (rank != 0) return;

  // merge the C states in rank order: each slice's weight exp(m_r - M)
  // once per (slice, head), then every output element
  const float* sm = reinterpret_cast<const float*>(smem + L.pm);
  const float* sl_ = reinterpret_cast<const float*>(smem + L.pl);
  const float* sa = reinterpret_cast<const float*>(smem + L.pacc);
  float* fac = reinterpret_cast<float*>(smem + L.fac);
  {
    // kR x kMaxClusters = 128 = kThreads at most: one (slice, head) each
    const int r = tid / kR, g = tid - r * kR;
    if (r < C && g < G) {
      float M = -INFINITY;
#pragma unroll
      for (int q2 = 0; q2 < kMaxClusters; ++q2)
        if (q2 < C) M = fmaxf(M, sm[q2 * kR + g]);
      const float mr = sm[r * kR + g];
      fac[r * kR + g] = mr == -INFINITY ? 0.0f : expf(mr - M);
    }
  }
  __syncthreads();
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd, d = e - g * hd;
    float Ls = 0.0f, O = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxClusters; ++r) {
      if (r >= C) break;
      const float a = fac[r * kR + g];
      Ls += sl_[r * kR + g] * a;
      O += sa[(r * G + g) * hd + d] * a;
    }
    out[((long long)b * H + kh * G + g) * hd + d] =
        repro::from_float<T>(O / fmaxf(Ls, 1e-30f));
  }
}

// The int8 scales of a launch: null pointers for a bf16 / fp32 cache.
struct Scales {
  const __half* k;
  const __half* v;
  long long sb, ss, sk;
};

template <typename T, int kG, bool kMma, int kVPL, bool kVec>
cudaError_t launch(const void* q, long long q_sb, long long q_sh,
                   const void* k, const void* v, long long kv_sb,
                   long long kv_ss, long long kv_sk, const Scales& sc,
                   const int* lengths, void* out, int B, int H, int K, int S,
                   int hd, int C, int per, int rowb, float scale,
                   cudaStream_t st) {
  auto kern = decode_attention_kernel<T, kG, kMma, kVPL, kVec, kInt8Cache>;
  const int nbuf = per > kTile ? 2 : 1;
  const size_t smem =
      (size_t)Layout(rowb + kRowPad, head_rows(kG), H / K, nbuf, C, hd).total;
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
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * K), (unsigned)B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;          // a lone CTA needs no cluster
  cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q), q_sb, q_sh, k, v,
                     kv_sb, kv_ss, kv_sk, sc.k, sc.v, sc.sb, sc.ss, sc.sk,
                     lengths, static_cast<T*>(out), H, K, S, hd, per, rowb,
                     nbuf, scale);
  return cudaGetLastError();            // also clears a refused launch's
}

// The kernel for this dtype, row width and group size. Rows of 16-byte
// vectors: bf16 with hd % 16 == 0 on the tensor cores, the rest on lanes
// holding one vector, or two from 9 vectors a row (fp32 hd > 32, bf16 hd
// 120), with the heads rounded up to 1, 2, 4, 8 or 16. Rows that do not
// start on 16 bytes take scalar copies. Every G <= 8 takes the instance it
// took before groups of 16 were added, so its output is unchanged.
template <typename T>
cudaError_t dispatch(int vec, const void* q, long long q_sb, long long q_sh,
                     const void* k, const void* v, long long kv_sb,
                     long long kv_ss, long long kv_sk, const Scales& sc,
                     const int* lengths, void* out, int B, int H, int K,
                     int S, int hd, int C, int per, float scale,
                     cudaStream_t st) {
  const int rowb = (hd * (int)sizeof(T) + 15) / 16 * 16;
  const int G = H / K;
  const bool two = rowb / 16 > 8;
  constexpr bool kBf16 = sizeof(T) == 2;
#define REPRO_LAUNCH(kG, kMma, kVPL, kVec)                                  \
  launch<T, kG, kMma, kVPL, kVec>(q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sk, \
                                  sc, lengths, out, B, H, K, S, hd, C, per, \
                                  rowb, scale, st)
  const bool wide = G > 8;
  if (!vec || (hd * (int)sizeof(T)) % 16 != 0) {
    if (wide)
      return two ? REPRO_LAUNCH(16, false, 2, false)
                 : REPRO_LAUNCH(16, false, 1, false);
    return two ? REPRO_LAUNCH(8, false, 2, false)
               : REPRO_LAUNCH(8, false, 1, false);
  }
  if constexpr (kBf16) {
    if (hd % 16 != 0)
      return wide ? REPRO_LAUNCH(16, false, 2, true)
                  : REPRO_LAUNCH(8, false, 2, true);
    if (G == 1) return REPRO_LAUNCH(1, true, 1, true);
    if (G == 2) return REPRO_LAUNCH(2, true, 1, true);
    if (G <= 4) return REPRO_LAUNCH(4, true, 1, true);
    if (G <= 8) return REPRO_LAUNCH(8, true, 1, true);
    return REPRO_LAUNCH(16, true, 1, true);
  } else {
    if (G == 1)
      return two ? REPRO_LAUNCH(1, false, 2, true)
                 : REPRO_LAUNCH(1, false, 1, true);
    if (G == 2)
      return two ? REPRO_LAUNCH(2, false, 2, true)
                 : REPRO_LAUNCH(2, false, 1, true);
    if (G <= 4)
      return two ? REPRO_LAUNCH(4, false, 2, true)
                 : REPRO_LAUNCH(4, false, 1, true);
    if (G <= 8)
      return two ? REPRO_LAUNCH(8, false, 2, true)
                 : REPRO_LAUNCH(8, false, 1, true);
    return two ? REPRO_LAUNCH(16, false, 2, true)
               : REPRO_LAUNCH(16, false, 1, true);
  }
#undef REPRO_LAUNCH
}

// The checks and the dtype switch of both entry points.
int run(const void* q, long long q_sb, long long q_sh, const void* k,
        const void* v, long long kv_sb, long long kv_ss, long long kv_sk,
        const Scales& sc, const void* lengths, void* out, int B, int H,
        int K, int S, int hd, int dtype, float scale, int clusters, int per,
        int vec, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > kMaxG || hd <= 0 || hd > kMaxHd ||
      (H / K > 8 && hd * (dtype == repro::kFloat32 ? 4 : 2) > kWideRowBytes) ||
      S < 1 || B < 1 || B > 65535 || clusters < 1 ||
      clusters > kMaxClusters || per < 1 || per % kTile != 0 ||
      (long long)clusters * per < S || (long long)(clusters - 1) * per >= S ||
      (long long)clusters * K > 0x7fffffffLL ||
      (kInt8Cache && (hd % 4 != 0 || sc.k == nullptr || sc.v == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return (int)dispatch<float>(vec, q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sk,
                                sc, len, out, B, H, K, S, hd, clusters, per,
                                scale, st);
  if (dtype == repro::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(vec, q, q_sb, q_sh, k, v, kv_sb,
                                        kv_ss, kv_sk, sc, len, out, B, H, K,
                                        S, hd, clusters, per, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#ifndef REPRO_KV_INT8
// q (B, H, hd) with strides (q_sb, q_sh, 1); k/v cache of one layer
// (B, S, K, hd) with strides (kv_sb, kv_ss, kv_sk, 1); lengths (B,) int32;
// out (B, H, hd) contiguous. Strides are in elements. `clusters` CTAs per
// (kv-head, lane), each over `per` positions (a multiple of 32; the
// slices cover S and none is empty): the geometry of kernels/ops.py
// `decode_geometry`. `vec` != 0 when q and the caches' rows start on 16
// bytes (16-byte copies). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int repro_decode_attention(const void* q, long long q_sb,
                                      long long q_sh, const void* k,
                                      const void* v, long long kv_sb,
                                      long long kv_ss, long long kv_sk,
                                      const void* lengths, void* out, int B,
                                      int H, int K, int S, int hd, int dtype,
                                      float scale, int clusters, int per,
                                      int vec, void* stream) {
  return run(q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sk,
             Scales{nullptr, nullptr, 0, 0, 0}, lengths, out, B, H, K, S, hd,
             dtype, scale, clusters, per, vec, stream);
}
#else
// As repro_decode_attention, over an int8 cache: k/v (B, S, K, hd) int8
// with strides (kv_sb, kv_ss, kv_sk, 1) in bytes, whose rows start on 4
// bytes, hd % 4 == 0; k_scale / v_scale (B, S, K) fp16 with strides
// (sc_sb, sc_ss, sc_sk) in halves. q and out are float32 or bfloat16
// (`dtype`), the dtype the rows are dequantized to; `vec` says whether q's
// rows start on 16 bytes.
extern "C" int repro_decode_attention_int8(
    const void* q, long long q_sb, long long q_sh, const void* k,
    const void* v, long long kv_sb, long long kv_ss, long long kv_sk,
    const void* k_scale, const void* v_scale, long long sc_sb,
    long long sc_ss, long long sc_sk, const void* lengths, void* out, int B,
    int H, int K, int S, int hd, int dtype, float scale, int clusters,
    int per, int vec, void* stream) {
  return run(q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sk,
             Scales{static_cast<const __half*>(k_scale),
                    static_cast<const __half*>(v_scale), sc_sb, sc_ss, sc_sk},
             lengths, out, B, H, K, S, hd, dtype, scale, clusters, per, vec,
             stream);
}
#endif
