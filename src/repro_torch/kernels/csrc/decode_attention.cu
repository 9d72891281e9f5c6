// Single-token GQA decode attention over a per-lane KV cache.
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
// least time is the live K/V bytes over 3.35 TB/s.
//
// Design: one CTA per (kv-head, lane) serves all G = H/K query heads of
// its group from one pass over K/V, so no cache byte is read twice. The
// cache is read in the model's own (B, S, K, hd) layout through strides
// (no transpose copy). Eight warps take positions round-robin
// (position j -> warp j % 8); within a warp each lane holds hd/32
// contiguous channels, a dot product is one xor-butterfly, and each warp
// keeps its own online softmax (m, l, acc). The warps are merged in warp
// order at the end. The split of positions over warps depends only on
// the block shape, never on live lengths, and every sum runs in a fixed
// order, so a lane's output is independent of the other lanes and
// reproducible bit for bit.
//
// Plain C interface, bound from Python with ctypes (kernels/ops.py).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxG = 8;

template <typename T, int EPL>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, long long q_sb,
                        long long q_sh, const T* __restrict__ kc,
                        const T* __restrict__ vc, long long kv_sb,
                        long long kv_ss, long long kv_sk,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int K, int S, int hd, float scale) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int G = H / K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int len = lengths[b];
  len = len < S ? len : S;

  // this lane's channels: [lane * EPL, lane * EPL + EPL), masked at hd
  const int d0 = lane * EPL;
  float qr[kMaxG][EPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = d0 + i;
      qr[g][i] = (g < G && d < hd)
                     ? repro::to_float(q[b * q_sb + (kh * G + g) * q_sh + d])
                     : 0.0f;
    }
  }
  float m[kMaxG], l[kMaxG], acc[kMaxG][EPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.0f;
  }

  const T* kb = kc + b * kv_sb + kh * kv_sk;
  const T* vb = vc + b * kv_sb + kh * kv_sk;
  for (int j = warp; j < len; j += kWarps) {
    float kr[EPL], vr[EPL];
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = d0 + i;
      kr[i] = d < hd ? repro::to_float(kb[j * kv_ss + d]) : 0.0f;
      vr[i] = d < hd ? repro::to_float(vb[j * kv_ss + d]) : 0.0f;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) part += qr[g][i] * kr[i];
      const float s = repro::warp_sum(part) * scale;
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc[g][i] = acc[g][i] * alpha + p * vr[i];
      m[g] = m_new;
    }
  }

  // merge the warps' partial softmax states in warp order
  extern __shared__ float smem[];
  float* sm = smem;                              // [kWarps][G]
  float* sl = sm + kWarps * kMaxG;               // [kWarps][G]
  float* sacc = sl + kWarps * kMaxG;             // [kWarps][G][hd]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm[warp * kMaxG + g] = m[g];
      sl[warp * kMaxG + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      const int d = d0 + i;
      if (d < hd) sacc[(warp * kMaxG + g) * hd + d] = acc[g][i];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * hd; t += blockDim.x) {
    const int g = t / hd, d = t % hd;
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm[w * kMaxG + g]);
    float L = 0.0f, O = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm[w * kMaxG + g];
      if (mw == -INFINITY) continue;             // warp saw no position
      const float a = expf(mw - M);
      L += sl[w * kMaxG + g] * a;
      O += sacc[(w * kMaxG + g) * hd + d] * a;
    }
    out[((long long)b * H + kh * G + g) * hd + d] =
        repro::from_float<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int EPL>
cudaError_t launch(const void* q, long long q_sb, long long q_sh,
                   const void* k, const void* v, long long kv_sb,
                   long long kv_ss, long long kv_sk, const int* lengths,
                   void* out, int B, int H, int K, int S, int hd,
                   float scale, cudaStream_t stream) {
  const dim3 grid(K, B);
  const size_t smem = sizeof(float) * kWarps * kMaxG * (2 + hd);
  auto kern = decode_attention_kernel<T, EPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_sh, static_cast<const T*>(k),
      static_cast<const T*>(v), kv_sb, kv_ss, kv_sk, lengths,
      static_cast<T*>(out), H, K, S, hd, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int epl, const void* q, long long q_sb, long long q_sh,
                     const void* k, const void* v, long long kv_sb,
                     long long kv_ss, long long kv_sk, const int* lengths,
                     void* out, int B, int H, int K, int S, int hd,
                     float scale, cudaStream_t stream) {
  switch (epl) {
    case 1:
      return launch<T, 1>(q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sk, lengths,
                          out, B, H, K, S, hd, scale, stream);
    case 2:
      return launch<T, 2>(q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sk, lengths,
                          out, B, H, K, S, hd, scale, stream);
    case 4:
      return launch<T, 4>(q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sk, lengths,
                          out, B, H, K, S, hd, scale, stream);
    case 8:
      return launch<T, 8>(q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sk, lengths,
                          out, B, H, K, S, hd, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, hd) with strides (q_sb, q_sh, 1); k/v cache of one layer
// (B, S, K, hd) with strides (kv_sb, kv_ss, kv_sk, 1); lengths (B,) int32;
// out (B, H, hd) contiguous. Strides are in elements. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_decode_attention(const void* q, long long q_sb,
                                      long long q_sh, const void* k,
                                      const void* v, long long kv_sb,
                                      long long kv_ss, long long kv_sk,
                                      const void* lengths, void* out, int B,
                                      int H, int K, int S, int hd, int dtype,
                                      float scale, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > kMaxG || hd <= 0 || hd > 256)
    return (int)cudaErrorInvalidValue;
  int epl = 1;
  while (epl * 32 < hd) epl <<= 1;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return (int)dispatch<float>(epl, q, q_sb, q_sh, k, v, kv_sb, kv_ss, kv_sk,
                                len, out, B, H, K, S, hd, scale, st);
  if (dtype == repro::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(epl, q, q_sb, q_sh, k, v, kv_sb,
                                        kv_ss, kv_sk, len, out, B, H, K, S,
                                        hd, scale, st);
  return (int)cudaErrorInvalidValue;
}
