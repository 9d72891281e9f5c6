// Fused top-k selection + escape pmf + quantized CDF, one row per CTA.
//
// Replaces the TPU kernel src/repro/kernels/ac_cdf.py (`topk_cdf_points`
// / `_topk_cdf_kernel`): logits (B, V) -> ids (B, k) int32 in the order
// of lax.top_k (value descending, smallest id first among ties) and
// cdf (B, k+2) int32 with cdf[:, 0] == 0 and cdf[:, -1] == 2**precision,
// the (k+1)-symbol alphabet being the k slots plus ESCAPE. The pmf and
// the cumulative rounding follow the Pallas kernel's emit
// (ac_cdf.py:166-184) term for term.
//
// Bound on the H100: bytes. The function must read each logit once
// (V * 2 B per row in bf16) and write (2k+2) * 4 B; its flops (one exp
// per logit) are negligible, so the least time is the logits' bytes over
// 3.35 TB/s.
//
// Design. The TPU kernel merged each 2048-wide vocab block into a running
// top-k by k extract-max rounds -- on a GPU that is thousands of block
// reductions per row. Here the k-th largest value is found by a radix
// select on order-preserving float keys: four passes of 8-bit integer
// histograms in shared memory (warp-aggregated integer atomics; counts
// do not depend on their order), each pass restricted to the keys whose
// higher bytes match the prefix found so far. A gather pass then keeps
// every key above the threshold and the smallest-id keys equal to it
// (an ordered block scan when the threshold value is tied past k), and a
// rank sort over the k candidates puts them in (value desc, id asc)
// order. The first pass also carries the streaming softmax state
// (max, sum of exp). Rows are independent and every reduction runs in a
// fixed order: the result for a row never depends on the other rows of
// the launch. The ragged vocab tail is masked; V needs no multiple of
// any block. This first version re-reads the row once per pass (from L2
// at these sizes) and uses one CTA per row; split-row parallelism and
// vector loads are left for a later change.
//
// Plain C interface, bound from Python with ctypes (kernels/ops.py).
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxK = 256;
constexpr unsigned kFull = 0xffffffffu;

// histogram increment, aggregated over the lanes of a warp that hit the
// same bin (the top byte of most logits is shared, so plain atomics
// would serialise on one address)
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned bin,
                                         bool active) {
  const unsigned mask = __ballot_sync(kFull, active);
  if (!active) return;
  const unsigned peers = __match_any_sync(mask, bin);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[bin], (unsigned)__popc(peers));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_cdf_kernel(const T* __restrict__ logits, long long row_stride, int V,
                int k, float budget, int* __restrict__ ids_out,
                int* __restrict__ cdf_out) {
  __shared__ unsigned hist[256];
  __shared__ float red[64];
  __shared__ int scan[33];
  __shared__ int sel[2];
  __shared__ int n_cand;
  __shared__ float cand_v[kMaxK];
  __shared__ int cand_i[kMaxK];
  __shared__ uint32_t cand_key[kMaxK];
  __shared__ float top_v[kMaxK];
  __shared__ int top_i[kMaxK];
  __shared__ float pmf[kMaxK + 1];

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const T* x = logits + row * row_stride;

  // pass 0: streaming softmax state + histogram of the keys' top byte
  for (int i = tid; i < 256; i += kThreads) hist[i] = 0u;
  if (tid == 0) n_cand = 0;
  __syncthreads();
  repro::MaxSum ms = {-INFINITY, 0.0f};
  for (int base = 0; base < V; base += kThreads) {
    const int i = base + tid;
    const bool live = i < V;
    const float v = live ? repro::to_float(x[i]) : -INFINITY;
    if (live) ms = repro::maxsum_push(ms, v);
    hist_add(hist, repro::float_key(v) >> 24, live);
  }
  __syncthreads();
  ms = repro::block_maxsum(ms, red);

  // radix select of the k-th largest key, one byte per pass
  uint32_t prefix = 0u, pmask = 0u;
  int rem = k;                       // still to take among prefix matches
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    if (pass > 0) {
      for (int i = tid; i < 256; i += kThreads) hist[i] = 0u;
      __syncthreads();
      for (int base = 0; base < V; base += kThreads) {
        const int i = base + tid;
        uint32_t key = 0u;
        if (i < V) key = repro::float_key(repro::to_float(x[i]));
        hist_add(hist, (key >> shift) & 255u,
                 i < V && (key & pmask) == prefix);
      }
      __syncthreads();
    }
    // bins from the top: thread t owns bin 255 - t
    const int cnt = tid < 256 ? (int)hist[255 - tid] : 0;
    int total;
    const int above = repro::block_exclusive_scan_int(cnt, scan, &total);
    if (tid < 256 && above < rem && above + cnt >= rem) {
      sel[0] = 255 - tid;
      sel[1] = above;
    }
    __syncthreads();
    rem -= sel[1];
    prefix |= (uint32_t)sel[0] << shift;
    pmask |= 255u << shift;
    __syncthreads();
  }
  const uint32_t thr = prefix;       // key of the k-th largest logit
  const int need_eq = rem;           // how many keys == thr to keep
  const int n_eq = (int)hist[thr & 255u];

  // gather the k candidates (any order; sorted below)
  if (n_eq == need_eq) {
    for (int base = 0; base < V; base += kThreads) {
      const int i = base + tid;
      if (i >= V) break;
      const float v = repro::to_float(x[i]);
      const uint32_t key = repro::float_key(v);
      if (key >= thr) {
        const int s = atomicAdd(&n_cand, 1);
        cand_v[s] = v;
        cand_i[s] = i;
        cand_key[s] = key;
      }
    }
  } else {
    // the threshold value is tied past k: keep its smallest ids, found by
    // an ordered scan over the row
    int eq_seen = 0;
    for (int base = 0; base < V; base += kThreads) {
      const int i = base + tid;
      const bool live = i < V;
      const float v = live ? repro::to_float(x[i]) : 0.0f;
      const uint32_t key = live ? repro::float_key(v) : 0u;
      const int is_eq = live && key == thr;
      int tot;
      const int r = repro::block_exclusive_scan_int(is_eq, scan, &tot);
      if ((live && key > thr) || (is_eq && eq_seen + r < need_eq)) {
        const int s = atomicAdd(&n_cand, 1);
        cand_v[s] = v;
        cand_i[s] = i;
        cand_key[s] = key;
      }
      eq_seen += tot;
    }
  }
  __syncthreads();

  // rank sort: value descending, id ascending among ties
  for (int t = tid; t < k; t += kThreads) {
    const uint32_t kt = cand_key[t];
    const int it = cand_i[t];
    int rank = 0;
    for (int j = 0; j < k; ++j) {
      const uint32_t kj = cand_key[j];
      rank += (kj > kt) || (kj == kt && cand_i[j] < it);
    }
    top_v[rank] = cand_v[t];
    top_i[rank] = it;
  }
  __syncthreads();

  // escape pmf + cumulative rounding, as ac_cdf._topk_cdf_kernel's emit
  int* ids = ids_out + (long long)row * k;
  int* cdf = cdf_out + (long long)row * (k + 2);
  for (int t = tid; t < k; t += kThreads) {
    pmf[t] = expf(top_v[t] - ms.m) / ms.s;
    ids[t] = top_i[t];
  }
  __syncthreads();
  if (tid == 0) {
    float sum = 0.0f;
    for (int t = 0; t < k; ++t) sum += pmf[t];
    const float esc = fminf(fmaxf(1.0f - sum, 0.0f), 1.0f);
    pmf[k] = esc;
    float tot = 0.0f;
    for (int t = 0; t <= k; ++t) tot += pmf[t];
    float run = 0.0f;
    for (int t = 0; t <= k; ++t) {
      run += pmf[t] / tot;
      pmf[t] = run;                  // cumulative, in place
    }
    const float last = pmf[k];
    cdf[0] = 0;
    for (int t = 0; t <= k; ++t) {
      const float c = pmf[t] / last;
      cdf[t + 1] = (int)floorf(c * budget + 0.5f) + t + 1;
    }
  }
}

}  // namespace

// logits (B, V) with row stride `row_stride` elements and unit column
// stride; ids (B, k) and cdf (B, k+2) int32, contiguous. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_topk_cdf(const void* logits, long long row_stride,
                              int dtype, int B, int V, int k, int precision,
                              void* ids, void* cdf, void* stream) {
  if (k < 1 || k > kMaxK || k > V || precision < 1 || precision > 24 ||
      (1 << precision) <= k + 1)
    return (int)cudaErrorInvalidValue;
  const float budget = (float)((1 << precision) - (k + 1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ids_i = static_cast<int*>(ids);
  int* cdf_i = static_cast<int*>(cdf);
  if (dtype == repro::kFloat32)
    topk_cdf_kernel<float><<<B, kThreads, 0, st>>>(
        static_cast<const float*>(logits), row_stride, V, k, budget, ids_i,
        cdf_i);
  else if (dtype == repro::kBFloat16)
    topk_cdf_kernel<__nv_bfloat16><<<B, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), row_stride, V, k, budget,
        ids_i, cdf_i);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
