// Fused top-k selection + escape pmf + quantized CDF, one thread-block
// cluster per row.
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
// 3.35 TB/s: 1.45 us for 16 rows of 151,936 bf16 logits. One CTA per
// row would leave 116 of the 132 SMs idle and stream each row through
// one SM's share of the bandwidth, so the row is split.
//
// Design. A cluster of C CTAs takes one row, CTA r its contiguous slice
// [r * slice, (r + 1) * slice). C and the slice width are functions of V
// and the dtype alone (kernels/ops.py `topk_cdf_geometry`: C = 8 at
// V = 151,936, so 16 rows fill 128 of the 132 SMs; C = 1 at 258), so a
// row's integers never depend on the other rows or on the card.
//   1. The slice is copied from HBM once, into shared memory, by 16-byte
//      `cp.async` where its start is 16-byte aligned and by scalar loads
//      otherwise (pred-base's 258-wide fp32 rows, a 1,032-byte stride).
//      A slice too large for shared memory (fp32 beyond V ~ 327K) is
//      read from global memory on every pass instead.
//   2. A pass over the copy takes the slice's max (exact in any order)
//      and a histogram of the keys' top 12 bits (order-preserving float
//      keys, 4,096 bins, plain shared-memory integer atomics: counts do
//      not depend on their order).
//   3. A radix select finds the slice's k-th largest key: bits 31-20,
//      then 19-8 of the keys that share the prefix, then 7-0 (fp32
//      only; a bf16 key's low byte follows from its sign). The pass over
//      bits 19-8 also sums exp(x - max), element i of the slice on
//      thread (i / 8) % 512 in ascending order, then a fixed tree, so
//      the order does not depend on the row's alignment. The slice's top
//      k are the keys above the k-th and the smallest ids among the keys
//      equal to it (ranked directly when at most 1,024 keys tie, by an
//      ordered block scan otherwise). The row's top k lie in the union
//      of the slices' top k.
//   4. Each CTA sorts its k candidates -- 64-bit words, key above
//      complemented id, so one compare orders (value desc, id asc) --
//      and writes the sorted list, its (max, sum) and its count into CTA
//      0's shared memory (distributed shared memory; a cluster barrier
//      arrived at the start and waited on here guarantees CTA 0 runs).
//      After one cluster barrier CTA 0 places each candidate at its rank
//      in the merged order (its place in its own list plus a binary
//      search in each other list), so a threshold value tied across two
//      slices keeps its smallest ids, and merges the (max, sum) pairs in
//      rank order.
//   5. CTA 0 emits the escape pmf and the cumulative-rounding CDF as the
//      Pallas kernel does: the exps and divisions run in parallel, the
//      three running sums sequentially in slot order.
// No float atomics; every sum runs in a fixed order. The partial sums'
// order differs from the one-CTA-per-row kernel this replaced, so a CDF
// point may differ by one quantum from that kernel's (within the plain
// version's tolerance either way).
//
// Plain C interface, bound from Python with ctypes (kernels/ops.py).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 256;
constexpr int kMaxClusters = 8;
constexpr int kBins = 4096;            // 12-bit digits
constexpr int kBinsPerThread = kBins / kThreads;
constexpr int kEqCap = 1024;           // keys tied at the threshold ranked
                                       // directly; more take the scan
constexpr int kChunk = 8;              // elements per thread per step
constexpr size_t kStageLimit = 160 * 1024;
static_assert(kBinsPerThread * kThreads == kBins, "bins per thread");
static_assert(kEqCap <= kBins, "tie buffer in hist");

__device__ __forceinline__ float key_float(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The bin holding the rem-th largest key of `hist` (bins counted from the
// top): sel[0] = bin, sel[1] = keys in the bins above it. Thread t owns
// bins kBins-1-8t .. kBins-8-8t.
__device__ __forceinline__ void select_bin(const unsigned* hist, int rem,
                                           int* sel, int* scan) {
  const int tid = threadIdx.x;
  int c[kBinsPerThread];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    c[j] = (int)hist[kBins - 1 - kBinsPerThread * tid - j];
    mine += c[j];
  }
  int total;
  int above = repro::block_exclusive_scan_int(mine, scan, &total);
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    if (above < rem && above + c[j] >= rem) {
      sel[0] = kBins - 1 - kBinsPerThread * tid - j;
      sel[1] = above;
    }
    above += c[j];
  }
  __syncthreads();
}

// A candidate as one 64-bit word: the key above the complement of the id,
// so that a larger word comes first in lax.top_k's order (value
// descending, smallest id first among ties) and no two words are equal.
__device__ __forceinline__ uint64_t pack_cand(uint32_t key, int id) {
  return ((uint64_t)key << 32) | (uint32_t)~(uint32_t)id;
}

// Entries of the descending list a[0, n) greater than x.
__device__ __forceinline__ int count_greater(const uint64_t* a, int n,
                                             uint64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Sum of a[0, n) in index order, loads batched ahead of the adds.
__device__ __forceinline__ float ordered_sum(const float* a, int n) {
  float s = 0.0f;
  int t = 0;
  for (; t + 8 <= n; t += 8) {
    float q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = a[t + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) s += q[j];
  }
  for (; t < n; ++t) s += a[t];
  return s;
}

// Block-wide max and ordered sum; every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = repro::warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = repro::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return ordered_sum(red, kThreads / 32);
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
topk_cdf_kernel(const T* __restrict__ logits, long long row_stride, int V,
                int k, int slice, float budget, int* __restrict__ ids_out,
                int* __restrict__ cdf_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];  // the slice
  __shared__ unsigned hist[kBins];     // histogram; then the tie buffer
  __shared__ float red_m[kThreads / 32], red_s[kThreads / 32];
  __shared__ int scan[33];
  __shared__ int sel[2];
  __shared__ int n_cand, n_tied;
  __shared__ uint64_t cand[kMaxK];     // this slice's top k, any order
  // CTA 0 only, written by every CTA of the cluster: the slices' sorted
  // lists, their lengths and (max, sum exp) pairs
  __shared__ uint64_t all_c[kMaxClusters * kMaxK];
  __shared__ int cnt[kMaxClusters];
  __shared__ float part_m[kMaxClusters], part_s[kMaxClusters];
  __shared__ uint64_t top[kMaxK];
  __shared__ float pmf[kMaxK + 1];
  __shared__ float tot_s;

  cg::cluster_group cluster = cg::this_cluster();
  // every CTA must have started before another writes into its shared
  // memory: arrive now, wait just before the writes
  repro::cluster_arrive_relaxed();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lo = rank * slice;
  const int n = max(0, min(V, lo + slice) - lo);   // live elements
  const int nch = (n + kChunk - 1) / kChunk;
  const T* gx = logits + row * row_stride + lo;

  // 1. the slice into shared memory, once
  const T* src = gx;
  if constexpr (kStaged) {
    T* sx = reinterpret_cast<T*>(smem_raw);
    constexpr int kVec = 16 / sizeof(T);
    const bool aligned = (reinterpret_cast<uintptr_t>(gx) & 15u) == 0;
    const int nvec = aligned ? n / kVec : 0;
    for (int i = tid; i < nvec; i += kThreads)
      repro::cp_async16(sx + i * kVec, gx + i * kVec);
    asm volatile("cp.async.commit_group;\n" ::);
    for (int i = nvec * kVec + tid; i < n; i += kThreads) sx[i] = gx[i];
    asm volatile("cp.async.wait_group 0;\n" ::);
    src = sx;
  }
  for (int i = tid; i < kBins; i += kThreads) hist[i] = 0u;
  if (tid == 0) {
    n_cand = 0;
    n_tied = 0;
  }
  __syncthreads();

  // 2. the slice's max (exact in any order) + histogram of bits 31-20
  float mx = -INFINITY;
  for (int c = tid; c < nch; c += kThreads) {
    float v[kChunk];
    repro::read8<T, kStaged>(src, c, n, v);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (c * kChunk + j < n) {
        mx = fmaxf(mx, v[j]);
        atomicAdd(&hist[repro::float_key(v[j]) >> 20], 1u);
      }
    }
  }
  const float M = block_max(mx, red_m);     // its barrier publishes hist

  // 3. radix select of the slice's k-th largest key; the pass over bits
  // 19-8 also sums exp(x - M), each thread over its elements in
  // ascending order, then a fixed tree
  const bool take_all = n <= k;
  constexpr int kPasses = sizeof(T) == 2 ? 2 : 3;
  int rem = k;
  uint32_t prefix = 0u;
  int n_eq = 0;
  float S = 0.0f;
  for (int pass = 0; pass < kPasses; ++pass) {
    if (take_all && pass > 1) break;   // the sum is in; nothing to select
    if (pass > 0) {
      for (int i = tid; i < kBins; i += kThreads) hist[i] = 0u;
      __syncthreads();
      const int shift = pass == 1 ? 8 : 0;
      const uint32_t pmask = pass == 1 ? 0xfff00000u : 0xffffff00u;
      const uint32_t dmask = pass == 1 ? 0xfffu : 0xffu;
      float acc = 0.0f;
      for (int c = tid; c < nch; c += kThreads) {
        float v[kChunk];
        repro::read8<T, kStaged>(src, c, n, v);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (c * kChunk + j >= n) continue;
          if (pass == 1 && M > -INFINITY) acc += expf(v[j] - M);
          const uint32_t key = repro::float_key(v[j]);
          if (!take_all && (key & pmask) == prefix)
            atomicAdd(&hist[(key >> shift) & dmask], 1u);
        }
      }
      if (pass == 1) S = block_sum(acc, red_s);  // its barrier publishes hist
      else __syncthreads();
    }
    if (take_all) continue;
    select_bin(hist, rem, sel, scan);
    const int shift = pass == 0 ? 20 : (pass == 1 ? 8 : 0);
    rem -= sel[1];
    prefix |= (uint32_t)sel[0] << shift;
    if (pass == kPasses - 1) n_eq = (int)hist[sel[0]];
    __syncthreads();
  }
  // a bf16 key's low 16 bits are all 0 (value >= +0) or all 1
  if (sizeof(T) == 2) prefix |= (prefix & 0x80000000u) ? 0u : 0xffu;
  const uint32_t thr = take_all ? 0u : prefix;
  const int need_eq = rem;

  // gather this slice's top k (any order; sorted below)
  const bool all_eq = take_all || n_eq == need_eq;
  int* tied = reinterpret_cast<int*>(hist);
  if (all_eq || n_eq <= kEqCap) {
    for (int c = tid; c < nch; c += kThreads) {
      float v[kChunk];
      repro::read8<T, kStaged>(src, c, n, v);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int i = c * kChunk + j;
        const uint32_t key = repro::float_key(v[j]);
        if (i >= n) continue;
        if (key > thr || (all_eq && key == thr))
          cand[atomicAdd(&n_cand, 1)] = pack_cand(key, lo + i);
        else if (key == thr)
          tied[atomicAdd(&n_tied, 1)] = lo + i;
      }
    }
    __syncthreads();
    if (!all_eq) {
      // keep the need_eq smallest ids among the tied keys
      for (int e = tid; e < n_eq; e += kThreads) {
        const int id = tied[e];
        int r = 0;
        for (int f = 0; f < n_eq; ++f) r += tied[f] < id;
        if (r < need_eq) cand[atomicAdd(&n_cand, 1)] = pack_cand(thr, id);
      }
    }
  } else {
    // many keys tied at the threshold: an ordered scan keeps the
    // smallest ids (chunks in order, elements in order inside a chunk)
    int eq_seen = 0;
    for (int base = 0; base < nch; base += kThreads) {
      const int c = base + tid;
      float v[kChunk];
      uint32_t key[kChunk];
      int mine = 0;
      if (c < nch) repro::read8<T, kStaged>(src, c, n, v);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const bool live = c < nch && c * kChunk + j < n;
        key[j] = live ? repro::float_key(v[j]) : 0u;
        mine += live && key[j] == thr;
      }
      int tot;
      int r = repro::block_exclusive_scan_int(mine, scan, &tot);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const bool live = c < nch && c * kChunk + j < n;
        if (!live) continue;
        bool keep = key[j] > thr;
        if (key[j] == thr) keep = eq_seen + r++ < need_eq;
        if (keep)
          cand[atomicAdd(&n_cand, 1)] = pack_cand(key[j], lo + c * kChunk + j);
      }
      eq_seen += tot;
    }
  }
  __syncthreads();

  // 4. sort the slice's candidates into CTA 0's list for this slice
  repro::cluster_wait();
  const int nc = n_cand;
  uint64_t* dst = cluster.map_shared_rank(all_c, 0) + rank * k;
  for (int t = tid; t < nc; t += kThreads) {
    const uint64_t x = cand[t];
    int r = 0;
#pragma unroll 4
    for (int j = 0; j < nc; ++j) r += cand[j] > x;
    dst[r] = x;
  }
  if (tid == 0) {
    *cluster.map_shared_rank(cnt + rank, 0) = nc;
    *cluster.map_shared_rank(part_m + rank, 0) = M;
    *cluster.map_shared_rank(part_s + rank, 0) = S;
  }
  cluster.sync();                      // the lists are in; others may go
  if (rank != 0) return;

  // each candidate at its rank in the merged order
  for (int e = tid; e < C * k; e += kThreads) {
    const int c = e / k, p = e - c * k;
    if (p >= cnt[c]) continue;
    const uint64_t x = all_c[e];
    int r = p;
    for (int c2 = 0; c2 < C; ++c2)
      if (c2 != c) r += count_greater(all_c + c2 * k, cnt[c2], x);
    if (r < k) top[r] = x;
  }
  __syncthreads();

  // 5. escape pmf + cumulative rounding, as ac_cdf._topk_cdf_kernel's
  // emit; the row's (max, sum) merged over the slices in rank order
  repro::MaxSum ms = {part_m[0], part_s[0]};
  for (int c = 1; c < C; ++c)
    ms = repro::maxsum_merge(ms, {part_m[c], part_s[c]});
  int* ids = ids_out + (long long)row * k;
  int* cdf = cdf_out + (long long)row * (k + 2);
  for (int t = tid; t < k; t += kThreads) {
    pmf[t] = expf(key_float((uint32_t)(top[t] >> 32)) - ms.m) / ms.s;
    ids[t] = (int)~(uint32_t)top[t];
  }
  __syncthreads();
  if (tid == 0) {
    const float sum = ordered_sum(pmf, k);
    pmf[k] = fminf(fmaxf(1.0f - sum, 0.0f), 1.0f);      // ESCAPE
    tot_s = ordered_sum(pmf, k + 1);
  }
  __syncthreads();
  const float tot = tot_s;
  for (int t = tid; t <= k; t += kThreads) pmf[t] = pmf[t] / tot;
  __syncthreads();
  if (tid == 0) {                      // cumulative, in place, slot order
    float run = 0.0f;
    int t = 0;
    for (; t + 8 <= k + 1; t += 8) {
      float q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = pmf[t + j];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        run += q[j];
        pmf[t + j] = run;
      }
    }
    for (; t <= k; ++t) {
      run += pmf[t];
      pmf[t] = run;
    }
  }
  __syncthreads();
  const float last = pmf[k];
  if (tid == 0) cdf[0] = 0;
  for (int t = tid; t <= k; t += kThreads) {
    const float c = pmf[t] / last;
    cdf[t + 1] = (int)floorf(c * budget + 0.5f) + t + 1;
  }
}

template <typename T, bool kStaged>
cudaError_t launch(const void* logits, long long row_stride, int B, int V,
                   int k, int clusters, int slice, float budget, int* ids,
                   int* cdf, cudaStream_t st) {
  auto kern = topk_cdf_kernel<T, kStaged>;
  const size_t smem = kStaged ? sizeof(T) * (size_t)slice : 0;
  // the static arrays count against the 48 KB a block gets without
  // opting in, so opt in for any dynamic size larger than seen so far
  static size_t allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * B), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(logits), row_stride,
                     V, k, slice, budget, ids, cdf);
  return cudaGetLastError();            // also clears a refused launch's
}

}  // namespace

// logits (B, V) with row stride `row_stride` elements and unit column
// stride; ids (B, k) and cdf (B, k+2) int32, contiguous. `clusters` CTAs
// per row, each over `slice` logits (a multiple of 8; the slices cover V
// and none is empty), staged in shared memory when `staged` != 0: the
// geometry of kernels/ops.py `topk_cdf_geometry`. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_topk_cdf(const void* logits, long long row_stride,
                              int dtype, int B, int V, int k, int precision,
                              int clusters, int slice, int staged, void* ids,
                              void* cdf, void* stream) {
  if (k < 1 || k > kMaxK || k > V || precision < 1 || precision > 24 ||
      (1 << precision) <= k + 1 || B < 1 || clusters < 1 ||
      clusters > kMaxClusters || slice < 1 || slice % kChunk != 0 ||
      (long long)clusters * slice < V ||
      (long long)(clusters - 1) * slice >= V ||
      (long long)clusters * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype != repro::kFloat32 && dtype != repro::kBFloat16)
    return (int)cudaErrorInvalidValue;
  const size_t el = dtype == repro::kFloat32 ? 4 : 2;
  if (staged && el * (size_t)slice > kStageLimit)
    return (int)cudaErrorInvalidValue;
  const float budget = (float)((1 << precision) - (k + 1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ids_i = static_cast<int*>(ids);
  int* cdf_i = static_cast<int*>(cdf);
  cudaError_t e;
  if (dtype == repro::kFloat32)
    e = staged ? launch<float, true>(logits, row_stride, B, V, k, clusters,
                                     slice, budget, ids_i, cdf_i, st)
               : launch<float, false>(logits, row_stride, B, V, k, clusters,
                                      slice, budget, ids_i, cdf_i, st);
  else
    e = staged ? launch<__nv_bfloat16, true>(logits, row_stride, B, V, k,
                                             clusters, slice, budget, ids_i,
                                             cdf_i, st)
               : launch<__nv_bfloat16, false>(logits, row_stride, B, V, k,
                                              clusters, slice, budget, ids_i,
                                              cdf_i, st);
  return (int)e;
}
