// Full-vocabulary quantized CDF, one thread-block cluster per row.
//
// Replaces the TPU kernel src/repro/kernels/ac_cdf.py (`cdf_points` /
// `_cdf_kernel`): logits (B, V) -> int32 (B, V) CDF interior points by
// cumulative rounding, pts[i] = floor(P(x <= i) * (T - V) + 0.5) + i + 1
// with T = 2**precision, so that every symbol keeps at least one quantum,
// the points increase strictly and pts[V-1] == T exactly.
//
// Bound on the H100: bytes. The function reads V logits and writes V
// int32 points per row (6 B per symbol in bf16): 4.35 us for 16 rows of
// 151,936 bf16 logits at 3.35 TB/s. One exp per logit is far below the
// flop rate. One CTA per row would leave 116 of the 132 SMs idle and
// stream each row through one SM's share of the bandwidth, so the row is
// split.
//
// Design. A cluster of C CTAs takes one row, CTA r its contiguous slice
// [r * slice, (r + 1) * slice). C and the slice width are functions of V
// and the dtype alone (kernels/ops.py `cdf_points_geometry`: C = 8 at
// V = 151,936, so 16 rows fill 128 of the 132 SMs; C = 1 at 258), so a
// row's integers never depend on the other rows or on the card.
//   1. The slice is copied from HBM once, into shared memory, by 16-byte
//      `cp.async` where its start is 16-byte aligned and by scalar loads
//      otherwise. Every later pass runs over shared memory. (A slice too
//      large for shared memory -- beyond V = 262,144 in bf16, 196,608 in
//      fp32 -- is read from global memory instead, and its running sums
//      are kept in the output row until the points overwrite them.)
//   2. The slice's max; the cluster exchanges the C maxima over
//      distributed shared memory (exact in any order).
//   3. One expf per logit, e = exp(x - max), and the slice's inclusive
//      prefix sums in a fixed order: warp w owns a contiguous run of
//      128-element rows, lane l four consecutive elements of a row; the
//      lane sums its four in order, a shuffle scan over the lanes gives
//      each lane its offset in the row, and the rows are chained by a
//      running carry. The warps' totals are chained by the same shuffle
//      scan, in warp order.
//   4. The cluster exchanges each slice's total and largest prefix; the
//      slices' offsets are their totals chained by the same scan, in
//      rank order.
//   5. A float scan computed in pieces is not monotone where the pieces
//      meet (an offset and the running sum it replaces round
//      differently), so each prefix is floored by the largest prefix of
//      everything before it: earlier CTAs, earlier warps, earlier lanes
//      and elements (a max-scan; max is exact, so the result is
//      deterministic). It is then normalised by the row's final (largest)
//      prefix -- x / x == 1 exactly -- which keeps the points strictly
//      increasing and the tail exact; the last point is forced to T too,
//      as the Pallas kernel does. Points are stored 16 bytes at a time
//      where V % 4 == 0.
// No float atomics; every sum runs in a fixed order that depends on
// (V, dtype) only. The sums' order differs from the one-CTA-per-row
// kernel this replaced, so a point may differ by one quantum from that
// kernel's (within the plain version's tolerance either way).
// tests/test_torch_geometry.py replays this order in plain PyTorch; on
// the card the replay gives these integers bit for bit.
//
// Plain C interface, bound from Python with ctypes (kernels/ops.py).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRow = 128;                 // elements per warp row (32 x 4)
constexpr int kMaxClusters = 8;
// staged slices: logits + fp32 running sums in shared memory (must match
// kernels/ops.py CDF_STAGE_BYTES)
constexpr size_t kStageLimit = 192 * 1024;

// Four consecutive slice elements [i, i + 4) as floats; those at or past
// n as -inf.
template <typename T, bool kStaged>
__device__ __forceinline__ void load4(const T* __restrict__ xs, int i, int n,
                                      float (&x)[4]) {
  if constexpr (kStaged && sizeof(T) == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(xs + i);
    x[0] = __uint_as_float(u.x << 16);
    x[1] = __uint_as_float(u.x & 0xffff0000u);
    x[2] = __uint_as_float(u.y << 16);
    x[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (kStaged) {
    const float4 u = *reinterpret_cast<const float4*>(xs + i);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[k] = i + k < n ? repro::to_float(xs[i + k]) : -INFINITY;
  }
  if constexpr (kStaged) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k >= n) x[k] = -INFINITY;
  }
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
cdf_points_kernel(const T* __restrict__ logits, long long row_stride, int V,
                  int slice, int budget, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[kWarps];
  __shared__ float wtot[kWarps], wmax[kWarps], wfloor[kWarps];
  __shared__ float wofs[kWarps];
  // read by the other CTAs of the cluster
  __shared__ float xch_max, xch_tot, xch_lmax;
  __shared__ float row_ofs, row_total;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = rank * slice;
  const int n = min(V, lo + slice) - lo;            // live, >= 1
  const T* gx = logits + row * row_stride + lo;
  int* o = out + (long long)row * V + lo;

  // 1. the slice into shared memory, once
  const T* xs = gx;
  float* vs = reinterpret_cast<float*>(o);          // running sums
  if constexpr (kStaged) {
    T* sx = reinterpret_cast<T*>(smem_raw);
    // (slice is a multiple of 128, so the sums start on 16 bytes)
    vs = reinterpret_cast<float*>(smem_raw + sizeof(T) * (size_t)slice);
    constexpr int kVec = 16 / sizeof(T);
    const bool aligned = (reinterpret_cast<uintptr_t>(gx) & 15u) == 0;
    const int nvec = aligned ? n / kVec : 0;
    for (int i = tid; i < nvec; i += kThreads)
      repro::cp_async16(sx + i * kVec, gx + i * kVec);
    for (int i = nvec * kVec + tid; i < n; i += kThreads) sx[i] = gx[i];
    repro::cp_async_wait_all();
    xs = sx;
  }
  __syncthreads();

  // 2. the row's max: the slice's, then the cluster's (exact)
  const int nrow = (n + kRow - 1) / kRow;
  float mx = -INFINITY;
  for (int r = warp; r < nrow; r += kWarps) {
    float x[4];
    load4<T, kStaged>(xs, r * kRow + lane * 4, n, x);
    mx = fmaxf(mx, fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
  }
  mx = repro::warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    const float m = repro::warp_max(lane < kWarps ? red[lane] : -INFINITY);
    if (lane == 0) xch_max = m;
  }
  repro::cluster_arrive();
  repro::cluster_wait();
  const float M = repro::warp_max(
      lane < C ? *cluster.map_shared_rank(&xch_max, lane) : -INFINITY);

  // 3. e = exp(x - M) and the warp-local inclusive prefix sums
  const int rpw = (nrow + kWarps - 1) / kWarps;     // rows per warp
  const int r0 = warp * rpw, r1 = min(nrow, r0 + rpw);
  float carry = 0.0f, lmax = -INFINITY;
#pragma unroll 2
  for (int r = r0; r < r1; ++r) {
    const int i = r * kRow + lane * 4;
    float x[4], a[4];
    load4<T, kStaged>(xs, i, n, x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float e = x[k] > -INFINITY ? expf(x[k] - M) : 0.0f;
      a[k] = k == 0 ? e : a[k - 1] + e;
    }
    float incl = a[3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = u + incl;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = carry + (excl + a[k]);
      if (i + k < n) lmax = fmaxf(lmax, v[k]);
    }
    if constexpr (kStaged) {
      *reinterpret_cast<float4*>(vs + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < n) vs[i + k] = v[k];
    }
    carry = carry + __shfl_sync(0xffffffffu, incl, 31);
  }
  lmax = repro::warp_max(lmax);
  if (lane == 0) {
    wtot[warp] = carry;
    wmax[warp] = lmax;
  }
  __syncthreads();
  // warps chained in warp order (a shuffle scan, lane w for warp w); the
  // slice's largest prefix (rounding is monotone, so it is the largest
  // warp maximum plus its offset)
  float my_ofs = 0.0f, my_max = -INFINITY;
  if (warp == 0) {
    my_max = lane < kWarps ? wmax[lane] : -INFINITY;
    float incl = lane < kWarps ? wtot[lane] : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = u + incl;
    }
    my_ofs = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) my_ofs = 0.0f;
    const float best = repro::warp_max(
        my_max > -INFINITY ? my_ofs + my_max : -INFINITY);
    const float tot = __shfl_sync(0xffffffffu, incl, 31);
    if (lane < kWarps) wofs[lane] = my_ofs;
    if (lane == 0) {
      xch_tot = tot;
      xch_lmax = best;
    }
  }

  // 4. the slices' totals chained in rank order (lane q for slice q); the
  // largest prefix of every earlier slice, and of the whole row
  repro::cluster_arrive();
  repro::cluster_wait();
  if (warp == 0) {
    float tq = 0.0f, lq = -INFINITY;
    if (lane < C) {
      tq = *cluster.map_shared_rank(&xch_tot, lane);
      lq = *cluster.map_shared_rank(&xch_lmax, lane);
    }
    float incl = tq;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = u + incl;
    }
    float ofs = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) ofs = 0.0f;
    const float big = lane < C ? ofs + lq : -INFINITY;
    const float total = repro::warp_max(big);
    const float before = repro::warp_max(lane < rank ? big : -INFINITY);
    const float base = __shfl_sync(0xffffffffu, ofs, rank);
    // the floor of each warp: every earlier slice and earlier warp
    float mi = my_max > -INFINITY ? base + (my_ofs + my_max) : -INFINITY;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, mi, d);
      if (lane >= d) mi = fmaxf(mi, u);
    }
    float ex = __shfl_up_sync(0xffffffffu, mi, 1);
    if (lane == 0) ex = -INFINITY;
    if (lane < kWarps) wfloor[lane] = fmaxf(before, ex);
    if (lane == 0) {
      row_ofs = base;
      row_total = total;
    }
  }
  // no more reads of another CTA's shared memory after this point
  repro::cluster_arrive();
  __syncthreads();

  // 5. floor, normalise, round, store
  const float base = row_ofs, total = row_total, wo = wofs[warp];
  const float fbudget = (float)budget;
  float floor_run = wfloor[warp];
  const bool vec_out = (V & 3) == 0;
#pragma unroll 2
  for (int r = r0; r < r1; ++r) {
    const int i = r * kRow + lane * 4;
    float v[4];
    if constexpr (kStaged) {
      const float4 u = *reinterpret_cast<const float4*>(vs + i);
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = i + k < n ? vs[i + k] : 0.0f;
    }
    float m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float u = base + (wo + v[k]);
      m[k] = k == 0 ? u : fmaxf(m[k - 1], u);
    }
    float lane_incl = m[3];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      lane_incl = fmaxf(lane_incl,
                        __shfl_up_sync(0xffffffffu, lane_incl, d));
    float lane_excl = __shfl_up_sync(0xffffffffu, lane_incl, 1);
    const float fl = lane == 0 ? floor_run : fmaxf(floor_run, lane_excl);
    int p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int g = lo + i + k;
      const float c = fmaxf(fl, m[k]) / total;
      p[k] = g == V - 1 ? budget + V
                        : (int)floorf(c * fbudget + 0.5f) + g + 1;
    }
    if (vec_out && i + 4 <= n) {
      *reinterpret_cast<int4*>(o + i) = make_int4(p[0], p[1], p[2], p[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < n) o[i + k] = p[k];
    }
    floor_run = fmaxf(floor_run, __shfl_sync(0xffffffffu, lane_incl, 31));
  }
  // every CTA has read the others' exchange values before any exits
  repro::cluster_wait();
}

template <typename T, bool kStaged>
cudaError_t launch(const void* logits, long long row_stride, int B, int V,
                   int clusters, int slice, int budget, int* out,
                   cudaStream_t st) {
  auto kern = cdf_points_kernel<T, kStaged>;
  const size_t smem = kStaged ? (sizeof(T) + 4) * (size_t)slice : 0;
  // the static arrays count against the 48 KB a block gets without
  // opting in, so opt in for any dynamic size larger than seen so far
  static size_t allowed = 0;
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
  cfg.numAttrs = clusters > 1 ? 1 : 0;   // a lone CTA needs no cluster
  cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(logits), row_stride,
                     V, slice, budget, out);
  return cudaGetLastError();            // also clears a refused launch's
}

}  // namespace

// logits (B, V) with row stride `row_stride` elements and unit column
// stride; out (B, V) int32, contiguous. `clusters` CTAs per row, each over
// `slice` logits (a multiple of 128; the slices cover V and none is
// empty): the geometry of kernels/ops.py `cdf_points_geometry`. A slice
// is staged in shared memory when its logits and running sums fit
// kStageLimit. Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_cdf_points(const void* logits, long long row_stride,
                                int dtype, int B, int V, int precision,
                                int clusters, int slice, void* out,
                                void* stream) {
  if (V < 1 || precision < 1 || precision > 24 || (1 << precision) <= V ||
      B < 1 || clusters < 1 || clusters > kMaxClusters || slice < 1 ||
      slice % kRow != 0 || (long long)clusters * slice < V ||
      (long long)(clusters - 1) * slice >= V ||
      (long long)clusters * B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype != repro::kFloat32 && dtype != repro::kBFloat16)
    return (int)cudaErrorInvalidValue;
  const size_t el = dtype == repro::kFloat32 ? 4 : 2;
  const bool staged = (el + 4) * (size_t)slice <= kStageLimit;
  const int budget = (1 << precision) - V;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (dtype == repro::kFloat32)
    return (int)(staged ? launch<float, true>(logits, row_stride, B, V,
                                              clusters, slice, budget, o, st)
                        : launch<float, false>(logits, row_stride, B, V,
                                               clusters, slice, budget, o,
                                               st));
  return (int)(staged ? launch<__nv_bfloat16, true>(logits, row_stride, B, V,
                                                    clusters, slice, budget,
                                                    o, st)
                      : launch<__nv_bfloat16, false>(logits, row_stride, B,
                                                     V, clusters, slice,
                                                     budget, o, st));
}
