// Full-vocabulary quantized CDF, one row per CTA.
//
// Replaces the TPU kernel src/repro/kernels/ac_cdf.py (`cdf_points` /
// `_cdf_kernel`): logits (B, V) -> int32 (B, V) CDF interior points by
// cumulative rounding, pts[i] = floor(P(x <= i) * (T - V) + 0.5) + i + 1
// with T = 2**precision, so that every symbol keeps at least one quantum,
// the points increase strictly and pts[V-1] == T exactly.
//
// Bound on the H100: bytes. The function reads V logits and writes V
// int32 points per row (6 B per symbol in bf16); one exp per logit is
// far below the flop rate, so the least time is those bytes over
// 3.35 TB/s.
//
// Design. A first pass carries the streaming softmax state (max, sum of
// exp) and reduces it over the block in a fixed order. The prefix sum is
// then two-level: each thread owns one contiguous segment of the row and
// sums it sequentially; a fixed-order block scan gives each segment its
// offset; each thread walks its segment again to emit. A parallel float
// scan is not monotone across segment edges (the offset and the previous
// segment's running sum round differently), so the running prefix is
// passed through an exclusive max-scan -- max is exact, so the result is
// monotone and still deterministic -- and normalised by its final value
// (x / x == 1 exactly), which keeps the points strictly increasing and
// the tail exact. The last point is also forced to T, as the Pallas
// kernel does. The ragged vocab tail needs no block multiple. This first
// version reads each thread's segment with strided (uncoalesced) loads;
// staging tiles through shared memory is left for a later change.
//
// Plain C interface, bound from Python with ctypes (kernels/ops.py).
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

struct SumOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Block-wide exclusive scan of one float per thread in thread order, with
// a fixed combination order. `scratch` holds 33 floats.
template <typename Op>
__device__ float block_exclusive_scan(float v, float identity, float* scratch,
                                      float* total, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = op(u, incl);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = identity;
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const float w = lane < nwarps ? scratch[lane] : identity;
    float wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi = op(u, wi);
    }
    float we = __shfl_up_sync(0xffffffffu, wi, 1);
    if (lane == 0) we = identity;
    scratch[lane] = we;
    if (lane == 31) scratch[32] = wi;
  }
  __syncthreads();
  const float out = lane == 0 ? scratch[warp] : op(scratch[warp], excl);
  *total = scratch[32];
  __syncthreads();
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cdf_points_kernel(const T* __restrict__ logits, long long row_stride, int V,
                  int budget, int* __restrict__ out) {
  __shared__ float red[64];
  __shared__ float scan[33];
  const int tid = threadIdx.x;
  const T* x = logits + blockIdx.x * row_stride;
  int* o = out + (long long)blockIdx.x * V;

  repro::MaxSum ms = {-INFINITY, 0.0f};
  for (int i = tid; i < V; i += kThreads)
    ms = repro::maxsum_push(ms, repro::to_float(x[i]));
  ms = repro::block_maxsum(ms, red);
  const float m = ms.m, s = ms.s;

  const int per = (V + kThreads - 1) / kThreads;
  const int lo = min(tid * per, V), hi = min(lo + per, V);
  float local = 0.0f;
  for (int i = lo; i < hi; ++i) local += expf(repro::to_float(x[i]) - m) / s;
  float unused;
  const float off = block_exclusive_scan(local, 0.0f, scan, &unused, SumOp());
  // this segment's largest prefix (its last one: sums of non-negative
  // terms in sequence never decrease); empty segments take no part
  float seg_last = -INFINITY;
  if (hi > lo) {
    float run = off;
    for (int i = lo; i < hi; ++i) run += expf(repro::to_float(x[i]) - m) / s;
    seg_last = run;
  }
  float total;
  const float prev_max =
      block_exclusive_scan(seg_last, -INFINITY, scan, &total, MaxOp());
  const float fbudget = (float)budget;
  float run = off;
  for (int i = lo; i < hi; ++i) {
    run += expf(repro::to_float(x[i]) - m) / s;
    const float c = fmaxf(run, prev_max) / total;
    int pt = (int)floorf(c * fbudget + 0.5f) + i + 1;
    if (i == V - 1) pt = budget + V;
    o[i] = pt;
  }
}

}  // namespace

// logits (B, V) with row stride `row_stride` elements and unit column
// stride; out (B, V) int32, contiguous. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int repro_cdf_points(const void* logits, long long row_stride,
                                int dtype, int B, int V, int precision,
                                void* out, void* stream) {
  if (V < 1 || precision < 1 || precision > 24 || (1 << precision) <= V)
    return (int)cudaErrorInvalidValue;
  const int budget = (1 << precision) - V;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (dtype == repro::kFloat32)
    cdf_points_kernel<float><<<B, kThreads, 0, st>>>(
        static_cast<const float*>(logits), row_stride, V, budget, o);
  else if (dtype == repro::kBFloat16)
    cdf_points_kernel<__nv_bfloat16><<<B, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), row_stride, V, budget, o);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
