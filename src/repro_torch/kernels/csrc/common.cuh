// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every reduction here runs in a fixed order (xor butterflies inside a
// warp, then warp results combined by warp index), so a row's result is
// a function of that row alone: no float atomics, nothing that depends
// on scheduling or on the other rows of a launch. That is the lossless
// coder's requirement: compress and decompress must build bit-identical
// CDFs in different runs, with chunks on different lanes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with kernels/ops.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Order-preserving unsigned key of a float: a > b (as floats) iff
// key(a) > key(b). -0.0 is folded onto +0.0 so the two tie, as they do
// under IEEE comparison (and in the plain version's stable sort).
__device__ __forceinline__ uint32_t float_key(float x) {
  uint32_t u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (max, sum of exp(x - max)) pairs: the streaming softmax state.
struct MaxSum {
  float m;
  float s;
};

__device__ __forceinline__ MaxSum maxsum_merge(MaxSum a, MaxSum b) {
  if (a.m == -INFINITY) return b;
  if (b.m == -INFINITY) return a;
  float m = fmaxf(a.m, b.m);
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

__device__ __forceinline__ MaxSum maxsum_push(MaxSum a, float x) {
  if (!(x > -INFINITY)) return a;          // -inf (or NaN) adds nothing
  if (x > a.m) return {x, a.s * expf(a.m - x) + 1.0f};
  return {a.m, a.s + expf(x - a.m)};
}

// Block-wide (max, sum-exp) reduction; every thread gets the result.
// `scratch` holds 2 * 32 floats of shared memory.
__device__ __forceinline__ MaxSum block_maxsum(MaxSum v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    MaxSum w = {__shfl_xor_sync(0xffffffffu, v.m, o),
                __shfl_xor_sync(0xffffffffu, v.s, o)};
    v = maxsum_merge(v, w);
  }
  if (lane == 0) {
    scratch[warp] = v.m;
    scratch[32 + warp] = v.s;
  }
  __syncthreads();
  if (warp == 0) {
    MaxSum w = lane < nwarps ? MaxSum{scratch[lane], scratch[32 + lane]}
                             : MaxSum{-INFINITY, 0.0f};
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      MaxSum u = {__shfl_xor_sync(0xffffffffu, w.m, o),
                  __shfl_xor_sync(0xffffffffu, w.s, o)};
      w = maxsum_merge(w, u);
    }
    if (lane == 0) {
      scratch[0] = w.m;
      scratch[32] = w.s;
    }
  }
  __syncthreads();
  MaxSum out = {scratch[0], scratch[32]};
  __syncthreads();
  return out;
}

// Block-wide exclusive prefix sum of one int per thread (exact).
// `scratch` holds 33 ints; `total` receives the block sum.
__device__ __forceinline__ int block_exclusive_scan_int(int v, int* scratch,
                                                        int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? scratch[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int u = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += u;
    }
    scratch[lane] = wi - w;                // exclusive offset of warp `lane`
    if (lane == 31) scratch[32] = wi;
  }
  __syncthreads();
  int out = scratch[warp] + incl - v;
  *total = scratch[32];
  __syncthreads();
  return out;
}

}  // namespace repro

// Message of a cudaError_t returned by an entry point (each kernel
// source is its own library, so each carries one copy).
extern "C" const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
