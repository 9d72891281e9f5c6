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

// 16-byte asynchronous copy from global into shared memory (`cp.async`;
// both addresses 16-byte aligned). Completes at `cp_async_wait_all`.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Elements [8c, 8c + 8) of a slice as floats. kStaged: `src` is the
// slice in shared memory, 16-byte aligned; else it is read element by
// element, and those at or past n read as -inf (callers mask by index).
template <typename T, bool kStaged>
__device__ __forceinline__ void read8(const T* __restrict__ src, int c,
                                      int n, float (&v)[8]) {
  if constexpr (kStaged && sizeof(T) == 2) {
    const uint4 u = reinterpret_cast<const uint4*>(src)[c];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else if constexpr (kStaged) {
    const float4 a = reinterpret_cast<const float4*>(src)[2 * c];
    const float4 b = reinterpret_cast<const float4*>(src)[2 * c + 1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = c * 8 + j;
      v[j] = i < n ? to_float(src[i]) : -INFINITY;
    }
  }
}

// Thread-block cluster barrier in two halves. Every thread of every CTA
// of the cluster arrives, then waits; `cluster_arrive` releases this
// thread's earlier memory operations (shared memory of any CTA of the
// cluster included) to the threads that pass the matching wait, which
// acquires them. A CTA must not exit while a peer may still read or
// write its shared memory: such kernels arrive after their last access
// to a peer and wait before they return.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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
