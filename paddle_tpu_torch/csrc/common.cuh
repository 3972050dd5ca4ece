// Helpers shared by the row-normalisation kernels: dtype codes, fp32
// conversion, 16-byte vector access and a block-wide fp32 sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

// dtype codes passed through the C interface (mirrored in csrc/__init__.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch casts
}

// Elements of T in one 16-byte vector.
template <typename T>
struct VecWidth {
  static constexpr int value = 16 / sizeof(T);
};

// One 16-byte load of VecWidth<T> elements, widened to fp32. p is
// 16-byte aligned (the launcher checks).
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VecWidth<T>::value; ++j) f[j] = to_float(e[j]);
}

// One 16-byte store of VecWidth<T> elements narrowed from fp32.
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < VecWidth<T>::value; ++j) e[j] = from_float<T>(f[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Sum of v over the block: warp shuffles, then one shared-memory exchange
// of the per-warp sums. blockDim.x is a multiple of 32, at most 1024.
// Every thread gets the total. smem holds 32 floats; the leading barrier
// lets one kernel call this more than once with the same smem.
__device__ __forceinline__ float block_sum(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? smem[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Threads for a row of n work items: a multiple of 32 in [32, 512].
inline int threads_for(int64_t n) {
  int64_t t = (n + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > 512) t = 512;
  return static_cast<int>(t);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace ptt
