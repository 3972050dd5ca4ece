// LayerNorm forward over the last axis for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ln_kernel` (paddle_tpu/nn/functional/norm.py:42,
// driven by `_ln_pallas`). Computes, per row of x [rows, d]:
//   y = (x - mean) * rsqrt(var + eps) [* w] [+ b]
// with mean, var (the mean of squared deviations), scale and shift in fp32
// and y in x's dtype. w and b are optional.
//
// Bound: bytes. About 8 flops per element against 2-3 bytes moved, far
// below the card's flop/byte balance point, so the least time is
// (rows*d*(in+out itemsize) + param bytes) / 3.35 TB/s.
// Design: one CTA per row, any rows >= 1 and any d. 16-byte vector loads
// and stores when d and the pointers allow them, a scalar loop otherwise.
// Two reductions (sum, then sum of squared deviations: the same two-pass
// variance as the reference, with no cancellation), each by warp shuffles
// plus one shared-memory exchange. The later passes re-read the row,
// which the CTA just touched, from L1/L2; w and b are read once per CTA.

#include "common.cuh"

namespace {

template <typename T, bool kVec>
__global__ void __launch_bounds__(512)
    layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const T* __restrict__ b, T* __restrict__ y,
                          int64_t d, float eps) {
  __shared__ float smem[32];
  constexpr int V = ptt::VecWidth<T>::value;
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * d;
  T* yr = y + static_cast<int64_t>(blockIdx.x) * d;
  const int64_t start = kVec ? static_cast<int64_t>(threadIdx.x) * V
                             : static_cast<int64_t>(threadIdx.x);
  const int64_t step = kVec ? static_cast<int64_t>(blockDim.x) * V
                            : static_cast<int64_t>(blockDim.x);

  float s = 0.f;
  for (int64_t i = start; i < d; i += step) {
    if (kVec) {
      float f[V];
      ptt::load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < V; ++j) s += f[j];
    } else {
      s += ptt::to_float(xr[i]);
    }
  }
  const float mean = ptt::block_sum(s, smem) / static_cast<float>(d);

  float sq = 0.f;
  for (int64_t i = start; i < d; i += step) {
    if (kVec) {
      float f[V];
      ptt::load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = f[j] - mean;
        sq += c * c;
      }
    } else {
      const float c = ptt::to_float(xr[i]) - mean;
      sq += c * c;
    }
  }
  const float inv =
      rsqrtf(ptt::block_sum(sq, smem) / static_cast<float>(d) + eps);

  for (int64_t i = start; i < d; i += step) {
    if (kVec) {
      float f[V];
      ptt::load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = (f[j] - mean) * inv;
      if (w != nullptr) {
        float g[V];
        ptt::load_vec(w + i, g);
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] *= g[j];
      }
      if (b != nullptr) {
        float h[V];
        ptt::load_vec(b + i, h);
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] += h[j];
      }
      ptt::store_vec(yr + i, f);
    } else {
      float v = (ptt::to_float(xr[i]) - mean) * inv;
      if (w != nullptr) v *= ptt::to_float(w[i]);
      if (b != nullptr) v += ptt::to_float(b[i]);
      yr[i] = ptt::from_float<T>(v);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* y,
            int64_t rows, int64_t d, float eps, cudaStream_t stream) {
  constexpr int V = ptt::VecWidth<T>::value;
  const bool vec = d % V == 0 && ptt::aligned16(x) && ptt::aligned16(y) &&
                   (w == nullptr || ptt::aligned16(w)) &&
                   (b == nullptr || ptt::aligned16(b));
  const int threads = ptt::threads_for(vec ? d / V : d);
  const dim3 grid(static_cast<unsigned>(rows));
  if (vec) {
    layer_norm_fwd_kernel<T, true><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(y), d, eps);
  } else {
    layer_norm_fwd_kernel<T, false><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(y), d, eps);
  }
}

}  // namespace

// x, y: [rows, d] contiguous; w, b: [d] or null; all of one dtype
// (ptt::DType). Launches on `stream` and returns cudaGetLastError().
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w,
                                  const void* b, void* y, int64_t rows,
                                  int64_t d, float eps, int dtype,
                                  void* stream) {
  if (rows < 1 || rows > 2147483647LL || d < 1 || x == nullptr ||
      y == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      launch<float>(x, w, b, y, rows, d, eps, s);
      break;
    case ptt::kBFloat16:
      launch<__nv_bfloat16>(x, w, b, y, rows, d, eps, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
