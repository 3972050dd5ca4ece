// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rms_norm_kernel`
// (paddle_tpu/incubate/nn/functional/fused_ops.py:29, driven by
// `_rms_norm_pallas`). Computes, per row of x [rows, d]:
//   y = x * rsqrt(mean(x^2) + eps) * w
// with the statistics and the weight product in fp32 and y in x's dtype.
//
// Bound: bytes. A row does about 4 flops per element against 2-3 bytes
// moved, far below the card's flop/byte balance point, so the least time
// is (rows*d*(in+out itemsize) + d*itemsize) / 3.35 TB/s.
// Design: one CTA per row, any rows >= 1 and any d. 16-byte vector
// loads and stores when d and the pointers allow them, a scalar loop
// otherwise (the ragged edge the TPU version gated out). The sum of
// squares is reduced by warp shuffles plus one shared-memory exchange.
// The second pass re-reads the row, which a CTA just touched, so it is
// served from L1/L2 rather than device memory; w is read once per CTA.

#include "common.cuh"

namespace {

template <typename T, bool kVec>
__global__ void __launch_bounds__(512)
    rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ y, int64_t d, float eps) {
  __shared__ float smem[32];
  constexpr int V = ptt::VecWidth<T>::value;
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * d;
  T* yr = y + static_cast<int64_t>(blockIdx.x) * d;

  float ss = 0.f;
  if (kVec) {
    for (int64_t i = static_cast<int64_t>(threadIdx.x) * V; i < d;
         i += static_cast<int64_t>(blockDim.x) * V) {
      float f[V];
      ptt::load_vec(xr + i, f);
#pragma unroll
      for (int j = 0; j < V; ++j) ss += f[j] * f[j];
    }
  } else {
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
      const float f = ptt::to_float(xr[i]);
      ss += f * f;
    }
  }
  const float inv =
      rsqrtf(ptt::block_sum(ss, smem) / static_cast<float>(d) + eps);

  if (kVec) {
    for (int64_t i = static_cast<int64_t>(threadIdx.x) * V; i < d;
         i += static_cast<int64_t>(blockDim.x) * V) {
      float f[V], g[V];
      ptt::load_vec(xr + i, f);
      ptt::load_vec(w + i, g);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = f[j] * inv * g[j];
      ptt::store_vec(yr + i, f);
    }
  } else {
    for (int64_t i = threadIdx.x; i < d; i += blockDim.x) {
      yr[i] = ptt::from_float<T>(ptt::to_float(xr[i]) * inv *
                                 ptt::to_float(w[i]));
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int64_t rows, int64_t d,
            float eps, cudaStream_t stream) {
  constexpr int V = ptt::VecWidth<T>::value;
  const bool vec = d % V == 0 && ptt::aligned16(x) && ptt::aligned16(w) &&
                   ptt::aligned16(y);
  const int threads = ptt::threads_for(vec ? d / V : d);
  const dim3 grid(static_cast<unsigned>(rows));
  if (vec) {
    rms_norm_fwd_kernel<T, true><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(y), d, eps);
  } else {
    rms_norm_fwd_kernel<T, false><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(y), d, eps);
  }
}

}  // namespace

// x, y: [rows, d] contiguous; w: [d]; all of one dtype (ptt::DType).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ptt_rms_norm_fwd(const void* x, const void* w, void* y,
                                int64_t rows, int64_t d, float eps,
                                int dtype, void* stream) {
  if (rows < 1 || rows > 2147483647LL || d < 1 || x == nullptr ||
      w == nullptr || y == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      launch<float>(x, w, y, rows, d, eps, s);
      break;
    case ptt::kBFloat16:
      launch<__nv_bfloat16>(x, w, y, rows, d, eps, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
