// Elementwise scale for Hopper (sm_90a): y = x * factor.
//
// Replaces the TPU kernel `scale_kernel` (tests/test_custom_op.py:101,
// driven by `scale_impl` :104 through pl.pallas_call :105), the kernel of
// the custom-op API's example op. The Pallas kernel multiplies a block
// of x by a Python float, which JAX rounds to x's dtype first (a weakly
// typed scalar); the product of two bf16 values is exact in fp32, so the
// result is rounded once. This kernel does the same: factor rounded to
// x's dtype, the product in fp32, one rounding to x's dtype. It is bit
// for bit the Pallas kernel's result in fp32 and bf16.
//
// Bound: bytes. One multiply per element against 2 * itemsize bytes
// moved, so the least time is 2 * n * itemsize / 3.35 TB/s.
// Design: a grid-stride loop of 16-byte vector loads and stores (4 fp32
// or 8 bf16 values per thread per iteration), with a scalar head for the
// elements before x's first 16-byte boundary and a scalar tail for the
// last (n - head) % V. The wrapper allocates y at x's offset modulo 16
// bytes, so one head lines up both. The grid fills every SM once (eight
// 256-thread CTAs each) and no more.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scale_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                 int64_t head, float factor) {
  constexpr int V = ptt::VecWidth<T>::value;
  const float f = ptt::to_float(ptt::from_float<T>(factor));
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // head: x[0, head), fewer than V elements
  if (tid < head) y[tid] = ptt::from_float<T>(ptt::to_float(x[tid]) * f);
  const int64_t nvec = (n - head) / V;
  const T* xv = x + head;
  T* yv = y + head;
  for (int64_t i = tid; i < nvec; i += stride) {
    float v[V];
    ptt::load_vec(xv + i * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] *= f;
    ptt::store_vec(yv + i * V, v);
  }
  // tail: x[t0, n), fewer than V elements
  const int64_t t0 = head + nvec * V;
  if (tid < n - t0) {
    y[t0 + tid] = ptt::from_float<T>(ptt::to_float(x[t0 + tid]) * f);
  }
}

template <typename T>
int launch(const void* x, void* y, int64_t n, float factor,
           cudaStream_t stream) {
  constexpr int V = ptt::VecWidth<T>::value;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(x) & 15u;
  if ((reinterpret_cast<uintptr_t>(y) & 15u) != mis || mis % sizeof(T)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  int64_t head = mis ? static_cast<int64_t>((16u - mis) / sizeof(T)) : 0;
  if (head > n) head = n;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t work = (n - head) / V > 0 ? (n - head) / V : 1;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 1) * 8;
  if (blocks > cap) blocks = cap;
  scale_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, head, factor);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: n contiguous elements of one dtype (ptt::DType), n >= 1, y at
// x's address modulo 16 bytes. Launches on `stream` and returns a CUDA
// error code (0 on success).
extern "C" int ptt_scale(const void* x, void* y, int64_t n, float factor,
                         int dtype, void* stream) {
  if (n < 1 || x == nullptr || y == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return launch<float>(x, y, n, factor, s);
    case ptt::kBFloat16:
      return launch<__nv_bfloat16>(x, y, n, factor, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
