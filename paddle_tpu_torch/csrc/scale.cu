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
// Design: x splits into a scalar head (the elements before x's first
// 16-byte boundary), 16-byte vectors (4 fp32 or 8 bf16 values) and a
// scalar tail (the last (n - head) % V). The wrapper allocates y at x's
// offset modulo 16 bytes, so one head lines up both. Each CTA takes
// chunks of kVecsInFlight * kThreads vectors; a thread issues all of its
// kVecsInFlight streaming loads (`__ldcs`: each byte is touched once)
// before its first multiply, then stores with `__stcs`. Vector u of a
// chunk is base + u * kThreads + threadIdx.x, so a warp's loads and
// stores are contiguous. The grid is sized to the work (one chunk a CTA)
// and loops over chunks only past the largest grid. On an H100 the
// work-sized grid, not the loads in flight, took the kernel from 1.07x
// torch.mul to parity: 1, 2, 4 and 8 vectors in flight time within 1%
// of each other, 2 closest to torch.mul at the FFN's [8192, 8192] bf16
// (tools/norm_scale_ab.py).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecsInFlight = 2;  // 16-byte loads a thread issues at once
constexpr int64_t kMaxCtas = 2147483647LL;

template <typename T>
__device__ __forceinline__ uint4 scaled(uint4 raw, float f) {
  constexpr int V = ptt::VecWidth<T>::value;
  float v[V];
  ptt::load_vec(reinterpret_cast<const T*>(&raw), v);
  uint4 out;
  T* e = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int j = 0; j < V; ++j) e[j] = ptt::from_float<T>(v[j] * f);
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scale_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
                 int64_t head, float factor) {
  constexpr int V = ptt::VecWidth<T>::value;
  constexpr int64_t kChunk = static_cast<int64_t>(kVecsInFlight) * kThreads;
  const float f = ptt::to_float(ptt::from_float<T>(factor));
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // head: x[0, head), fewer than V elements
  if (tid < head) y[tid] = ptt::from_float<T>(ptt::to_float(x[tid]) * f);
  const int64_t nvec = (n - head) / V;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk;
       base < nvec; base += static_cast<int64_t>(gridDim.x) * kChunk) {
    const bool full = base + kChunk <= nvec;
    uint4 raw[kVecsInFlight];
#pragma unroll
    for (int u = 0; u < kVecsInFlight; ++u) {
      const int64_t i = base + u * kThreads + threadIdx.x;
      raw[u] = full || i < nvec ? __ldcs(xv + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kVecsInFlight; ++u) raw[u] = scaled<T>(raw[u], f);
#pragma unroll
    for (int u = 0; u < kVecsInFlight; ++u) {
      const int64_t i = base + u * kThreads + threadIdx.x;
      if (full || i < nvec) __stcs(yv + i, raw[u]);
    }
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
  // one chunk a CTA; at least one CTA, whose first threads take the head
  // and the tail
  const int64_t chunk = static_cast<int64_t>(kVecsInFlight) * kThreads;
  int64_t blocks = ((n - head) / V + chunk - 1) / chunk;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxCtas) blocks = kMaxCtas;
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
