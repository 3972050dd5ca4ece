// LayerNorm backward over the last axis for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ln_bwd_kernel` (paddle_tpu/nn/functional/
// norm.py:106, driven by `_ln_bwd_pallas`). Given x [rows, d], the
// weight w [d] (or none: w = 1) and the output gradient g [rows, d]:
//   x^ = (x - mean) * rsqrt(var + eps)            (stats recomputed, fp32)
//   a  = g * w
//   dx = rsqrt(var + eps) * (a - mean(a) - x^ * mean(a * x^))
//   dw = sum over rows of g * x^,   db = sum over rows of g
// with every sum in fp32, dx in x's dtype and dw/db in w's dtype.
//
// Bound: bytes. x and g are read and dx written once (about 20 flops per
// element against 6 bytes in bf16), so the least time is
// (3 * rows * d * itemsize + param bytes) / 3.35 TB/s.
// Design: the TPU kernel carries dw/db in one fp32 scratch across its
// sequential grid; Hopper's CTAs run in parallel, so the reduction across
// rows takes two passes and no float atomics, which keeps dw/db
// deterministic. Pass 1: CTA c of n_parts owns the balanced, contiguous
// run of rows [c * rows / n_parts, (c + 1) * rows / n_parts), and a
// thread owns the same columns in every row, so it accumulates its g * x^
// and g in row order without a race. When a row fits one 16-byte vector
// per thread (`ln_bwd_rows_pipe_kernel`: d <= 4096 in bf16, 2048 in
// fp32), the wrapper launches a few CTAs an SM, each keeping kStages - 1
// rows of x and g in flight through a cp.async ring while it reduces the
// row before them (two block reductions a row, one barrier each), with w
// and the partials in registers; one CTA's reductions overlap another's
// copies. Otherwise (`ln_bwd_rows_kernel`) the
// partials live in shared memory, dx takes three block reductions a row
// and later passes re-read the row from L1/L2. The CTA writes its
// partials to [n_parts, 2, d]. Pass 2 (`ln_bwd_reduce_kernel`) sums each
// column's partials in a fixed order: thread y of a column sums parts y,
// y + 16, ... in order, then the 16 sums are added in order of y.
// testing/ln_bwd_tiled.py mirrors this partition and order on the CPU.

#include "common.cuh"

namespace {

constexpr int64_t kMaxD = 28672;  // 2 * kMaxD fp32 partials per CTA
constexpr int kMaxSmem = static_cast<int>(2 * kMaxD * sizeof(float));

// Block-wide sums of two values at once (see ptt::block_sum). smem holds
// 64 floats.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    smem[warp] = a;
    smem[32 + warp] = b;
  }
  __syncthreads();
  const bool live = lane < static_cast<int>(blockDim.x >> 5);
  a = live ? smem[lane] : 0.f;
  b = live ? smem[32 + lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  return make_float2(a, b);
}

// Up to V consecutive elements of a row as fp32: one 16-byte vector when
// kVec, else one scalar.
template <typename T, bool kVec>
__device__ __forceinline__ void load_n(const T* p, float* f) {
  if (kVec) {
    ptt::load_vec(p, f);
  } else {
    f[0] = ptt::to_float(*p);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(512)
    ln_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ g, T* __restrict__ dx,
                       float* __restrict__ part, int64_t rows, int64_t d,
                       int64_t n_parts, float eps) {
  extern __shared__ float acc[];  // [2 * d]: sum g*x^, then sum g
  __shared__ float smem[64];
  constexpr int V = kVec ? ptt::VecWidth<T>::value : 1;
  const int64_t start = static_cast<int64_t>(threadIdx.x) * V;
  const int64_t step = static_cast<int64_t>(blockDim.x) * V;
  for (int64_t i = threadIdx.x; i < 2 * d; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  // part c of n_parts balanced, contiguous runs of rows
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows / n_parts;
  const int64_t r1 =
      (static_cast<int64_t>(blockIdx.x) + 1) * rows / n_parts;
  const float inv_d = 1.f / static_cast<float>(d);
  for (int64_t r = r0; r < r1; ++r) {
    const T* xr = x + r * d;
    const T* gr = g + r * d;
    T* dxr = dx + r * d;

    float s = 0.f;
    for (int64_t i = start; i < d; i += step) {
      float f[V];
      load_n<T, kVec>(xr + i, f);
#pragma unroll
      for (int j = 0; j < V; ++j) s += f[j];
    }
    const float mean = ptt::block_sum(s, smem) * inv_d;

    float sq = 0.f;
    for (int64_t i = start; i < d; i += step) {
      float f[V];
      load_n<T, kVec>(xr + i, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = f[j] - mean;
        sq += c * c;
      }
    }
    const float inv = rsqrtf(ptt::block_sum(sq, smem) * inv_d + eps);

    float s1 = 0.f, s2 = 0.f;
    for (int64_t i = start; i < d; i += step) {
      float xf[V], gf[V], wf[V];
      load_n<T, kVec>(xr + i, xf);
      load_n<T, kVec>(gr + i, gf);
      if (w != nullptr) {
        load_n<T, kVec>(w + i, wf);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) wf[j] = 1.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xf[j] - mean) * inv;
        const float a = gf[j] * wf[j];
        s1 += a;
        s2 += a * xh;
        acc[i + j] += gf[j] * xh;
        acc[d + i + j] += gf[j];
      }
    }
    const float2 m = block_sum2(s1, s2, smem);
    const float m1 = m.x * inv_d;
    const float m2 = m.y * inv_d;

    for (int64_t i = start; i < d; i += step) {
      float xf[V], gf[V], wf[V];
      load_n<T, kVec>(xr + i, xf);
      load_n<T, kVec>(gr + i, gf);
      if (w != nullptr) {
        load_n<T, kVec>(w + i, wf);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) wf[j] = 1.f;
      }
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xf[j] - mean) * inv;
        o[j] = inv * (gf[j] * wf[j] - m1 - xh * m2);
      }
      if (kVec) {
        ptt::store_vec(dxr + i, o);
      } else {
        dxr[i] = ptt::from_float<T>(o[0]);
      }
    }
  }
  __syncthreads();
  float* out = part + static_cast<int64_t>(blockIdx.x) * 2 * d;
  for (int64_t i = threadIdx.x; i < 2 * d; i += blockDim.x) out[i] = acc[i];
}

// cp.async of 16 bytes from device to shared memory (L2 only: each byte
// is read once), its commit and its wait for all but N of this thread's
// groups.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kStages = 4;       // rows of x and g a CTA has in flight
constexpr int kVecsPerThread = 2;  // 16-byte vectors of a row per thread
constexpr int kMaxWarps = 16;      // 512 threads
constexpr int kMaxPipeVecs = 512;  // vectors of a row the ring kernel takes
// bytes of the ring at the largest row
constexpr int kMaxRing = kStages * 2 * kMaxPipeVecs * 16;

// The pass for rows of at most kMaxPipeVecs 16-byte vectors (d <= 4096
// in bf16, 2048 in fp32). Thread t of nt owns vectors t, t + nt, ... (VPT
// of them) of every row of the CTA's run, so w, dw and db stay in its
// registers. x and g rows come through a ring of kStages stages in
// shared memory filled by cp.async, kStages - 1 rows ahead of the row
// being reduced; a thread copies and later reads only its own 16-byte
// pieces of each stage, so the ring needs no barrier. A row takes two
// block reductions, one barrier each: the sum of x, then the sums of
// (x - mean)^2, a = g * w and a * (x - mean) together (sum a * x^ =
// inv * sum a * (x - mean)).
template <typename T, int VPT>
__global__ void __launch_bounds__(512)
    ln_bwd_rows_pipe_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ g, T* __restrict__ dx,
                            float* __restrict__ part, int64_t rows,
                            int64_t d, int64_t n_parts, float eps) {
  extern __shared__ uint4 ring[];  // [kStages][x, g][VPT][blockDim.x]
  __shared__ float red1[kMaxWarps];
  __shared__ float4 red2[kMaxWarps];
  constexpr int V = ptt::VecWidth<T>::value;
  constexpr int E = V * VPT;  // elements of a row per thread
  const int nt = static_cast<int>(blockDim.x);
  const int nw = nt >> 5;
  const int t = static_cast<int>(threadIdx.x);
  const int lane = t & 31;
  const int warp = t >> 5;
  int64_t col[VPT];
  bool live[VPT];
  float wf[E], adw[E], adb[E];
#pragma unroll
  for (int e = 0; e < E; ++e) wf[e] = adw[e] = adb[e] = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    col[k] = (static_cast<int64_t>(k) * nt + t) * V;
    live[k] = col[k] < d;
    if (live[k]) {
      if (w != nullptr) {
        ptt::load_vec(w + col[k], wf + k * V);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) wf[k * V + e] = 1.f;
      }
    }
  }
  // this CTA's run of rows: part c of n_parts balanced, contiguous parts
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows / n_parts;
  const int64_t end =
      (static_cast<int64_t>(blockIdx.x) + 1) * rows / n_parts;
  // row r (one commit group; an empty one past the run) into its stage
  auto fetch = [&](int64_t r) {
    if (r < end) {
      uint4* st = ring + ((r - first) % kStages) * 2 * VPT * nt;
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        if (live[k]) {
          cp_async16(st + k * nt + t, x + r * d + col[k]);
          cp_async16(st + (VPT + k) * nt + t, g + r * d + col[k]);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(first + s);
  const float inv_d = 1.f / static_cast<float>(d);
  for (int64_t r = first; r < end; ++r) {
    cp_async_wait<kStages - 2>();  // row r's copies have landed
    float xf[E], gf[E];
#pragma unroll
    for (int e = 0; e < E; ++e) xf[e] = gf[e] = 0.f;
    float s = 0.f;
    const uint4* st = ring + ((r - first) % kStages) * 2 * VPT * nt;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (live[k]) {
        ptt::load_vec(reinterpret_cast<const T*>(st + k * nt + t),
                      xf + k * V);
        ptt::load_vec(reinterpret_cast<const T*>(st + (VPT + k) * nt + t),
                      gf + k * V);
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) s += xf[e];
    // row r + kStages - 1 into the stage of row r - 1, whose values this
    // thread has used
    fetch(r + kStages - 1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red1[warp] = s;
    __syncthreads();
    s = 0.f;
    for (int i = 0; i < nw; ++i) s += red1[i];
    const float mean = s * inv_d;
    float af[E];
    float sq = 0.f, sa = 0.f, sax = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      xf[e] = live[e / V] ? xf[e] - mean : 0.f;
      af[e] = gf[e] * wf[e];
      sq += xf[e] * xf[e];
      sa += af[e];
      sax += af[e] * xf[e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sq += __shfl_xor_sync(0xffffffffu, sq, o);
      sa += __shfl_xor_sync(0xffffffffu, sa, o);
      sax += __shfl_xor_sync(0xffffffffu, sax, o);
    }
    if (lane == 0) red2[warp] = make_float4(sq, sa, sax, 0.f);
    __syncthreads();
    sq = sa = sax = 0.f;
    for (int i = 0; i < nw; ++i) {
      const float4 v = red2[i];
      sq += v.x;
      sa += v.y;
      sax += v.z;
    }
    const float inv = rsqrtf(sq * inv_d + eps);
    const float m1 = sa * inv_d;
    const float m2 = sax * inv * inv_d;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      if (!live[k]) continue;
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int e = k * V + j;
        const float xh = xf[e] * inv;  // x^
        o[j] = inv * (af[e] - m1 - xh * m2);
        adw[e] += gf[e] * xh;
        adb[e] += gf[e];
      }
      ptt::store_vec(dx + r * d + col[k], o);
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA
  float* out = part + static_cast<int64_t>(blockIdx.x) * 2 * d;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (!live[k]) continue;
#pragma unroll
    for (int e = k * V; e < (k + 1) * V; e += 4) {
      const int64_t c = col[k] + e - k * V;
      *reinterpret_cast<float4*>(out + c) =
          make_float4(adw[e], adw[e + 1], adw[e + 2], adw[e + 3]);
      *reinterpret_cast<float4*>(out + d + c) =
          make_float4(adb[e], adb[e + 1], adb[e + 2], adb[e + 3]);
    }
  }
}

constexpr int kRedCols = 32;   // columns per reduce CTA
constexpr int kRedSplit = 16;  // threads splitting a column's partials

// dw[i] / db[i] = sum over the n_parts partials: thread (c, y) of a CTA
// sums parts y, y + kRedSplit, ... of column c in order, then the
// kRedSplit sums are added in order, so the result does not depend on
// scheduling.
template <typename T>
__global__ void __launch_bounds__(kRedCols * kRedSplit)
    ln_bwd_reduce_kernel(const float* __restrict__ part, int64_t n_parts,
                         int64_t d, T* __restrict__ dw, T* __restrict__ db) {
  __shared__ float sums[kRedSplit][kRedCols];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRedCols + threadIdx.x;
  float s = 0.f;
  if (i < 2 * d) {
#pragma unroll 8
    for (int64_t p = threadIdx.y; p < n_parts; p += kRedSplit) {
      s += part[p * 2 * d + i];
    }
  }
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || i >= 2 * d) return;
  s = 0.f;
#pragma unroll
  for (int y = 0; y < kRedSplit; ++y) s += sums[y][threadIdx.x];
  if (i < d) {
    dw[i] = ptt::from_float<T>(s);
  } else {
    db[i - d] = ptt::from_float<T>(s);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* g, void* dx,
           void* part, void* dw, void* db, int64_t rows, int64_t d,
           int64_t n_parts, float eps, cudaStream_t stream) {
  constexpr int V = ptt::VecWidth<T>::value;
  const bool vec = d % V == 0 && ptt::aligned16(x) && ptt::aligned16(g) &&
                   ptt::aligned16(dx) && (w == nullptr || ptt::aligned16(w));
  const int threads = ptt::threads_for(vec ? d / V : d);
  const size_t smem = static_cast<size_t>(2 * d) * sizeof(float);

  const dim3 grid(static_cast<unsigned>(n_parts));
  // allow the largest d once per kernel (outside any CUDA-graph capture:
  // the first call is an eager one)
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_rows_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(ln_bwd_rows_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(ln_bwd_rows_pipe_kernel<T, kVecsPerThread>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxRing);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const int64_t nvec = vec ? d / V : 0;
  if (vec && nvec <= kMaxPipeVecs) {
    const int nt = ptt::threads_for(
        (nvec + kVecsPerThread - 1) / kVecsPerThread);
    const size_t ring = static_cast<size_t>(kStages) * 2 * kVecsPerThread *
                        nt * sizeof(uint4);
    ln_bwd_rows_pipe_kernel<T, kVecsPerThread><<<grid, nt, ring, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(g), static_cast<T*>(dx),
        static_cast<float*>(part), rows, d, n_parts, eps);
  } else if (vec) {
    auto* k = ln_bwd_rows_kernel<T, true>;
    k<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(g), static_cast<T*>(dx),
        static_cast<float*>(part), rows, d, n_parts, eps);
  } else {
    auto* k = ln_bwd_rows_kernel<T, false>;
    k<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(g), static_cast<T*>(dx),
        static_cast<float*>(part), rows, d, n_parts, eps);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 rgrid(static_cast<unsigned>((2 * d + kRedCols - 1) / kRedCols));
  ln_bwd_reduce_kernel<T><<<rgrid, dim3(kRedCols, kRedSplit), 0, stream>>>(
      static_cast<const float*>(part), n_parts, d, static_cast<T*>(dw),
      static_cast<T*>(db));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, g, dx: [rows, d] contiguous; w: [d] or null; dw, db: [d]; all of
// one dtype (ptt::DType). part: fp32 scratch [n_parts, 2, d], n_parts in
// [1, rows]. d * 8 bytes of partials must fit one CTA's shared memory
// (d <= 28672). Launches both passes on `stream` and returns
// cudaGetLastError().
extern "C" int ptt_layer_norm_bwd(const void* x, const void* w,
                                  const void* g, void* dx, void* part,
                                  void* dw, void* db, int64_t rows,
                                  int64_t d, int64_t n_parts, float eps,
                                  int dtype, void* stream) {
  if (rows < 1 || d < 1 || d > kMaxD || n_parts < 1 || n_parts > rows ||
      n_parts > 2147483647LL || x == nullptr || g == nullptr ||
      dx == nullptr || part == nullptr || dw == nullptr || db == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return launch<float>(x, w, g, dx, part, dw, db, rows, d, n_parts, eps,
                           s);
    case ptt::kBFloat16:
      return launch<__nv_bfloat16>(x, w, g, dx, part, dw, db, rows, d,
                                   n_parts, eps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
