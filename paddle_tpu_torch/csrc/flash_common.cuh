// Helpers shared by the flash attention kernels: operand strides,
// asynchronous tile copies, the backward's delta kernel and the C entry
// points' argument checks (every source); and for the fp32 kernels
// (flash_fwd.cu, flash_bwd.cu, flash_bwd_hm.cu) warp-level m16n8k16
// products and their fragment loads from shared memory.
//
// Fragment layout of c[16x8] += a[16x16] b[16x8] (g = lane / 4,
// t = lane % 4): a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..], a[2] =
// A[g][2t+8..], a[3] = A[g+8][2t+8..]; b[0] = B[2t..2t+1][g], b[1] =
// B[2t+8..2t+9][g]; c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..],
// the layout of `mma.sync`. fp32 loads pairs with plain shared-memory
// reads and emulates the product in exact fp32 FMAs over warp shuffles
// (slow; it serves fp32 checks). bf16 runs on `wgmma` instead
// (flash_bwd_sm90.cuh).
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace ptt_flash {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// Element strides of one attention operand over (batch, head, row); the
// last dim is contiguous. Native [B,S,H*D] rows of stride R: (S*R, D, R);
// head-major [G,S,D], G in the batch place and one head: (group, 0, row).
struct Strides {
  int64_t b, h, r;
  // offset of head h of batch element b
  __device__ __forceinline__ int64_t at(int bi, int hi) const {
    return static_cast<int64_t>(bi) * b + static_cast<int64_t>(hi) * h;
  }
};

// Two adjacent elements of an mma fragment: an fp32 pair.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};

template <typename T>
__device__ __forceinline__ typename Pair<T>::type pack2(float lo, float hi);
template <>
__device__ __forceinline__ float2 pack2<float>(float lo, float hi) {
  return make_float2(lo, hi);
}

// p[0], p[1] (p aligned to the pair).
template <typename T>
__device__ __forceinline__ typename Pair<T>::type ld_pair(const T* p) {
  return *reinterpret_cast<const typename Pair<T>::type*>(p);
}
// p[0], p[stride].
template <typename T>
__device__ __forceinline__ typename Pair<T>::type ld_pair_strided(
    const T* p, int stride) {
  return pack2<T>(ptt::to_float(p[0]), ptt::to_float(p[stride]));
}
template <typename T>
__device__ __forceinline__ void st_pair(T* p, float lo, float hi) {
  *reinterpret_cast<typename Pair<T>::type*>(p) = pack2<T>(lo, hi);
}

// The same product in fp32, one exact FMA per term in order of k; each
// term's operands come from the owning lanes by shuffle.
__device__ __forceinline__ void mma(float c[4], const float2 a[4],
                                    const float2 b[2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int src = (kk & 7) >> 1;  // t of the owning lane
    const int ar = kk >= 8 ? 2 : 0;
    const int br = kk >= 8 ? 1 : 0;
    const bool hi = kk & 1;
    const float alo = __shfl_sync(0xffffffffu, hi ? a[ar].y : a[ar].x,
                                  g * 4 + src);
    const float ahi = __shfl_sync(0xffffffffu,
                                  hi ? a[ar + 1].y : a[ar + 1].x, g * 4 + src);
    const float b0 = __shfl_sync(0xffffffffu, hi ? b[br].y : b[br].x,
                                 (2 * t) * 4 + src);
    const float b1 = __shfl_sync(0xffffffffu, hi ? b[br].y : b[br].x,
                                 (2 * t + 1) * 4 + src);
    c[0] = fmaf(alo, b0, c[0]);
    c[1] = fmaf(alo, b1, c[1]);
    c[2] = fmaf(ahi, b0, c[2]);
    c[3] = fmaf(ahi, b1, c[3]);
  }
}

// A fragment: rows [r, r + 16) x cols [c, c + 16) of a row-major tile.
template <typename T>
__device__ __forceinline__ void frag_a(typename Pair<T>::type a[4],
                                       const T* tile, int ld, int r, int c) {
  const int lane = threadIdx.x & 31;
  const T* p = tile + (r + (lane >> 2)) * ld + c + 2 * (lane & 3);
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// A fragment of the transpose: A[m][k] = tile[c + k][r + m].
template <typename T>
__device__ __forceinline__ void frag_a_t(typename Pair<T>::type a[4],
                                         const T* tile, int ld, int r,
                                         int c) {
  const int lane = threadIdx.x & 31;
  const T* p = tile + (c + 2 * (lane & 3)) * ld + r + (lane >> 2);
  a[0] = ld_pair_strided(p, ld);
  a[1] = ld_pair_strided(p + 8, ld);
  a[2] = ld_pair_strided(p + 8 * ld, ld);
  a[3] = ld_pair_strided(p + 8 * ld + 8, ld);
}

// B fragments of two n-tiles (n0, n0 + 8) with B[k][n] = tile[n0 + n]
// [k0 + k]: the transposed read of a row-major tile (K in Q K^T).
template <typename T>
__device__ __forceinline__ void frag_bt2(typename Pair<T>::type b0[2],
                                         typename Pair<T>::type b1[2],
                                         const T* tile, int ld, int k0,
                                         int n0) {
  const int lane = threadIdx.x & 31;
  const T* p = tile + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b0[0] = ld_pair(p);
  b0[1] = ld_pair(p + 8);
  b1[0] = ld_pair(p + 8 * ld);
  b1[1] = ld_pair(p + 8 * ld + 8);
}

// B fragments of two n-tiles (n0, n0 + 8) with B[k][n] = tile[k0 + k]
// [n0 + n]: the direct read of a row-major tile (V in P V).
template <typename T>
__device__ __forceinline__ void frag_b2(typename Pair<T>::type b0[2],
                                        typename Pair<T>::type b1[2],
                                        const T* tile, int ld, int k0,
                                        int n0) {
  const int lane = threadIdx.x & 31;
  const T* p = tile + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b0[0] = ld_pair_strided(p, ld);
  b0[1] = ld_pair_strided(p + 8 * ld, ld);
  b1[0] = ld_pair_strided(p + 8, ld);
  b1[1] = ld_pair_strided(p + 8 * ld + 8, ld);
}

// The A fragment (16 x 16) of columns [16 ks, 16 ks + 16) of a 16-row
// accumulator held as n-tiles c0, c1 (16 x 8 each): cast to T in
// registers.
template <typename T>
__device__ __forceinline__ void c_to_a(typename Pair<T>::type a[4],
                                       const float c0[4], const float c1[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// Shared-memory row stride: D plus 16 bytes, which keeps rows 16-byte
// aligned (for ldmatrix and 16-byte copies) and puts the 8 rows of an
// 8x8 matrix on distinct banks.
template <typename T, int D>
struct Ld {
  static constexpr int value = D + 16 / static_cast<int>(sizeof(T));
};

// 16 bytes from global to shared memory without passing through
// registers; `pred` false writes zeros (and reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Start copying rows [r0, r0 + ROWS) of a [n, D] operand with row stride
// `stride` into shared memory (row stride Ld); rows at or past n become
// zeros.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                int64_t stride, int r0,
                                                int n) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = D / V;
  constexpr int LD = Ld<T, D>::value;
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * V;
    const bool live = r0 + r < n;
    cp_async16(dst + r * LD + c,
               src + (live ? static_cast<int64_t>(r0 + r) * stride + c : 0),
               live);
  }
}

// delta[b][h][s] = sum_d dO[b][s][h D + d] O[b][s][h D + d] in fp32, in
// order of d: one thread per (b, s, h), rows = B * Sq * H. With heads = 1
// this is the head-major [G,Sq,D] -> [G,Sq] rowsum (G in place of B).
template <typename T, int D>
__global__ void delta_kernel(const T* __restrict__ out,
                             const T* __restrict__ dout,
                             float* __restrict__ delta, int sq, int heads,
                             int64_t rows) {
  constexpr int V = ptt::VecWidth<T>::value;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= rows) return;
  const T* o = out + i * D;  // row (b, s), columns of head h
  const T* g = dout + i * D;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += V) {
    float fo[V], fg[V];
    ptt::load_vec<T>(o + c, fo);
    ptt::load_vec<T>(g + c, fg);
#pragma unroll
    for (int j = 0; j < V; ++j) acc = fmaf(fg[j], fo[j], acc);
  }
  const int h = static_cast<int>(i % heads);
  const int64_t bs = i / heads;
  const int64_t b = bs / sq;
  delta[(b * heads + h) * sq + (bs - b * sq)] = acc;
}

// Allow `bytes` of dynamic shared memory for `kernel`, once per kernel
// (outside any CUDA-graph capture: the first call is an eager one).
template <typename Kern>
int set_smem(Kern kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  const int rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
  *done = rc == 0;
  return rc;
}

inline bool args_ok(int batch, int sq, int sk, int heads, int kv_heads,
                    int head_dim) {
  return batch >= 1 && batch <= 65535 && sq >= 1 && sk >= 1 && heads >= 1 &&
         heads <= 65535 && kv_heads >= 1 && heads % kv_heads == 0 &&
         (head_dim == 32 || head_dim == 64 || head_dim == 128);
}

}  // namespace ptt_flash
