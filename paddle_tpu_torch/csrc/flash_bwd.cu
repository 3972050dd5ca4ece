// Native-layout flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_nl_fused` (paddle_tpu/incubate/nn/
// functional/flash_attention.py:873, driven by `_nl_backward`), the
// one-pass dq/dk/dv. Layout as the forward (flash_fwd.cu): q, k, v read in
// place by base pointer and row stride; dout [B,Sq,H*D] contiguous; lse
// and delta = rowsum(dO * O) (computed outside the kernel, as the TPU
// path does) [B,H,Sq] fp32; dq / dk / dv written at one row stride, so a
// packed [B,S,3E] gradient is filled in place at its three column offsets.
//
// What is computed, per (kv tile, q tile) and head: p = exp(logits - lse)
// recomputed once (masked entries 0), dv += p^T dO, dp = dO v^T,
// ds = p (dp - delta) cast to the input dtype, dk += ds^T q * scale,
// dq += ds k * scale; every product accumulates in fp32.
//
// Bound: operations. Five products to the forward's two: about 172
// GFLOP at B=4, S=2048, H=16, D=128 causal, so the least time is
// FLOPs / 989 TFLOP/s.
//
// Design: Hopper's CTAs run in parallel, so the TPU's whole-sequence dq
// scratch carried across a sequential grid does not translate. The kernel
// keeps the one-pass shape: one CTA of 4 warps per (kv tile of 64 rows,
// head, batch), each warp owning 16 kv rows, holds dk/dv in registers
// over a loop of q tiles of 32 and adds each tile's dq into an fp32
// [B,Sq,H*D] scratch with atomics (p is computed once, five products per
// tile, against seven for a split dk/dv + dq pair of kernels). S^T, P^T,
// dP^T and dS^T stay in registers as accumulators re-packed into A
// operands; dS^T also goes to shared memory for the dq product. The q,
// dO, lse and delta tiles are double-buffered with cp.async; bf16
// fragments load with `ldmatrix` (`.trans` where the product reads a tile
// column-wise). A second small kernel casts dq into place. The atomics
// make dq's fp32 summation order vary from run to run; dk/dv are
// deterministic.

#include "flash_common.cuh"

namespace {

using namespace ptt_flash;

constexpr int kTileKV = 64;  // kv rows per CTA (16 per warp)
constexpr int kTileQ = 32;   // q rows per step

// Row stride of the dS^T tile [kv][q]: kTileQ plus 16 bytes.
template <typename T>
struct LdS {
  static constexpr int value = kTileQ + 16 / static_cast<int>(sizeof(T));
};

template <typename T, int D>
constexpr size_t bwd_smem_bytes() {
  return static_cast<size_t>(2 * kTileKV + 4 * kTileQ) * Ld<T, D>::value *
             sizeof(T) +
         static_cast<size_t>(kTileKV) * LdS<T>::value * sizeof(T) +
         4 * kTileQ * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, int64_t q_stride,
                     int64_t kv_stride, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq_acc, T* __restrict__ dk,
                     T* __restrict__ dv, int64_t dkv_stride, int sq, int sk,
                     int heads, float scale, int causal) {
  using P = typename Pair<T>::type;
  constexpr int LD = Ld<T, D>::value;
  constexpr int LDS = LdS<T>::value;
  constexpr int NQT = kTileQ / 8;  // n-tiles of S^T
  constexpr int NDT = D / 8;       // n-tiles of dk, dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kTileKV * LD;
  T* sQ = sV + kTileKV * LD;       // [2][kTileQ][LD]
  T* sdO = sQ + 2 * kTileQ * LD;   // [2][kTileQ][LD]
  T* sdS = sdO + 2 * kTileQ * LD;  // dS^T [kv][q]
  float* sLse = reinterpret_cast<float*>(sdS + kTileKV * LDS);  // [2][kTileQ]
  float* sDelta = sLse + 2 * kTileQ;                            // [2][kTileQ]

  const int nkv = (sk + kTileKV - 1) / kTileKV;
  const int k0 = (nkv - 1 - static_cast<int>(blockIdx.x)) * kTileKV;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int off = sk - sq;
  const int r0 = warp * 16;  // this warp's kv rows within the tile
  const int e_all = heads * D;

  const int64_t hcol = static_cast<int64_t>(h) * D;
  const T* qb = q + static_cast<int64_t>(b) * sq * q_stride + hcol;
  const T* dob = dout + static_cast<int64_t>(b) * sq * e_all + hcol;
  const float* lseb = lse + (static_cast<int64_t>(b) * heads + h) * sq;
  const float* deltab = delta + (static_cast<int64_t>(b) * heads + h) * sq;

  // the q tiles: from the first one any of this CTA's keys is visible to
  int q_begin = 0;
  if (causal) {
    const int first = k0 - off;
    q_begin = first > 0 ? first / kTileQ * kTileQ : 0;
  }
  auto load_q_tile = [&](int q0, int buf) {
    load_tile_async<T, D, kTileQ>(sQ + buf * kTileQ * LD, qb, q_stride, q0,
                                  sq);
    load_tile_async<T, D, kTileQ>(sdO + buf * kTileQ * LD, dob, e_all, q0,
                                  sq);
    if (threadIdx.x < 2 * kTileQ) {
      const int i = threadIdx.x & (kTileQ - 1);
      const bool live = q0 + i < sq;
      const float* src = threadIdx.x < kTileQ ? lseb : deltab;
      float* dst = (threadIdx.x < kTileQ ? sLse : sDelta) + buf * kTileQ + i;
      cp_async4(dst, src + (live ? q0 + i : 0), live);
    }
    cp_async_commit();
  };

  load_tile_async<T, D, kTileKV>(
      sK, k + static_cast<int64_t>(b) * sk * kv_stride + hcol, kv_stride, k0,
      sk);
  load_tile_async<T, D, kTileKV>(
      sV, v + static_cast<int64_t>(b) * sk * kv_stride + hcol, kv_stride, k0,
      sk);
  if (q_begin < sq) {
    load_q_tile(q_begin, 0);  // one group with K and V
  } else {
    cp_async_commit();
  }

  float dk_acc[NDT][4];
  float dv_acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  int it = 0;
  for (int q0 = q_begin; q0 < sq; q0 += kTileQ, ++it) {
    const int buf = it & 1;
    const T* cQ = sQ + buf * kTileQ * LD;
    const T* cdO = sdO + buf * kTileQ * LD;
    const float* cLse = sLse + buf * kTileQ;
    const float* cDelta = sDelta + buf * kTileQ;
    cp_async_wait_all();  // this q tile (and, first, K and V) has landed
    __syncthreads();      // ... for every thread; the last dQ step is done
    if (q0 + kTileQ < sq) load_q_tile(q0 + kTileQ, buf ^ 1);

    // S^T = K Q^T, then P^T = exp(S^T * scale - lse) (masked: 0)
    float st[NQT][4];
#pragma unroll
    for (int j = 0; j < NQT; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      P af[4];
      frag_a<T>(af, sK, LD, r0, ks * 16);
#pragma unroll
      for (int j = 0; j < NQT; j += 2) {
        P b0[2], b1[2];
        frag_bt2<T>(b0, b1, cQ, LD, ks * 16, j * 8);
        mma(st[j], af, b0);
        mma(st[j + 1], af, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NQT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = k0 + r0 + g + (e >= 2 ? 8 : 0);
        const int qc = j * 8 + 2 * t + (e & 1);
        const int qrow = q0 + qc;
        const bool ok = kv < sk && qrow < sq && (!causal || kv <= qrow + off);
        st[j][e] = ok ? expf(st[j][e] * scale - cLse[qc]) : 0.f;
      }
    }
    // dV += P^T dO
#pragma unroll
    for (int ks = 0; ks < kTileQ / 16; ++ks) {
      P af[4];
      c_to_a<T>(af, st[2 * ks], st[2 * ks + 1]);
#pragma unroll
      for (int n = 0; n < NDT; n += 2) {
        P b0[2], b1[2];
        frag_b2<T>(b0, b1, cdO, LD, ks * 16, n * 8);
        mma(dv_acc[n], af, b0);
        mma(dv_acc[n + 1], af, b1);
      }
    }
    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta)
    float dpt[NQT][4];
#pragma unroll
    for (int j = 0; j < NQT; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      P af[4];
      frag_a<T>(af, sV, LD, r0, ks * 16);
#pragma unroll
      for (int j = 0; j < NQT; j += 2) {
        P b0[2], b1[2];
        frag_bt2<T>(b0, b1, cdO, LD, ks * 16, j * 8);
        mma(dpt[j], af, b0);
        mma(dpt[j + 1], af, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NQT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpt[j][e] = st[j][e] * (dpt[j][e] - cDelta[j * 8 + 2 * t + (e & 1)]);
      }
    }
    // dK += dS^T Q (scaled at the end); dS^T to shared memory for dQ
#pragma unroll
    for (int ks = 0; ks < kTileQ / 16; ++ks) {
      P af[4];
      c_to_a<T>(af, dpt[2 * ks], dpt[2 * ks + 1]);
#pragma unroll
      for (int n = 0; n < NDT; n += 2) {
        P b0[2], b1[2];
        frag_b2<T>(b0, b1, cQ, LD, ks * 16, n * 8);
        mma(dk_acc[n], af, b0);
        mma(dk_acc[n + 1], af, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NQT; ++j) {
      st_pair<T>(sdS + (r0 + g) * LDS + j * 8 + 2 * t, dpt[j][0], dpt[j][1]);
      st_pair<T>(sdS + (r0 + g + 8) * LDS + j * 8 + 2 * t, dpt[j][2],
                 dpt[j][3]);
    }
    __syncthreads();

    // dQ[32 x D] += dS[32 x 64] K[64 x D]: warp w takes q rows
    // 16 (w % 2) and the half of D at (w / 2) * D / 2
    {
      const int qr = (warp & 1) * 16;
      const int c0 = (warp >> 1) * (D / 2);
      float acc[D / 16][4];
#pragma unroll
      for (int n = 0; n < D / 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kTileKV / 16; ++ks) {
        P af[4];
        frag_a_t<T>(af, sdS, LDS, qr, ks * 16);  // A[q][kv] = dS^T[kv][q]
#pragma unroll
        for (int n = 0; n < D / 16; n += 2) {
          P b0[2], b1[2];
          frag_b2<T>(b0, b1, sK, LD, ks * 16, c0 + n * 8);
          mma(acc[n], af, b0);
          mma(acc[n + 1], af, b1);
        }
      }
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int qrow = q0 + qr + g + 8 * rh;
        if (qrow >= sq) continue;
        float* dst = dq_acc + (static_cast<int64_t>(b) * sq + qrow) * e_all +
                     hcol + c0 + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          atomicAdd(reinterpret_cast<float2*>(dst + n * 8),
                    make_float2(acc[n][2 * rh] * scale,
                                acc[n][2 * rh + 1] * scale));
        }
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the CTA

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int kv = k0 + r0 + g + 8 * rh;
    if (kv >= sk) continue;
    const int64_t base = (static_cast<int64_t>(b) * sk + kv) * dkv_stride +
                         hcol + 2 * t;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      st_pair<T>(dk + base + n * 8, dk_acc[n][2 * rh] * scale,
                 dk_acc[n][2 * rh + 1] * scale);
      st_pair<T>(dv + base + n * 8, dv_acc[n][2 * rh], dv_acc[n][2 * rh + 1]);
    }
  }
}

// dq [rows, cols] (row stride `stride`) = dq_acc [rows, cols] cast to T.
template <typename T>
__global__ void cast_rows_kernel(const float* __restrict__ src,
                                 T* __restrict__ dst, int64_t rows,
                                 int64_t cols, int64_t stride) {
  const int64_t n = rows * cols;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / cols;
    dst[r * stride + (i - r * cols)] = ptt::from_float<T>(src[i]);
  }
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, int64_t q_stride,
        int64_t kv_stride, const void* dout, const void* lse,
        const void* delta, void* dq_acc, void* dq, void* dk, void* dv,
        int64_t dgrad_stride, int batch, int sq, int sk, int heads,
        int causal, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<T, D>();
  auto* kernel = flash_bwd_kernel<T, D>;
  static bool smem_set = false;
  int rc = set_smem(kernel, smem, &smem_set);
  if (rc != 0) return rc;
  const dim3 grid((sk + kTileKV - 1) / kTileKV, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_stride, kv_stride,
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc),
      static_cast<T*>(dk), static_cast<T*>(dv), dgrad_stride, sq, sk, heads,
      1.f / sqrtf(static_cast<float>(D)), causal);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int64_t rows = static_cast<int64_t>(batch) * sq;
  const int64_t cols = static_cast<int64_t>(heads) * D;
  int64_t blocks = (rows * cols + 255) / 256;
  if (blocks > 65535) blocks = 65535;
  cast_rows_kernel<T><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<T*>(dq), rows, cols,
      dgrad_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, strides as ptt_flash_fwd; dout: [batch, sq, heads * head_dim]
// contiguous; lse, delta: [batch, heads, sq] fp32; dq_acc: fp32 [batch,
// sq, heads * head_dim], zero on entry; dq / dk, dv: [batch, sq / sk,
// heads * head_dim] rows of stride dgrad_stride (they may be column views
// of one packed gradient). Launches the one-pass kernel and the dq cast;
// returns cudaGetLastError().
extern "C" int ptt_flash_bwd(const void* q, const void* k, const void* v,
                             int64_t q_stride, int64_t kv_stride,
                             const void* dout, const void* lse,
                             const void* delta, void* dq_acc, void* dq,
                             void* dk, void* dv, int64_t dgrad_stride,
                             int batch, int sq, int sk, int heads,
                             int head_dim, int causal, int dtype,
                             void* stream) {
  if (!ptt_flash::args_ok(batch, sq, sk, heads, head_dim) || q == nullptr ||
      k == nullptr || v == nullptr || dout == nullptr || lse == nullptr ||
      delta == nullptr || dq_acc == nullptr || dq == nullptr ||
      dk == nullptr || dv == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_BWD(T, D)                                                     \
  bwd<T, D>(q, k, v, q_stride, kv_stride, dout, lse, delta, dq_acc, dq, dk, \
            dv, dgrad_stride, batch, sq, sk, heads, causal, s)
  PTT_FLASH_DISPATCH(dtype, head_dim, PTT_BWD)
#undef PTT_BWD
}
