// Flash attention backward for Hopper (sm_90a): native layout (K5) and
// the head-major two-kernel backward (K8), the same kernels addressed
// through per-operand (batch, head, row) strides, as the forward's K4 and
// K6 (flash_fwd.cu).
//
// K5 (entry `ptt_flash_bwd`) replaces the TPU kernel `_bwd_nl_fused`
// (paddle_tpu/incubate/nn/functional/flash_attention.py:873, driven by
// `_nl_backward`), the one-pass dq/dk/dv, and the fold of its expanded
// grouped-query dk/dv in `_flash_nl_bwd` (:1115). Layout as K4: q, k, v
// read in place by base pointer and row stride, k and v holding KVH heads
// (KVH divides H; q head h reads kv head h / (H / KVH)); out and dout
// [B,Sq,H*D] contiguous; lse [B,H,Sq] fp32 from the forward; dq written
// at its row stride, dk and dv at theirs (a packed [B,S,3E] gradient is
// filled in place at its three column offsets).
//
// K8's fp32 calls (entry `ptt_flash_bwd_hm_split_fp32`; its bf16 calls
// run the warpgroup kernels of flash_bwd_sm90.cu, `wgmma` having no fp32
// product): K8 replaces `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (:349, :393, driven by `_flash_backward_pallas`
// :567), which the JAX package's head-major backward takes once the
// one-pass K7's whole-sequence fp32 dq scratch (Sq * D * 4 bytes) passes
// `_DQ_SCRATCH_BYTES` (4 MiB: S > 8192 at D = 128). Layout as K6: q
// [G,Sq,D] and k, v [G,Sk,D] (G = B*H heads, one each) at their group
// and row strides; out, dout [G,Sq,D] contiguous; lse [G,Sq] fp32; dq
// [G,Sq,D], dk, dv [G,Sk,D] written contiguous. The TPU's two kernels are
// this file's dq and dk/dv kernels below: its dq kernel carries a
// (bq, D) fp32 accumulator across a sequential kv axis and its dk/dv
// kernel two (bk, D) ones across a sequential q axis, which here are the
// loops inside one CTA; nothing crosses CTAs, so K8 needs no scratch but
// delta, and no atomics.
//
// What is computed, per (kv tile, q tile) and q head: p = exp(logits -
// lse) (masked entries 0), dv += p^T dO, dp = dO v^T, ds = p (dp - delta)
// cast to the input dtype, dk += ds^T q * scale, dq += ds k * scale, where
// delta = rowsum(dO * O); every product accumulates in fp32. A kv head's
// dk and dv sum the terms of all H / KVH q heads that share it.
//
// Bound: operations. Five products to the forward's two: about 172
// GFLOP at B=4, S=2048, H=16, D=128 causal (2.75 TFLOP at B=1, S=16384),
// so the least time is FLOPs / 989 TFLOP/s.
//
// Design. Hopper's CTAs run in parallel, so the TPU's whole-sequence dq
// scratch carried across a sequential grid does not translate, and a sum
// across CTAs in atomics makes dq's fp32 summation order (and so its
// bits) change from run to run. dq is therefore computed apart, in K8's
// manner (`_bwd_dq_kernel`), and every output has one writer that sums
// its terms in a fixed order: the same inputs give the same bytes.
// Fixed-order per-kv-tile dq partials reduced by a second kernel (as K3
// does for dw/db) were the other choice; at B=8, S=2048, H=32, D=64 they
// need (S / 64) fp32 copies of dq, 32 x 128 MiB = 4 GiB (half of it under
// the causal mask), against no scratch at all here, at the price of
// recomputing p and dp (two more products: seven in all, not five).
//   1. delta_kernel (flash_common.cuh): delta [B,H,Sq] fp32, one
//      thread per (row, head) ([G,Sq] head-major: heads = 1).
//   2. flash_dkdv_kernel: one CTA of 4 warps per (kv tile of 64 rows, kv
//      head, batch), each warp owning 16 kv rows, holds dk/dv in registers
//      over a loop of the group's q heads and each head's q tiles of 32,
//      and writes them once at the kv width: nothing is expanded or
//      folded. S^T, P^T, dP^T and dS^T stay in registers as accumulators
//      re-packed into A operands. The q, dO, lse and delta tiles are
//      double-buffered with cp.async; bf16 fragments load with `ldmatrix`
//      (`.trans` where the product reads a tile column-wise). CTAs with
//      the most causal work (the first kv tiles) are issued first. In K8
//      a group is one head (rep = 1), so a CTA owns (kv tile, head).
//   3. flash_dq_kernel: one CTA of 4 warps per (q tile of 64 rows, q head,
//      batch), Q and dO in shared memory, K and V tiles of 64 streamed
//      through a double buffer; S, P, dP and dS stay in registers, dS
//      re-packed as the A operand of dS K, as the forward's P V. At
//      G = 16, S = 16384 K8's dq grid has 4096 CTAs (K7 would run 16).

#include "flash_common.cuh"

namespace {

using namespace ptt_flash;

constexpr int kTileKV = 64;    // dk/dv kernel: kv rows per CTA (16 a warp)
constexpr int kTileQ = 32;     // dk/dv kernel: q rows per step
constexpr int kTileQdq = 64;   // dq kernel: q rows per CTA (16 a warp)
constexpr int kTileKVdq = 64;  // dq kernel: kv rows per step

// The operands' strides: q, k and v (shared), dout, dq, dk and dv
// (shared).
struct BwdLayout {
  Strides q, kv, dout, dq, dkv;
};

template <typename T, int D>
constexpr size_t dkdv_smem_bytes() {
  return static_cast<size_t>(2 * kTileKV + 4 * kTileQ) * Ld<T, D>::value *
             sizeof(T) +
         4 * kTileQ * sizeof(float);
}

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  return static_cast<size_t>(2 * kTileQdq + 4 * kTileKVdq) *
         Ld<T, D>::value * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, BwdLayout L,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, int heads, int rep,
                      float scale, int causal) {
  using P = typename Pair<T>::type;
  constexpr int LD = Ld<T, D>::value;
  constexpr int NQT = kTileQ / 8;  // n-tiles of S^T
  constexpr int NDT = D / 8;       // n-tiles of dk, dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kTileKV * LD;
  T* sQ = sV + kTileKV * LD;       // [2][kTileQ][LD]
  T* sdO = sQ + 2 * kTileQ * LD;   // [2][kTileQ][LD]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kTileQ * LD);  // [2][kTileQ]
  float* sDelta = sLse + 2 * kTileQ;                              // [2][kTileQ]

  const int k0 = static_cast<int>(blockIdx.x) * kTileKV;
  const int kh = blockIdx.y;  // this CTA's kv head
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int off = sk - sq;
  const int r0 = warp * 16;  // this warp's kv rows within the tile
  const T* kb = k + L.kv.at(b, kh);
  const T* vb = v + L.kv.at(b, kh);

  // the q tiles: from the first one any of this CTA's keys is visible to;
  // the loop runs over (q head of the group, q tile), head by head
  int q_begin = 0;
  if (causal) {
    const int first = k0 - off;
    q_begin = first > 0 ? first / kTileQ * kTileQ : 0;
  }
  const int nq = q_begin < sq ? (sq - q_begin + kTileQ - 1) / kTileQ : 0;
  const int n_it = rep * nq;
  auto load_q_tile = [&](int i, int buf) {
    const int h = kh * rep + i / nq;
    const int q0 = q_begin + (i % nq) * kTileQ;
    load_tile_async<T, D, kTileQ>(sQ + buf * kTileQ * LD, q + L.q.at(b, h),
                                  L.q.r, q0, sq);
    load_tile_async<T, D, kTileQ>(sdO + buf * kTileQ * LD,
                                  dout + L.dout.at(b, h), L.dout.r, q0, sq);
    if (threadIdx.x < 2 * kTileQ) {
      const int j = threadIdx.x & (kTileQ - 1);
      const bool live = q0 + j < sq;
      const int64_t row0 = (static_cast<int64_t>(b) * heads + h) * sq;
      const float* src = (threadIdx.x < kTileQ ? lse : delta) + row0;
      float* dst = (threadIdx.x < kTileQ ? sLse : sDelta) + buf * kTileQ + j;
      cp_async4(dst, src + (live ? q0 + j : 0), live);
    }
    cp_async_commit();
  };

  load_tile_async<T, D, kTileKV>(sK, kb, L.kv.r, k0, sk);
  load_tile_async<T, D, kTileKV>(sV, vb, L.kv.r, k0, sk);
  if (n_it > 0) {
    load_q_tile(0, 0);  // one group with K and V
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

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    const int q0 = q_begin + (it % nq) * kTileQ;
    const T* cQ = sQ + buf * kTileQ * LD;
    const T* cdO = sdO + buf * kTileQ * LD;
    const float* cLse = sLse + buf * kTileQ;
    const float* cDelta = sDelta + buf * kTileQ;
    cp_async_wait_all();  // this q tile (and, first, K and V) has landed
    __syncthreads();      // ... for every thread; the other buffer is free
    if (it + 1 < n_it) load_q_tile(it + 1, buf ^ 1);

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
    // dK += dS^T Q (scaled at the end)
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
  }
  cp_async_wait_all();  // no copy outlives the CTA

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int kv = k0 + r0 + g + 8 * rh;
    if (kv >= sk) continue;
    const int64_t base = L.dkv.at(b, kh) + kv * L.dkv.r + 2 * t;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      st_pair<T>(dk + base + n * 8, dk_acc[n][2 * rh] * scale,
                 dk_acc[n][2 * rh + 1] * scale);
      st_pair<T>(dv + base + n * 8, dv_acc[n][2 * rh], dv_acc[n][2 * rh + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, BwdLayout L,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int heads, int rep, float scale,
                    int causal) {
  using P = typename Pair<T>::type;
  constexpr int LD = Ld<T, D>::value;
  constexpr int NKT = kTileKVdq / 8;  // n-tiles of S and dP
  constexpr int NDT = D / 8;          // n-tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + kTileQdq * LD;
  T* sK = sdO + kTileQdq * LD;       // [2][kTileKVdq][LD]
  T* sV = sK + 2 * kTileKVdq * LD;   // [2][kTileKVdq][LD]

  const int nq = (sq + kTileQdq - 1) / kTileQdq;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTileQdq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int off = sk - sq;
  const int r0 = warp * 16;

  const int64_t kvoff = L.kv.at(b, h / rep);  // shared kv head
  const T* kb = k + kvoff;
  const T* vb = v + kvoff;

  int kv_end = sk;
  if (causal) {
    const int last_q = (q0 + kTileQdq < sq ? q0 + kTileQdq : sq) - 1;
    kv_end = last_q + off + 1 < sk ? last_q + off + 1 : sk;
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kTileKVdq - 1) / kTileKVdq : 0;

  load_tile_async<T, D, kTileQdq>(sQ, q + L.q.at(b, h), L.q.r, q0, sq);
  load_tile_async<T, D, kTileQdq>(sdO, dout + L.dout.at(b, h), L.dout.r, q0,
                                  sq);
  if (n_tiles > 0) {
    load_tile_async<T, D, kTileKVdq>(sK, kb, L.kv.r, 0, sk);
    load_tile_async<T, D, kTileKVdq>(sV, vb, L.kv.r, 0, sk);
  }
  cp_async_commit();

  // the statistics of this thread's two rows
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = q0 + r0 + g + 8 * rh;
    const int64_t i = (static_cast<int64_t>(b) * heads + h) * sq + row;
    row_lse[rh] = row < sq ? lse[i] : 0.f;
    row_delta[rh] = row < sq ? delta[i] : 0.f;
  }
  float acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTileKVdq;
    const T* cK = sK + (it & 1) * kTileKVdq * LD;
    const T* cV = sV + (it & 1) * kTileKVdq * LD;
    cp_async_wait_all();  // tile it (and, first, Q and dO) has landed
    __syncthreads();      // ... for every thread; tile it-1 is read out
    if (it + 1 < n_tiles) {
      T* nK = sK + ((it + 1) & 1) * kTileKVdq * LD;
      T* nV = sV + ((it + 1) & 1) * kTileKVdq * LD;
      load_tile_async<T, D, kTileKVdq>(nK, kb, L.kv.r, k0 + kTileKVdq, sk);
      load_tile_async<T, D, kTileKVdq>(nV, vb, L.kv.r, k0 + kTileKVdq, sk);
      cp_async_commit();
    }

    // S = Q K^T and dP = dO V^T
    float s[NKT][4], dp[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      P qa[4], da[4];
      frag_a<T>(qa, sQ, LD, r0, ks * 16);
      frag_a<T>(da, sdO, LD, r0, ks * 16);
#pragma unroll
      for (int j = 0; j < NKT; j += 2) {
        P b0[2], b1[2];
        frag_bt2<T>(b0, b1, cK, LD, ks * 16, j * 8);
        mma(s[j], qa, b0);
        mma(s[j + 1], qa, b1);
        frag_bt2<T>(b0, b1, cV, LD, ks * 16, j * 8);
        mma(dp[j], da, b0);
        mma(dp[j + 1], da, b1);
      }
    }
    // P = exp(S * scale - lse) (masked: 0), then dS = P (dP - delta),
    // kept in s
    const bool need_mask =
        k0 + kTileKVdq > sk || (causal && k0 + kTileKVdq - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rh = e >> 1;
        bool ok = true;
        if (need_mask) {
          const int row = q0 + r0 + g + 8 * rh;
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          ok = col < sk && (!causal || col <= row + off);
        }
        const float p = ok ? expf(s[j][e] * scale - row_lse[rh]) : 0.f;
        s[j][e] = p * (dp[j][e] - row_delta[rh]);
      }
    }
    // dQ += dS K (scaled at the end)
#pragma unroll
    for (int ks = 0; ks < kTileKVdq / 16; ++ks) {
      P af[4];
      c_to_a<T>(af, s[2 * ks], s[2 * ks + 1]);  // ds in the input dtype
#pragma unroll
      for (int n = 0; n < NDT; n += 2) {
        P b0[2], b1[2];
        frag_b2<T>(b0, b1, cK, LD, ks * 16, n * 8);
        mma(acc[n], af, b0);
        mma(acc[n + 1], af, b1);
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the CTA (n_tiles == 0)

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = q0 + r0 + g + 8 * rh;
    if (row >= sq) continue;
    T* drow = dq + L.dq.at(b, h) + row * L.dq.r;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      st_pair<T>(drow + n * 8 + 2 * t, acc[n][2 * rh] * scale,
                 acc[n][2 * rh + 1] * scale);
    }
  }
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const BwdLayout& layout,
        const void* out, const void* dout, const void* lse, void* delta,
        void* dq, void* dk, void* dv, int batch, int sq, int sk, int heads,
        int kv_heads, int causal, cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const int rep = heads / kv_heads;
  const int64_t rows = static_cast<int64_t>(batch) * sq * heads;
  delta_kernel<T, D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0,
                       stream>>>(static_cast<const T*>(out),
                                 static_cast<const T*>(dout),
                                 static_cast<float*>(delta), sq, heads, rows);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  constexpr size_t smem_kv = dkdv_smem_bytes<T, D>();
  auto* dkdv = flash_dkdv_kernel<T, D>;
  static bool dkdv_smem_set = false;
  rc = set_smem(dkdv, smem_kv, &dkdv_smem_set);
  if (rc != 0) return rc;
  const dim3 grid_kv((sk + kTileKV - 1) / kTileKV, kv_heads, batch);
  dkdv<<<grid_kv, kThreads, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), layout, static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, heads, rep, scale,
      causal);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  constexpr size_t smem_q = dq_smem_bytes<T, D>();
  auto* dqk = flash_dq_kernel<T, D>;
  static bool dq_smem_set = false;
  rc = set_smem(dqk, smem_q, &dq_smem_set);
  if (rc != 0) return rc;
  const dim3 grid_q((sq + kTileQdq - 1) / kTileQdq, heads, batch);
  dqk<<<grid_q, kThreads, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), layout, static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), sq, sk, heads, rep, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PTT_BWD(T, D)                                                    \
  bwd<T, D>(q, k, v, layout, out, dout, lse, delta, dq, dk, dv, batch, sq, \
            sk, heads, kv_heads, causal, static_cast<cudaStream_t>(stream))

// K5. q, k, v, strides, heads and kv_heads as ptt_flash_fwd; out, dout:
// [batch, sq, heads * head_dim] contiguous; lse: [batch, heads, sq] fp32
// from the forward; delta: fp32 [batch, heads, sq] scratch (written
// here); dq: [batch, sq, heads * head_dim] rows of stride dq_stride; dk,
// dv: [batch, sk, kv_heads * head_dim] rows of stride dkv_stride (all
// three may be column views of one packed gradient). Launches the delta,
// dk/dv and dq kernels; returns cudaGetLastError().
extern "C" int ptt_flash_bwd(const void* q, const void* k, const void* v,
                             int64_t q_stride, int64_t kv_stride,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dq,
                             void* dk, void* dv, int64_t dq_stride,
                             int64_t dkv_stride, int batch, int sq, int sk,
                             int heads, int kv_heads, int head_dim,
                             int causal, int dtype, void* stream) {
  if (!ptt_flash::args_ok(batch, sq, sk, heads, kv_heads, head_dim) ||
      q == nullptr || k == nullptr || v == nullptr || out == nullptr ||
      dout == nullptr || lse == nullptr || delta == nullptr ||
      dq == nullptr || dk == nullptr || dv == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t d = head_dim;
  const BwdLayout layout{{sq * q_stride, d, q_stride},
                         {sk * kv_stride, d, kv_stride},
                         {sq * heads * d, d, heads * d},
                         {sq * dq_stride, d, dq_stride},
                         {sk * dkv_stride, d, dkv_stride}};
  PTT_FLASH_DISPATCH(dtype, head_dim, PTT_BWD)
}

// K8, fp32. q: [groups, sq, head_dim] with group stride q_gstride and row
// stride q_rstride elements; k, v: [groups, sk, head_dim] sharing strides
// kv_gstride, kv_rstride (as ptt_flash_fwd_hm); out, dout: [groups, sq,
// head_dim] contiguous; lse: [groups, sq] fp32 from the forward; delta:
// fp32 [groups, sq] scratch (written here); dq: [groups, sq, head_dim],
// dk, dv: [groups, sk, head_dim], all contiguous. Pointers and row
// strides are 16-byte aligned. Launches the delta, dk/dv and dq kernels;
// returns cudaGetLastError().
extern "C" int ptt_flash_bwd_hm_split_fp32(
    const void* q, const void* k, const void* v, int64_t q_gstride,
    int64_t q_rstride, int64_t kv_gstride, int64_t kv_rstride,
    const void* out, const void* dout, const void* lse, void* delta,
    void* dq, void* dk, void* dv, int groups, int sq, int sk, int head_dim,
    int causal, void* stream) {
  if (!ptt_flash::args_ok(groups, sq, sk, 1, 1, head_dim) || q == nullptr ||
      k == nullptr || v == nullptr || out == nullptr || dout == nullptr ||
      lse == nullptr || delta == nullptr || dq == nullptr || dk == nullptr ||
      dv == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int batch = groups, heads = 1, kv_heads = 1;
  const int64_t d = head_dim;
  const BwdLayout layout{{q_gstride, 0, q_rstride},
                         {kv_gstride, 0, kv_rstride},
                         {sq * d, 0, d},
                         {sq * d, 0, d},
                         {sk * d, 0, d}};
  switch (head_dim) {
    case 32:
      return PTT_BWD(float, 32);
    case 64:
      return PTT_BWD(float, 64);
    default:
      return PTT_BWD(float, 128);
  }
}
#undef PTT_BWD
