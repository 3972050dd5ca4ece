// Head-major flash attention one-pass backward, fp32: K7's fp32 calls.
//
// K7 replaces the TPU kernel `_bwd_fused_kernel` (paddle_tpu/incubate/nn/
// functional/flash_attention.py:441, driven by `_flash_backward_fused`
// :531), which the JAX package's head-major backward picks while the
// whole-sequence fp32 dq scratch fits its budget (sq * D * 4 bytes up to
// `_DQ_SCRATCH_BYTES`, 4 MiB). Its bf16 calls run the warpgroup kernel of
// flash_bwd_sm90.cu (`wgmma` has no fp32 product); its fp32 calls, which
// serve the card-vs-CPU checks, run this file's kernel, whose products are
// emulated in exact fp32 FMAs (flash_common.cuh). Layout as K6
// (flash_fwd.cu, `ptt_flash_fwd_hm`): q [G,Sq,D] and k, v [G,Sk,D] with
// G = B*H heads, read at their group and row strides; out, dout
// [G,Sq,D] contiguous; lse [G,Sq] fp32 from the forward; dq [G,Sq,D] and
// dk, dv [G,Sk,D] written contiguous.
//
// What is computed, per head, for each live (kv tile, q tile) pair: p =
// exp(logits - lse) (masked entries 0), recomputed once and feeding all
// three gradients: dv += p^T dO, dp = dO v^T, ds = p (dp - delta),
// dk += ds^T q * scale, dq += ds k * scale, where delta = rowsum(dO * O)
// (the shared delta kernel, flash_common.cuh, computed before the
// products as the JAX package's `_bwd_operands` does); every product
// accumulates in fp32.
//
// Bound: operations, as the bf16 kernel's (flash_bwd_sm90.cu), but at the
// card's fp32 rate outside the tensor cores.
//
// Design. The TPU kernel walks a sequential grid (head, kv block, q
// block) and carries dq across kv blocks in one whole-sequence fp32 VMEM
// scratch. Here one CTA of 4 warps owns one head and walks the same order
// in a loop: kv tiles of 64 rows outer (each warp owning 16 kv rows, dk
// and dv in registers), the live q tiles of 32 rows inner. dq accumulates
// in a whole-sequence fp32 scratch in device memory ([G,Sq,D]) that only
// this CTA touches, so it needs no atomics: every element is added to in
// kv-tile order by one thread, and the same inputs give the same bytes.
// After the last kv tile each thread casts its own dq elements into place.
// Per pair: S^T = K Q^T, P^T, dP^T = V dO^T and dS^T stay in registers
// (accumulators re-packed into A operands, as K5's dk/dv kernel); dS^T is
// also written to shared memory so that the four warps can split dq's
// product dS K by (16 q rows, D/2 columns) and read-add-write their part
// of the scratch. K/V tiles and the q, dO, lse and delta tiles are
// double-buffered with cp.async, the next pair's tiles in flight while
// this pair is computed. Only B*H CTAs run: it serves fp32 checks, not
// the training step.

#include "flash_common.cuh"

namespace {

using namespace ptt_flash;

constexpr int kTileKV = 64;  // kv rows per outer step (16 a warp)
constexpr int kTileQ = 32;   // q rows per inner step

// Row stride of the dS^T tile [kTileKV][kTileQ]: 16 bytes of padding keep
// rows 16-byte aligned for ldmatrix and off each other's banks.
template <typename T>
struct LdS {
  static constexpr int value = kTileQ + 16 / static_cast<int>(sizeof(T));
};

template <typename T, int D>
constexpr size_t bwd_hm_smem_bytes() {
  return static_cast<size_t>(4 * kTileKV + 4 * kTileQ) * Ld<T, D>::value *
             sizeof(T) +
         4 * kTileQ * sizeof(float) +
         static_cast<size_t>(kTileKV) * LdS<T>::value * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_hm_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, int64_t q_gs, int64_t q_rs,
                        int64_t kv_gs, int64_t kv_rs,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq_acc, T* __restrict__ dq,
                        T* __restrict__ dk, T* __restrict__ dv, int sq,
                        int sk, float scale, int causal) {
  using P = typename Pair<T>::type;
  constexpr int LD = Ld<T, D>::value;
  constexpr int LDS = LdS<T>::value;
  constexpr int NQT = kTileQ / 8;  // n-tiles of S^T
  constexpr int NDT = D / 8;       // n-tiles of dk, dv
  constexpr int NDH = D / 16;      // n-tiles of a warp's half of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][kTileKV][LD]
  T* sV = sK + 2 * kTileKV * LD;           // [2][kTileKV][LD]
  T* sQ = sV + 2 * kTileKV * LD;           // [2][kTileQ][LD]
  T* sdO = sQ + 2 * kTileQ * LD;           // [2][kTileQ][LD]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kTileQ * LD);  // [2][kTileQ]
  float* sDelta = sLse + 2 * kTileQ;                              // [2][kTileQ]
  T* sdS = reinterpret_cast<T*>(sDelta + 2 * kTileQ);  // [kTileKV][LDS]

  const int64_t gi = blockIdx.x;  // this CTA's head (b * H + h)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int off = sk - sq;
  const int r0 = warp * 16;  // this warp's kv rows within the kv tile
  const int mq = (warp & 1) * 16;         // ... its q rows of dq's product
  const int dc = (warp >> 1) * (D / 2);   // ... and its dq columns

  const T* qg = q + gi * q_gs;
  const T* kg = k + gi * kv_gs;
  const T* vg = v + gi * kv_gs;
  const T* dog = dout + gi * sq * D;
  const float* lse_g = lse + gi * sq;
  const float* delta_g = delta + gi * sq;
  float* acc_g = dq_acc + gi * sq * D;

  const int nkv = (sk + kTileKV - 1) / kTileKV;
  const int nq = (sq + kTileQ - 1) / kTileQ;
  // the first q tile that sees a key of kv tile j (every kv tile has one:
  // its first key k0 <= Sk - 1 is visible to q row Sq - 1)
  auto q_first = [&](int j) {
    const int first = j * kTileKV - off;
    return causal && first > 0 ? first / kTileQ : 0;
  };
  auto load_kv = [&](int j, int buf) {
    load_tile_async<T, D, kTileKV>(sK + buf * kTileKV * LD, kg, kv_rs,
                                   j * kTileKV, sk);
    load_tile_async<T, D, kTileKV>(sV + buf * kTileKV * LD, vg, kv_rs,
                                   j * kTileKV, sk);
  };
  auto load_q = [&](int i, int buf) {
    const int q0 = i * kTileQ;
    load_tile_async<T, D, kTileQ>(sQ + buf * kTileQ * LD, qg, q_rs, q0, sq);
    load_tile_async<T, D, kTileQ>(sdO + buf * kTileQ * LD, dog, D, q0, sq);
    if (threadIdx.x < 2 * kTileQ) {
      const int jj = threadIdx.x & (kTileQ - 1);
      const bool live = q0 + jj < sq;
      const float* src = threadIdx.x < kTileQ ? lse_g : delta_g;
      float* dst = (threadIdx.x < kTileQ ? sLse : sDelta) + buf * kTileQ + jj;
      cp_async4(dst, src + (live ? q0 + jj : 0), live);
    }
  };

  float dk_acc[NDT][4];
  float dv_acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  // the (kv tile j, q tile i) pairs in the TPU grid's order
  int j = 0;
  int i = q_first(0);
  int buf = 0;
  load_kv(0, 0);
  load_q(i, 0);
  cp_async_commit();
  while (true) {
    const int k0 = j * kTileKV;
    const int q0 = i * kTileQ;
    const T* cK = sK + (j & 1) * kTileKV * LD;
    const T* cV = sV + (j & 1) * kTileKV * LD;
    const T* cQ = sQ + buf * kTileQ * LD;
    const T* cdO = sdO + buf * kTileQ * LD;
    const float* cLse = sLse + buf * kTileQ;
    const float* cDelta = sDelta + buf * kTileQ;
    cp_async_wait_all();  // this pair's tiles have landed
    __syncthreads();      // ... for every thread; the other buffers are free
    int nj = j;
    int ni = i + 1;
    if (ni >= nq) {
      nj = j + 1;
      ni = nj < nkv ? q_first(nj) : 0;
    }
    const bool more = nj < nkv;
    if (more) {
      if (nj != j) load_kv(nj, nj & 1);
      load_q(ni, buf ^ 1);
      cp_async_commit();
    }

    // S^T = K Q^T, then P^T = exp(S^T * scale - lse) (masked: 0)
    float st[NQT][4];
#pragma unroll
    for (int jn = 0; jn < NQT; ++jn) {
      st[jn][0] = st[jn][1] = st[jn][2] = st[jn][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      P af[4];
      frag_a<T>(af, cK, LD, r0, ks * 16);
#pragma unroll
      for (int jn = 0; jn < NQT; jn += 2) {
        P b0[2], b1[2];
        frag_bt2<T>(b0, b1, cQ, LD, ks * 16, jn * 8);
        mma(st[jn], af, b0);
        mma(st[jn + 1], af, b1);
      }
    }
#pragma unroll
    for (int jn = 0; jn < NQT; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = k0 + r0 + g + (e >= 2 ? 8 : 0);
        const int qc = jn * 8 + 2 * t + (e & 1);
        const int qrow = q0 + qc;
        const bool ok = kv < sk && qrow < sq && (!causal || kv <= qrow + off);
        st[jn][e] = ok ? expf(st[jn][e] * scale - cLse[qc]) : 0.f;
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
    for (int jn = 0; jn < NQT; ++jn) {
      dpt[jn][0] = dpt[jn][1] = dpt[jn][2] = dpt[jn][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      P af[4];
      frag_a<T>(af, cV, LD, r0, ks * 16);
#pragma unroll
      for (int jn = 0; jn < NQT; jn += 2) {
        P b0[2], b1[2];
        frag_bt2<T>(b0, b1, cdO, LD, ks * 16, jn * 8);
        mma(dpt[jn], af, b0);
        mma(dpt[jn + 1], af, b1);
      }
    }
#pragma unroll
    for (int jn = 0; jn < NQT; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpt[jn][e] =
            st[jn][e] * (dpt[jn][e] - cDelta[jn * 8 + 2 * t + (e & 1)]);
      }
      // dS^T in the input dtype, for dq's product below
      st_pair<T>(sdS + (r0 + g) * LDS + jn * 8 + 2 * t, dpt[jn][0],
                 dpt[jn][1]);
      st_pair<T>(sdS + (r0 + g + 8) * LDS + jn * 8 + 2 * t, dpt[jn][2],
                 dpt[jn][3]);
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
    __syncthreads();  // dS^T of the whole kv tile is in shared memory

    // this warp's part of dS K: q rows [mq, mq + 16), columns [dc, dc +
    // D/2), added into the scratch (the first kv tile stores: every live
    // q tile is live at kv tile 0, so that is its first visit)
    float dqp[NDH][4];
#pragma unroll
    for (int n = 0; n < NDH; ++n) dqp[n][0] = dqp[n][1] = dqp[n][2] = dqp[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kTileKV / 16; ++ks) {
      P af[4];
      frag_a_t<T>(af, sdS, LDS, mq, ks * 16);
#pragma unroll
      for (int n = 0; n < NDH; n += 2) {
        P b0[2], b1[2];
        frag_b2<T>(b0, b1, cK, LD, ks * 16, dc + n * 8);
        mma(dqp[n], af, b0);
        mma(dqp[n + 1], af, b1);
      }
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = q0 + mq + g + 8 * rh;
      if (row >= sq) continue;
      float* arow = acc_g + static_cast<int64_t>(row) * D + dc + 2 * t;
#pragma unroll
      for (int n = 0; n < NDH; ++n) {
        float2* p = reinterpret_cast<float2*>(arow + n * 8);
        float2 a = j == 0 ? make_float2(0.f, 0.f) : *p;
        a.x += dqp[n][2 * rh];
        a.y += dqp[n][2 * rh + 1];
        *p = a;
      }
    }

    if (nj != j) {  // kv tile j is done: write its dk and dv
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int kv = k0 + r0 + g + 8 * rh;
        if (kv >= sk) continue;
        const int64_t base = (gi * sk + kv) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < NDT; ++n) {
          st_pair<T>(dk + base + n * 8, dk_acc[n][2 * rh] * scale,
                     dk_acc[n][2 * rh + 1] * scale);
          st_pair<T>(dv + base + n * 8, dv_acc[n][2 * rh],
                     dv_acc[n][2 * rh + 1]);
        }
      }
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
      }
    }
    if (!more) break;
    j = nj;
    i = ni;
    buf ^= 1;
  }

  // dq = scratch * scale in the input dtype; each thread reads back only
  // the elements it added to. q tiles before q_first(0) see no key: 0.
  const int seen = q_first(0);
  for (int qi = 0; qi < nq; ++qi) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = qi * kTileQ + mq + g + 8 * rh;
      if (row >= sq) continue;
      const int64_t base = (gi * sq + row) * D + dc + 2 * t;
#pragma unroll
      for (int n = 0; n < NDH; ++n) {
        const float2 a =
            qi >= seen ? *reinterpret_cast<const float2*>(dq_acc + base + n * 8)
                       : make_float2(0.f, 0.f);
        st_pair<T>(dq + base + n * 8, a.x * scale, a.y * scale);
      }
    }
  }
}

template <typename T, int D>
int bwd_hm(const void* q, const void* k, const void* v, int64_t q_gs,
           int64_t q_rs, int64_t kv_gs, int64_t kv_rs, const void* out,
           const void* dout, const void* lse, void* delta, void* dq_acc,
           void* dq, void* dk, void* dv, int groups, int sq, int sk,
           int causal, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(groups) * sq;
  delta_kernel<T, D><<<static_cast<unsigned>((rows + 255) / 256), 256, 0,
                       stream>>>(static_cast<const T*>(out),
                                 static_cast<const T*>(dout),
                                 static_cast<float*>(delta), sq, 1, rows);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  constexpr size_t smem = bwd_hm_smem_bytes<T, D>();
  auto* kernel = flash_bwd_hm_kernel<T, D>;
  static bool smem_set = false;
  rc = set_smem(kernel, smem, &smem_set);
  if (rc != 0) return rc;
  kernel<<<groups, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_gs, q_rs, kv_gs, kv_rs,
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc),
      static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      1.f / sqrtf(static_cast<float>(D)), causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32. q: [groups, sq, head_dim] with group stride q_gstride and row
// stride q_rstride elements; k, v: [groups, sk, head_dim] sharing strides
// kv_gstride, kv_rstride (as ptt_flash_fwd_hm); out, dout: [groups, sq,
// head_dim] contiguous; lse: [groups, sq] fp32 from the forward; delta:
// fp32 [groups, sq] and dq_acc: fp32 [groups, sq, head_dim] scratch
// (written here); dq: [groups, sq, head_dim], dk, dv: [groups, sk,
// head_dim], all contiguous. Pointers and row strides are 16-byte
// aligned. Launches the delta kernel and the one-pass kernel; returns
// cudaGetLastError().
extern "C" int ptt_flash_bwd_hm_fp32(
    const void* q, const void* k, const void* v, int64_t q_gstride,
    int64_t q_rstride, int64_t kv_gstride, int64_t kv_rstride,
    const void* out, const void* dout, const void* lse, void* delta,
    void* dq_acc, void* dq, void* dk, void* dv, int groups, int sq, int sk,
    int head_dim, int causal, void* stream) {
  if (!ptt_flash::args_ok(groups, sq, sk, 1, 1, head_dim) || q == nullptr ||
      k == nullptr || v == nullptr || out == nullptr || dout == nullptr ||
      lse == nullptr || delta == nullptr || dq_acc == nullptr ||
      dq == nullptr || dk == nullptr || dv == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTT_BWD_HM(D)                                                       \
  bwd_hm<float, D>(q, k, v, q_gstride, q_rstride, kv_gstride, kv_rstride,   \
                   out, dout, lse, delta, dq_acc, dq, dk, dv, groups, sq,   \
                   sk, causal, s)
  switch (head_dim) {
    case 32:
      return PTT_BWD_HM(32);
    case 64:
      return PTT_BWD_HM(64);
    default:
      return PTT_BWD_HM(128);
  }
#undef PTT_BWD_HM
}
