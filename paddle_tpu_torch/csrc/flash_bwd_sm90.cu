// Head-major flash attention backward for Hopper (sm_90a) on warpgroup
// products, bf16: the one-pass K7 and the two-kernel K8.
//
// K7 (entry `ptt_flash_bwd_hm`) replaces the TPU kernel
// `_bwd_fused_kernel` (paddle_tpu/incubate/nn/functional/
// flash_attention.py:441, driven by `_flash_backward_fused` :531), which
// the JAX package's head-major backward picks while its whole-sequence
// fp32 dq scratch fits `_DQ_SCRATCH_BYTES` (Sq * D * 4 bytes up to 4
// MiB). K8 (entry `ptt_flash_bwd_hm_split`) replaces `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (:349, :393, driven by `_flash_backward_pallas` :567)
// above it. Layout as K6 (flash_fwd.cu, `ptt_flash_fwd_hm`): q [G,Sq,D]
// and k, v [G,Sk,D] (G = B*H heads, one each) read in place at their
// group and row strides (the fused op's projection views); out, dout
// [G,Sq,D] contiguous; lse [G,Sq] fp32 from the forward; dq [G,Sq,D] and
// dk, dv [G,Sk,D] written contiguous. fp32 calls run the earlier kernels
// (flash_bwd_hm.cu, flash_bwd.cu), which emulate the product in exact
// FMAs: `wgmma` has no fp32 product.
//
// What is computed, per head and live (kv tile, q tile) pair: p =
// exp(logits - lse) (masked entries 0), dv += p^T dO, dp = dO v^T, ds =
// p (dp - delta) cast to bf16, dk += ds^T q * scale, dq += ds k * scale,
// where delta = rowsum(dO * O) (delta_kernel, flash_common.cuh, first);
// every product accumulates in fp32.
//
// Bound: operations. Five products to the forward's two: 171.9 GFLOP at
// B=4, S=2048, H=16, D=128 causal and 2.749 TFLOP at B=1, S=16384, so
// the least time is FLOPs / 989 TFLOP/s.
//
// Design (after FlashAttention-3's backward, Shah et al. 2024, and its
// deterministic mode). Every product is a `wgmma` of a 64-row warpgroup
// tile with fp32 accumulators in registers (flash_bwd_sm90.cuh); P^T and
// dS^T go back in as register A operands, and dS, which dq's product
// reads transposed, goes through shared memory.
//   kv kernel (bwd_kv_kernel): one CTA of two warpgroups per (kv tile of
//     128 rows, head), kv tile fastest, so the first kv tiles (the most
//     causal work) are issued first: 16 x 64 = 1024 CTAs at GPT-3 1.3B's
//     2K step. Each warpgroup owns 64 kv rows: K and V resident, dK and dV
//     in registers. The live q tiles of 64 rows stream through a 2-stage
//     cp.async ring (q, dO, lse, delta), last tile first. Per q tile:
//     S^T = K Q^T, dP^T = V dO^T, P^T, dS^T = P^T (dP^T - delta), dV +=
//     P^T dO, dK += dS^T Q. Tensor maps were the other copy route; the
//     strided views of the projection read in place made cp.async with
//     a software swizzle the simpler one, and the copies overlap the
//     products through the ring all the same.
//   K7's dq (kDq): dS^T of both warpgroups goes to shared memory and
//     each warpgroup computes half of dq's columns of the 64-row q tile,
//     dS K, over the CTA's 128 keys. Partials are summed over kv tiles in
//     ascending order, as the JAX kernel's sequential grid does, through
//     an fp32 scratch [G,Sq,D] and an int32 counter per (head, q tile):
//     every thread waits until the counter reads j (kv tiles 0..j-1 have
//     added), and while dS K runs it reads the scratch's sum, then adds
//     its partial and writes it back (kv tile 0 adds to 0, so the scratch
//     needs no memset), and after a barrier thread 0 releases the counter
//     (CUTLASS's split-K semaphore). The last live kv tile writes dq *
//     scale in bf16 instead. The same inputs give the same bytes. A CTA
//     waits only on CTAs of its head with smaller kv tiles, which were
//     issued before it, so the wait ends; one that spins past a second
//     traps (wait_count). Every CTA of a head walks its q tiles last
//     first, so they meet each q tile in step: the chain of adds costs
//     each CTA one offset, not a wait per q tile. What the add costs
//     still lies on each CTA's path: at GPT-3 1.3B's 2K step the scratch
//     moves about 1 GB. A warp of its own for the add (as FlashAttention-3
//     has) would take it off, but does not fit: the compute threads use
//     236 registers at D = 128, and a CTA of more than 256 threads gets
//     168 (with `setmaxnreg` too, in every form tried).
//   K8: the kv kernel without the dq product (kDq false), and the dq
//     kernel (bwd_dq_kernel): one CTA of two warpgroups per (q tile of
//     128 rows, head), last q tiles first, Q and dO resident, kv tiles of
//     128 through a 2-stage ring, each as two halves of 64 keys: S = Q
//     K^T, dP = dO V^T, dS, dQ += dS K with dS as the register A operand,
//     dq in registers with one writer per element. No scratch but delta.

#include "flash_bwd_sm90.cuh"

namespace {

using namespace ptt_sm90;
using ptt_flash::cp_async_commit;
using ptt_flash::cp_async_wait_all;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTQ = 64;        // kv kernel: q rows per streamed tile
constexpr int kTK = 128;       // kv rows per kv-kernel CTA, per dq-kernel step
constexpr int kTQdq = 128;     // dq kernel: q rows per CTA
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

// Shared memory of the kv kernel (byte offsets, every tile 1024-aligned).
template <int D, bool kDq>
struct KvSmem {
  static constexpr int kKV = kTK * D * 2;       // K or V
  static constexpr int kQ = kTQ * D * 2;        // one stage of q or dO
  static constexpr int kK = 0;
  static constexpr int kV = kKV;
  static constexpr int kQs = 2 * kKV;           // q, 2 stages
  static constexpr int kDO = kQs + 2 * kQ;      // dO, 2 stages
  static constexpr int kDS = kDO + 2 * kQ;      // dS^T [kTK][kTQ] (kDq)
  static constexpr int kStats = kDS + (kDq ? kTK * kTQ * 2 : 0);
  static constexpr int kBytes = kStats + 4 * kTQ * 4;  // lse, delta x 2
  static constexpr size_t kAlloc = kBytes + 1024;       // + alignment
};

// Shared memory of the dq kernel.
template <int D>
struct DqSmem {
  static constexpr int kT = kTQdq * D * 2;  // one [128, D] tile
  static constexpr int kQ = 0;
  static constexpr int kDO = kT;
  static constexpr int kK = 2 * kT;         // 2 stages
  static constexpr int kV = 4 * kT;         // 2 stages
  static constexpr size_t kAlloc = 6 * kT + 1024;
};

// The dynamic shared memory rounded up to 1024 bytes (the swizzle's
// period): its shared-window address and a generic pointer to it.
__device__ __forceinline__ uint32_t smem_base(unsigned char* raw,
                                              unsigned char** p) {
  const uint32_t a = smem_u32(raw);
  const uint32_t b = (a + 1023u) & ~1023u;
  *p = raw + (b - a);
  return b;
}

__device__ __forceinline__ void st_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

template <int D, bool kDq>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, int64_t q_gs, int64_t q_rs,
                  int64_t kv_gs, int64_t kv_rs,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq_acc,
                  int* __restrict__ counters, bf16* __restrict__ dq,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, int sq,
                  int sk, float scale, int causal) {
  using L = KvSmem<D, kDq>;
  constexpr int NDQ = D / 2;  // dq columns of one warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sp;
  const uint32_t sb = smem_base(smem_raw, &sp);
  float* s_lse = reinterpret_cast<float*>(sp + L::kStats);  // [2][kTQ]
  float* s_delta = s_lse + 2 * kTQ;                         // [2][kTQ]

  const int j = blockIdx.x;        // this CTA's kv tile
  const int64_t gi = blockIdx.y;   // ... and head
  const int tid = threadIdx.x;
  const int wg = tid >> 7;         // warpgroup: kv rows [64 wg, 64 wg + 64)
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int off = sk - sq;
  const int k0 = j * kTK;
  const int nq = (sq + kTQ - 1) / kTQ;
  const Schedule sched{sq, sk, causal};
  const int i_lo = sched.q_first(j, kTK, kTQ);
  const float scale_log2 = scale * kLog2e;

  const bf16* qg = q + gi * q_gs;
  const bf16* dog = dout + gi * sq * D;
  const float* lse_g = lse + gi * sq;
  const float* delta_g = delta + gi * sq;

  if (kDq && j == 0) {
    // q tiles before q_first(0) see no key: their dq is 0
    bf16* dst = dq + gi * sq * D;
    const int n = i_lo * kTQ * D;
    for (int e = 2 * tid; e < n; e += 2 * kThreads) {
      st_bf16x2(dst + e, 0.f, 0.f);
    }
  }

  load_tile<D, kTK, kThreads>(sp + L::kK, k + gi * kv_gs, kv_rs, k0, sk);
  load_tile<D, kTK, kThreads>(sp + L::kV, v + gi * kv_gs, kv_rs, k0, sk);
  auto load_q = [&](int i, int st) {
    const int q0 = i * kTQ;
    load_tile<D, kTQ, kThreads>(sp + L::kQs + st * L::kQ, qg, q_rs, q0, sq);
    load_tile<D, kTQ, kThreads>(sp + L::kDO + st * L::kQ, dog, D, q0, sq);
    if (tid < 2 * kTQ) {
      const int r = tid & (kTQ - 1);
      const bool live = q0 + r < sq;
      ptt_flash::cp_async4((tid < kTQ ? s_lse : s_delta) + st * kTQ + r,
                           (tid < kTQ ? lse_g : delta_g) + (live ? q0 + r : 0),
                           live);
    }
  };
  // live q tiles [i_lo, nq), the last first
  const int n_it = nq - i_lo;
  load_q(nq - 1, 0);
  cp_async_commit();

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int i = nq - 1 - it;
    const int st = it & 1;
    const int q0 = i * kTQ;
    // the shared-memory base, opaque to the compiler in each iteration:
    // the products' descriptors are rebuilt from it (a few integer adds)
    // instead of being hoisted out of the loop into registers
    uint32_t base = sb;
    asm volatile("" : "+r"(base));
    const uint32_t sQ = base + L::kQs + st * L::kQ;
    const uint32_t sdO = base + L::kDO + st * L::kQ;
    const float* c_lse = s_lse + st * kTQ;
    const float* c_delta = s_delta + st * kTQ;
    cp_async_wait_all();  // this q tile has landed
    fence_proxy_async();
    __syncthreads();      // ... for every thread; the other stage is free
    if (it + 1 < n_it) {
      load_q(i - 1, st ^ 1);
      cp_async_commit();
    }

    // S^T = K Q^T and dP^T = V dO^T, this warpgroup's 64 kv rows
    float s_acc[32], p_acc[32];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      wgmma_ss<0, 0>(s_acc, desc_k<D, kTK>(base + L::kK, 64 * wg, s),
                     desc_k<D, kTQ>(sQ, 0, s), s);
    }
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      wgmma_ss<0, 0>(p_acc, desc_k<D, kTK>(base + L::kV, 64 * wg, s),
                     desc_k<D, kTQ>(sdO, 0, s), s);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);
    fence_regs(p_acc);

    // P^T = exp(S^T * scale - lse) (masked: 0), dS^T = P^T (dP^T - delta),
    // 8 q columns at a time: their lse and delta are read where they are
    // used (the empty asm keeps the compiler from hoisting all 32 reads
    // into registers)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int qc = 8 * c + 2 * t;
      const float2 lse2 = *reinterpret_cast<const float2*>(c_lse + qc);
      const float2 delta2 = *reinterpret_cast<const float2*>(c_delta + qc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * c + r;
        const int kv = k0 + 64 * wg + 16 * warp + g + (r & 2 ? 8 : 0);
        const int qr = q0 + qc + (r & 1);
        const bool live = kv < sk && qr < sq && (!causal || kv <= qr + off);
        const float row_lse = r & 1 ? lse2.y : lse2.x;
        const float p =
            live ? exp2f(s_acc[e] * scale_log2 - row_lse * kLog2e) : 0.f;
        s_acc[e] = p;
        p_acc[e] = p * (p_acc[e] - (r & 1 ? delta2.y : delta2.x));
      }
      asm volatile("" ::: "memory");
    }
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, s_acc);
    pack_a(da, p_acc);
    if (kDq) {
      // dS^T (bf16) to shared memory for dq's product
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 64 * wg + 16 * warp + g + 8 * h;
          *reinterpret_cast<uint32_t*>(
              sp + L::kDS + swz<128>(row * 128 + (8 * c + 2 * t) * 2)) =
              da[c >> 1][(c & 1) * 2 + h];
        }
      }
      fence_proxy_async();
    }

    // dV += P^T dO, dK += dS^T Q (scaled at the end)
    wgmma_fence();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_rs<1>(dv_acc, pa[s], desc_mn<D, kTQ>(sdO, 16 * s, 0), 1);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_rs<1>(dk_acc, da[s], desc_mn<D, kTQ>(sQ, 16 * s, 0), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);

    if (kDq) {
      // the ordered add: once kv tiles 0..j-1 of this q tile have added
      // (its counter reads j). Every thread waits (an acquire of its own)
      // before the product: a branch or a loop while a product runs
      // would serialize it.
      int* cnt = counters + gi * nq + i;
      wait_count(cnt, j);
      __syncthreads();  // dS^T of both warpgroups is in shared memory
      // this warpgroup's dq columns [NDQ wg, NDQ wg + NDQ) of the q tile:
      // dS K over the CTA's 128 keys (dS read MN-major from dS^T)
      float q_acc[NDQ / 2];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kTK / 16; ++s) {
        wgmma_ss<1, 1>(q_acc, desc_mn<64, kTK>(base + L::kDS, 16 * s, 0),
                       desc_mn<D, kTK>(base + L::kK, 16 * s, NDQ * wg), s);
      }
      wgmma_commit();

      // while it runs, the sum of kv tiles 0..j-1 (kv tile 0 adds to 0:
      // the scratch needs no memset), every read in flight at once
      const bool last = j == sched.kv_last(q0, kTQ, kTK);
      float2 prev[2][NDQ / 8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + 16 * warp + g + 8 * h;
        const auto* src = reinterpret_cast<const float2*>(
            dq_acc + (gi * sq + row) * D + NDQ * wg + 2 * t);
#pragma unroll
        for (int c = 0; c < NDQ / 8; ++c) {
          prev[h][c] =
              j != 0 && row < sq ? __ldcg(src + 4 * c) : make_float2(0.f, 0.f);
        }
      }
      wgmma_wait_all();
      fence_regs(q_acc);
      // the sums; the last live kv tile writes dq * scale in bf16
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = q0 + 16 * warp + g + 8 * h;
        if (row >= sq) continue;
        const int64_t at = (gi * sq + row) * D + NDQ * wg + 2 * t;
#pragma unroll
        for (int c = 0; c < NDQ / 8; ++c) {
          const float2 part =
              make_float2(q_acc[4 * c + 2 * h], q_acc[4 * c + 2 * h + 1]);
          const float2 sum =
              make_float2(prev[h][c].x + part.x, prev[h][c].y + part.y);
          if (last) {
            st_bf16x2(dq + at + 8 * c, sum.x * scale, sum.y * scale);
          } else {
            __stcg(reinterpret_cast<float2*>(dq_acc + at + 8 * c), sum);
          }
        }
      }
      // every thread's writes, ordered by the barrier, before the count
      // (a release at gpu scope, as CUTLASS's split-K semaphore does)
      __syncthreads();
      if (tid == 0 && !last) red_release_add(cnt, 1);
    }
  }

  // dk (scaled) and dv of this warpgroup's 64 kv rows
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kv = k0 + 64 * wg + 16 * warp + g + 8 * h;
      if (kv >= sk) continue;
      const int64_t at = (gi * sk + kv) * D + 8 * c + 2 * t;
      st_bf16x2(dk + at, dk_acc[4 * c + 2 * h] * scale,
                dk_acc[4 * c + 2 * h + 1] * scale);
      st_bf16x2(dv + at, dv_acc[4 * c + 2 * h], dv_acc[4 * c + 2 * h + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, int64_t q_gs, int64_t q_rs,
                  int64_t kv_gs, int64_t kv_rs,
                  const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int sq, int sk, float scale, int causal) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sp;
  const uint32_t sb = smem_base(smem_raw, &sp);

  const int nqt = (sq + kTQdq - 1) / kTQdq;
  const int q0 = (nqt - 1 - static_cast<int>(blockIdx.x)) * kTQdq;
  const int64_t gi = blockIdx.y;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;         // warpgroup: q rows [64 wg, 64 wg + 64)
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int off = sk - sq;
  const float scale_log2 = scale * kLog2e;
  const Schedule sched{sq, sk, causal};
  const int kv_end = sched.kv_last(q0, kTQdq, kTK) + 1;  // live kv tiles
  const int n_kv = kv_end;
  bf16* dqg = dq + gi * sq * D;

  const bf16* kg = k + gi * kv_gs;
  const bf16* vg = v + gi * kv_gs;
  if (n_kv > 0) {
    load_tile<D, kTQdq, kThreads>(sp + L::kQ, q + gi * q_gs, q_rs, q0, sq);
    load_tile<D, kTQdq, kThreads>(sp + L::kDO, dout + gi * sq * D, D, q0,
                                  sq);
    load_tile<D, kTK, kThreads>(sp + L::kK, kg, kv_rs, 0, sk);
    load_tile<D, kTK, kThreads>(sp + L::kV, vg, kv_rs, 0, sk);
    cp_async_commit();
  }
  // this thread's two q rows and their statistics (lse in log2 units)
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 64 * wg + 16 * warp + g + 8 * h;
    row_lse[h] = row < sq ? lse[gi * sq + row] * kLog2e : 0.f;
    row_delta[h] = row < sq ? delta[gi * sq + row] : 0.f;
  }

  float d_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) d_acc[e] = 0.f;

  for (int jj = 0; jj < n_kv; ++jj) {
    const int st = jj & 1;
    const int k0 = jj * kTK;
    uint32_t base = sb;  // opaque: see the kv kernel
    asm volatile("" : "+r"(base));
    const uint32_t sK = base + L::kK + st * L::kT;
    const uint32_t sV = base + L::kV + st * L::kT;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (jj + 1 < n_kv) {
      load_tile<D, kTK, kThreads>(sp + L::kK + (st ^ 1) * L::kT, kg, kv_rs,
                                  k0 + kTK, sk);
      load_tile<D, kTK, kThreads>(sp + L::kV + (st ^ 1) * L::kT, vg, kv_rs,
                                  k0 + kTK, sk);
      cp_async_commit();
    }
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {  // keys [k0 + 64 hk, k0 + 64 hk + 64)
      float s_acc[32], p_acc[32];
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < D / 16; ++s) {
        wgmma_ss<0, 0>(s_acc, desc_k<D, kTQdq>(base + L::kQ, 64 * wg, s),
                       desc_k<D, kTK>(sK, 64 * hk, s), s);
      }
#pragma unroll
      for (int s = 0; s < D / 16; ++s) {
        wgmma_ss<0, 0>(p_acc, desc_k<D, kTQdq>(base + L::kDO, 64 * wg, s),
                       desc_k<D, kTK>(sV, 64 * hk, s), s);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s_acc);
      fence_regs(p_acc);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int h = (e >> 1) & 1;
        const int qr = q0 + 64 * wg + 16 * warp + g + 8 * h;
        const int kv = k0 + 64 * hk + 8 * (e >> 2) + 2 * t + (e & 1);
        const bool keep = kv < sk && qr < sq && (!causal || kv <= qr + off);
        const float p =
            keep ? exp2f(s_acc[e] * scale_log2 - row_lse[h]) : 0.f;
        p_acc[e] = p * (p_acc[e] - row_delta[h]);
      }
      uint32_t da[4][4];
      pack_a(da, p_acc);
      // dQ += dS K (scaled at the end)
      wgmma_fence();
      fence_regs(d_acc);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        wgmma_rs<1>(d_acc, da[s], desc_mn<D, kTK>(sK, 64 * hk + 16 * s, 0),
                    1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(d_acc);
    }
  }

  // dq * scale; rows that see no key get 0
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 64 * wg + 16 * warp + g + 8 * h;
      if (row >= sq) continue;
      st_bf16x2(dqg + static_cast<int64_t>(row) * D + 8 * c + 2 * t,
                d_acc[4 * c + 2 * h] * scale,
                d_acc[4 * c + 2 * h + 1] * scale);
    }
  }
}

int launch_delta(const void* out, const void* dout, void* delta, int groups,
                 int sq, int head_dim, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(groups) * sq;
  const unsigned blocks = static_cast<unsigned>((rows + 255) / 256);
  const auto* o = static_cast<const bf16*>(out);
  const auto* g = static_cast<const bf16*>(dout);
  auto* d = static_cast<float*>(delta);
  switch (head_dim) {
    case 32:
      ptt_flash::delta_kernel<bf16, 32><<<blocks, 256, 0, stream>>>(
          o, g, d, sq, 1, rows);
      break;
    case 64:
      ptt_flash::delta_kernel<bf16, 64><<<blocks, 256, 0, stream>>>(
          o, g, d, sq, 1, rows);
      break;
    default:
      ptt_flash::delta_kernel<bf16, 128><<<blocks, 256, 0, stream>>>(
          o, g, d, sq, 1, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The operands of one call, as the entry points take them.
struct Args {
  const bf16 *q, *k, *v;
  int64_t q_gs, q_rs, kv_gs, kv_rs;
  const bf16* dout;
  const float *lse, *delta;
  float* dq_acc;
  int* counters;
  bf16 *dq, *dk, *dv;
  int groups, sq, sk, causal;
};

template <int D, bool kDq>
int launch_kv(const Args& a, cudaStream_t stream) {
  auto* kernel = bwd_kv_kernel<D, kDq>;
  constexpr size_t smem = KvSmem<D, kDq>::kAlloc;
  static bool smem_set = false;
  int rc = ptt_flash::set_smem(kernel, smem, &smem_set);
  if (rc != 0) return rc;
  const dim3 grid((a.sk + kTK - 1) / kTK, a.groups);
  kernel<<<grid, kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.q_gs, a.q_rs, a.kv_gs, a.kv_rs, a.dout, a.lse,
      a.delta, a.dq_acc, a.counters, a.dq, a.dk, a.dv, a.sq, a.sk,
      1.f / sqrtf(static_cast<float>(D)), a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Args& a, cudaStream_t stream) {
  auto* kernel = bwd_dq_kernel<D>;
  constexpr size_t smem = DqSmem<D>::kAlloc;
  static bool smem_set = false;
  int rc = ptt_flash::set_smem(kernel, smem, &smem_set);
  if (rc != 0) return rc;
  const dim3 grid((a.sq + kTQdq - 1) / kTQdq, a.groups);
  kernel<<<grid, kThreads, smem, stream>>>(
      a.q, a.k, a.v, a.q_gs, a.q_rs, a.kv_gs, a.kv_rs, a.dout, a.lse,
      a.delta, a.dq, a.sq, a.sk, 1.f / sqrtf(static_cast<float>(D)),
      a.causal);
  return static_cast<int>(cudaGetLastError());
}

// K7 (split false): the kv kernel with dq; K8: the kv kernel without it,
// then the dq kernel.
template <int D>
int bwd(const Args& a, bool split, cudaStream_t stream) {
  if (!split) return launch_kv<D, true>(a, stream);
  const int rc = launch_kv<D, false>(a, stream);
  return rc != 0 ? rc : launch_dq<D>(a, stream);
}

int dispatch(const Args& a, const void* out, int head_dim, bool split,
             cudaStream_t stream) {
  const int rc = launch_delta(out, a.dout, const_cast<float*>(a.delta),
                              a.groups, a.sq, head_dim, stream);
  if (rc != 0) return rc;
  switch (head_dim) {
    case 32:
      return bwd<32>(a, split, stream);
    case 64:
      return bwd<64>(a, split, stream);
    default:
      return bwd<128>(a, split, stream);
  }
}

}  // namespace

// K7, bf16. q: [groups, sq, head_dim] with group stride q_gstride and row
// stride q_rstride elements; k, v: [groups, sk, head_dim] sharing strides
// kv_gstride, kv_rstride (as ptt_flash_fwd_hm); out, dout: [groups, sq,
// head_dim] contiguous; lse: [groups, sq] fp32 from the forward; delta:
// fp32 [groups, sq] and dq_acc: fp32 [groups, sq, head_dim] scratch
// (written here); counters: int32 [groups, ceil(sq / 64)], zero; dq:
// [groups, sq, head_dim], dk, dv: [groups, sk, head_dim], all contiguous.
// Pointers and row strides are 16-byte aligned. Launches the delta
// kernel and the one-pass kernel; returns cudaGetLastError().
extern "C" int ptt_flash_bwd_hm(const void* q, const void* k, const void* v,
                                int64_t q_gstride, int64_t q_rstride,
                                int64_t kv_gstride, int64_t kv_rstride,
                                const void* out, const void* dout,
                                const void* lse, void* delta, void* dq_acc,
                                void* counters, void* dq, void* dk, void* dv,
                                int groups, int sq, int sk, int head_dim,
                                int causal, void* stream) {
  if (!ptt_flash::args_ok(groups, sq, sk, 1, 1, head_dim) || q == nullptr ||
      k == nullptr || v == nullptr || out == nullptr || dout == nullptr ||
      lse == nullptr || delta == nullptr || dq_acc == nullptr ||
      counters == nullptr || dq == nullptr || dk == nullptr ||
      dv == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), q_gstride, q_rstride,
               kv_gstride, kv_rstride, static_cast<const bf16*>(dout),
               static_cast<const float*>(lse), static_cast<float*>(delta),
               static_cast<float*>(dq_acc), static_cast<int*>(counters),
               static_cast<bf16*>(dq), static_cast<bf16*>(dk),
               static_cast<bf16*>(dv), groups, sq, sk, causal};
  return dispatch(a, out, head_dim, false, static_cast<cudaStream_t>(stream));
}

// K8, bf16: arguments as ptt_flash_bwd_hm without dq_acc and counters.
// Launches the delta, kv (dk, dv) and dq kernels; returns
// cudaGetLastError().
extern "C" int ptt_flash_bwd_hm_split(
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
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), q_gstride, q_rstride,
               kv_gstride, kv_rstride, static_cast<const bf16*>(dout),
               static_cast<const float*>(lse), static_cast<float*>(delta),
               nullptr, nullptr, static_cast<bf16*>(dq),
               static_cast<bf16*>(dk), static_cast<bf16*>(dv), groups, sq,
               sk, causal};
  return dispatch(a, out, head_dim, true, static_cast<cudaStream_t>(stream));
}
