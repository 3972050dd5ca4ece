// Flash attention forward for Hopper (sm_90a) on warpgroup products,
// bf16: native layout (K4, entry `ptt_flash_fwd`) and head-major (K6,
// entry `ptt_flash_fwd_hm`), one kernel addressed through per-operand
// (batch, head, row) strides.
//
// Replaces the TPU kernels `_fwd_nl_single` / `_fwd_nl_stream`
// (paddle_tpu/incubate/nn/functional/flash_attention.py:769,805, driven by
// `_nl_forward` :944) and `_fwd_kernel_single` / `_fwd_kernel` (:135,167,
// driven by `_flash_forward_pallas` :297). fp32 calls run the earlier
// kernel of flash_fwd.cu (entries `ptt_flash_fwd_fp32`,
// `ptt_flash_fwd_hm_fp32`): `wgmma` has no fp32 product.
//
// Layout, as flash_fwd.cu: native q [B,Sq,H*D] and k, v [B,Sk,KVH*D] read
// in place at their row strides (the packed [B,S,3E] of a fused
// projection at column offsets 0, E and 2E); grouped query: q head h
// reads kv head h / (H / KVH) in place, K and V are never repeated.
// Head-major q [G,Sq,D], k, v [G,Sk,D] at any group and row strides (G in
// the batch place, one head). out contiguous; lse [B,H,Sq] fp32 ([G,Sq]).
//
// What is computed, per head: logits = (q . k^T in fp32) / sqrt(D),
// causal mask bottom-right (q_pos + Sk - Sq >= k_pos), keys past Sk
// masked; an online softmax over kv tiles with fp32 running max m and sum
// l, p rounded to bf16 before the P.V product; out = acc / max(l, 1e-30),
// lse = m_safe + log(max(l, 1e-30)) (natural log), m_safe = 0 for a row
// that sees no key (its out is 0).
//
// Bound: operations. Causal attention at B=4, S=2048, H=16, D=128 is
// 68.7 GFLOP against 0.1 GB of inputs and outputs: the least time is
// FLOPs / 989 TFLOP/s.
//
// Design (after FlashAttention-3's forward, Shah et al. 2024), built from
// the blocks of flash_bwd_sm90.cuh. One CTA of two warpgroups per (q tile
// of 128 rows, head, batch), each warpgroup owning 64 q rows. The grid is
// taken longest first (GridPlace): the last q tiles (the most causal
// work) of every head before any shorter one, so the last wave is short;
// within a q tile the q heads that share a kv head are neighbours, so
// their K/V tiles come from L2.
// - Products: S = Q K^T is an SS `wgmma` (Q and K K-major), O += P V an RS
//   `wgmma` with P packed from the S accumulator as the register A operand
//   and V read MN-major. kv tiles of 128 keys at D=128: O, S and P take
//   64 + 64 + 32 registers a thread, within the 255 of a 256-thread CTA,
//   one CTA an SM. At D <= 64, kv tiles of 64 keys, so a thread fits in
//   128 registers and two CTAs share an SM (four warpgroups to hide each
//   other's latency), which timed faster than 128 keys at D=64.
// - Loads: a 3-stage ring of K and V tiles in the 128/64-byte swizzle,
//   filled with cp.async, K by the first warpgroup's threads and V by the
//   second's, each thread's copies reported to the "full" mbarrier of its
//   operand's stage (cp.async.mbarrier.arrive.noinc). Both warpgroups
//   wait on it, fence the async proxy and read. Each says through an
//   "empty" mbarrier when it is done with the other's operand of a stage,
//   and refills its own two tiles ahead. No CTA-wide barrier sits in the
//   loop.
// - Overlap within a warpgroup: S_j = Q K_j^T is issued together with
//   O += P_{j-1} V_{j-1}; the softmax of tile j runs once S_j is done,
//   while P_{j-1} V_{j-1} is still in flight.
// - Ping-pong between the warpgroups: named barriers order the issue of
//   one warpgroup's products after the other's, so each warpgroup's
//   softmax overlaps the other's products. Both warpgroups walk the same
//   live kv tiles of their CTA (a row that sees no key still takes part),
//   so their barrier sequences match.
// - Softmax in the exp2 domain: p = exp2(s * scale * log2(e) - m), one
//   FMA and one ex2.approx; lse is converted back to natural log at the
//   end. Only tiles that cross the diagonal or the ragged end are masked
//   (a compile-time choice: no branch runs while a product is in
//   flight); a tile past the last live one (Schedule::kv_last) is never
//   visited.
// - O and lse have one writer each: two calls give the same bytes.

#include <type_traits>

#include "flash_bwd_sm90.cuh"

namespace {

using namespace ptt_sm90;
using ptt_flash::Strides;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kTQ = 128;       // q rows per CTA, 64 per warpgroup
// keys per kv tile, and CTAs an SM: at D = 128, 128 keys; at D <= 64, 64
// keys, which keeps a thread within the 128 registers that let two CTAs
// share an SM
template <int D>
struct FwdTile {
  static constexpr int kTK = D <= 64 ? 64 : 128;
  static constexpr int kCtas = D <= 64 ? 2 : 1;
};
constexpr int kStages = 3;     // K/V ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The operands' strides: q, k and v (shared), out.
struct Layout {
  Strides q, kv, o;
};

// Shared memory (byte offsets; every tile 1024-aligned).
template <int D>
struct FwdSmem {
  static constexpr int kQ = 0;                     // [kTQ, D]
  static constexpr int kTile = FwdTile<D>::kTK * D * 2;  // a K or V tile
  static constexpr int kK = kTQ * D * 2;           // kStages K tiles
  static constexpr int kV = kK + kStages * kTile;  // kStages V tiles
  // mbarriers: K full, V full, K empty, V empty, kStages each
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr size_t kAlloc = kBars + 4 * kStages * 8 + 1024;
};

// --- mbarriers and named barriers ------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}
// Arrive on `bar` once every cp.async this thread has issued so far has
// landed (the barrier's count includes this arrival).
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}
// Wait for the phase of parity `parity` of `bar` to complete. A wait past
// about a second (2^31 SM cycles) is a schedule fault: trap.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) break;
    if (clock64() - t0 > (1ll << 31)) __trap();
  }
  __syncwarp();  // reconverge before the aligned barriers and products
}
// Named barriers over both warpgroups (id 0 is __syncthreads): a
// warpgroup waits on its own (sync) until the other arrives on it.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// 2^x on the special-function unit (flushes denormal results to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Start copying rows [r0, r0 + rows) of a [ROWS, D] swizzled tile (the
// layout of load_tile) from rows g0 + r of a [n, D] operand of row stride
// `stride`, 128 threads sharing the 16-byte chunks (tid in [0, 128)); rows
// at or past n become zeros.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(unsigned char* tile,
                                          const bf16* src, int64_t stride,
                                          int r0, int rows, int g0, int n,
                                          int tid) {
  constexpr int CB = Block<D>::kCols, RB = Block<D>::kRowBytes;
  constexpr int kChunks = D / 8, kPerBlock = CB / 8;
  for (int i = tid; i < rows * kChunks; i += 128) {
    const int r = r0 + i / kChunks;
    const int c = i % kChunks;
    const int gr = g0 + r;
    const bool live = gr < n;
    ptt_flash::cp_async16(
        tile + (c / kPerBlock) * (ROWS * RB) +
            swz<RB>(r * RB + (c % kPerBlock) * 16),
        src + (live ? static_cast<int64_t>(gr) * stride + c * 8 : 0), live);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, FwdTile<D>::kCtas)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, Layout L, bf16* __restrict__ out,
               float* __restrict__ lse, int sq, int sk, int heads, int rep,
               float scale, int causal) {
  using M = FwdSmem<D>;
  enum : int {
    kTK = FwdTile<D>::kTK,  // keys per kv tile
    NS = kTK / 16           // depth steps of P V
  };
  extern __shared__ unsigned char smem_raw[];
  const uint32_t a0 = smem_u32(smem_raw);
  const uint32_t sb = (a0 + 1023u) & ~1023u;
  unsigned char* sp = smem_raw + (sb - a0);

  const int nq = (sq + kTQ - 1) / kTQ;
  const GridPlace at = longest_first();  // the last q tiles first
  const int q0 = (nq - 1 - at.tile) * kTQ;
  const int h = at.head;
  const int b = at.batch;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;        // warpgroup: q rows [64 wg, 64 wg + 64)
  const int wtid = tid & 127;
  const int warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int off = sk - sq;
  const float scale_log2 = scale * kLog2e;
  const Schedule sched{sq, sk, causal};
  const int n_kv = sched.kv_last(q0, kTQ, kTK) + 1;  // live kv tiles

  const bf16* qb = q + L.q.at(b, h);
  const int64_t kvoff = L.kv.at(b, h / rep);  // the shared kv head
  const bf16* kb = k + kvoff;
  const bf16* vb = v + kvoff;
  // the mbarriers of stage s: full (this warpgroup's tile, K for the
  // first and V for the second, has landed) and empty (the other
  // warpgroup is done with its tile of the stage), at 8 s from each base
  const uint32_t full_k = sb + M::kBars;
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;
  const uint32_t my_full = wg == 0 ? full_k : full_v;
  const uint32_t my_empty = wg == 0 ? empty_k : empty_v;

  if (tid == 0) {
    for (int s = 0; s < 4 * kStages; ++s) mbar_init(full_k + 8 * s, 128);
  }
  __syncthreads();

  // tile jt of this warpgroup's operand (K: the first, V: the second)
  // into its stage
  auto load = [&](int jt) {
    const int st = jt % kStages;
    copy_rows<D, kTK>(sp + (wg == 0 ? M::kK : M::kV) + st * M::kTile,
                      wg == 0 ? kb : vb, L.kv.r, 0, kTK, jt * kTK, sk, wtid);
    mbar_arrive_cp_async(my_full + 8 * st);
  };
  // this warpgroup's 64 q rows
  copy_rows<D, kTQ>(sp + M::kQ, qb, L.q.r, 64 * wg, 64, q0, sq, wtid);
  ptt_flash::cp_async_commit();
  for (int jt = 0; jt < kStages && jt < n_kv; ++jt) load(jt);
  ptt_flash::cp_async_wait_all();  // the q rows (committed before)
  fence_proxy_async();
  bar_sync(3 + wg, 128);           // ... of every thread of the warpgroup

  float o_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o_acc[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, exp2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the sum
  uint32_t pa[NS][4];                   // P of the previous tile, bf16
  const int turn = 1 + wg;              // this warpgroup's issue turn
  const int other = 2 - wg;

  // S = Q K^T of the tile in stage st
  auto issue_s = [&](float (&s_acc)[kTK / 2], uint32_t base, int st) {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      wgmma_ss<0, 0>(s_acc, desc_k<D, kTQ>(base + M::kQ, 64 * wg, s),
                     desc_k<D, kTK>(base + M::kK + st * M::kTile, 0, s), s);
    }
    wgmma_commit();
  };
  // O += P V of the tile in stage st (P from the previous softmax)
  auto issue_pv = [&](uint32_t base, int st) {
    wgmma_fence();
    fence_regs(o_acc);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      wgmma_rs<1>(o_acc, pa[s],
                  desc_mn<D, kTK>(base + M::kV + st * M::kTile, 16 * s, 0),
                  1);
    }
    wgmma_commit();
  };
  // the online softmax of the tile of keys [k0, k0 + kTK): p = exp2(s
  // scale log2(e) - m) in place, with the new running max m and the sum
  // l; alpha = exp2(m_old - m). kMask: mask keys past Sk and above the
  // diagonal (-inf), known at compile time so that no branch runs while
  // a product is in flight.
  auto softmax = [&](float (&s_acc)[kTK / 2], int k0, float (&alpha)[2],
                     auto mask_tag) {
    if constexpr (decltype(mask_tag)::value) {
#pragma unroll
      for (int e = 0; e < kTK / 2; ++e) {
        const int row = q0 + 64 * wg + 16 * warp + g + 8 * ((e >> 1) & 1);
        const int col = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
        if (col >= sk || (causal && col > row + off)) s_acc[e] = -INFINITY;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kTK / 8; ++c) {
        mx = fmaxf(mx, fmaxf(s_acc[4 * c + 2 * hh],
                             s_acc[4 * c + 2 * hh + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx * scale_log2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[hh] = ex2(m[hh] - m_use);  // 0 while m is -inf
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kTK / 8; ++c) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int e = 4 * c + 2 * hh + x;
          s_acc[e] = ex2(fmaf(s_acc[e], scale_log2, -m_use));
          rs += s_acc[e];
        }
      }
      l[hh] = alpha[hh] * l[hh] + rs;
      m[hh] = m_new;
    }
  };
  // Release and refill: a stage's K is free once both warpgroups' S on
  // it is done, its V once both P V on it are; each warpgroup says when
  // it is done with the other's operand (the second: K after S_j, the
  // first: V after P_{j-1} V_{j-1}) and refills its own, tile j + 2 into
  // tile j - 1's stage, after its own products on that stage. The first
  // waits on the second's S_{j-1}, done a turn earlier, and the second on
  // the first's P_{j-1} V_{j-1}, issued before its own: neither waits
  // long, and neither waits on the other's later turn.
  auto refill = [&](int j) {
    const int pst = (j + kStages - 1) % kStages;  // tile j - 1's stage
    if (j + kStages - 1 < n_kv) {
      mbar_wait(my_empty + 8 * pst, ((j - 1) / kStages) & 1);
      load(j + kStages - 1);
    }
  };
  // kv tile j >= 1 in this warpgroup's turn: S_j = Q K_j^T and O +=
  // P_{j-1} V_{j-1} issued together; the softmax of S_j runs while P V is
  // in flight; then the stages are released and refilled, and O is
  // rescaled.
  auto step = [&](int j, auto mask_tag) {
    uint32_t base = sb;  // opaque: the descriptors are rebuilt from it
    asm volatile("" : "+r"(base));
    const int st = j % kStages;
    const int pst = (j + kStages - 1) % kStages;  // tile j - 1's stage
    mbar_wait(full_k + 8 * st, (j / kStages) & 1);
    mbar_wait(full_v + 8 * pst, ((j - 1) / kStages) & 1);
    fence_proxy_async();
    bar_sync(turn, kThreads);
    float s_acc[kTK / 2];
    issue_s(s_acc, base, st);
    issue_pv(base, pst);
    bar_arrive(other, kThreads);
    wgmma_wait<1>();  // S_j has landed; P_{j-1} V_{j-1} may still run
    fence_regs(s_acc);
    if (wg == 1) mbar_arrive(empty_k + 8 * st);
    float alpha[2];
    softmax(s_acc, j * kTK, alpha, mask_tag);
    wgmma_wait<0>();  // P_{j-1} V_{j-1} is done
    fence_regs(o_acc);
    fence_regs(pa);
    if (wg == 0) mbar_arrive(empty_v + 8 * pst);
    refill(j);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o_acc[e] *= alpha[(e >> 1) & 1];
    pack_a(pa, s_acc);
  };

  if (n_kv > 0) {
    // turns: the first warpgroup issues first in each; tile 0 alone, then
    // tiles 1 .. n_kv - 1, then the last P V
    if (wg == 1) bar_arrive(other, kThreads);
    {
      mbar_wait(full_k, 0);
      fence_proxy_async();
      bar_sync(turn, kThreads);
      float s_acc[kTK / 2];
      issue_s(s_acc, sb, 0);
      bar_arrive(other, kThreads);
      wgmma_wait<0>();
      fence_regs(s_acc);
      if (wg == 1) mbar_arrive(empty_k);
      float alpha[2];
      softmax(s_acc, 0, alpha, std::true_type{});
      pack_a(pa, s_acc);
    }
    // the tiles that need no mask, then those that cross the diagonal or
    // the ragged end (a suffix of the live tiles)
    auto needs_mask = [&](int j) {
      return j * kTK + kTK > sk || (causal && j * kTK + kTK - 1 > q0 + off);
    };
    int j_mask = n_kv;
    while (j_mask > 1 && needs_mask(j_mask - 1)) --j_mask;
    for (int j = 1; j < j_mask; ++j) step(j, std::false_type{});
    for (int j = j_mask; j < n_kv; ++j) step(j, std::true_type{});
    mbar_wait(full_v + 8 * ((n_kv - 1) % kStages),
              ((n_kv - 1) / kStages) & 1);
    fence_proxy_async();
    bar_sync(turn, kThreads);
    issue_pv(sb, (n_kv - 1) % kStages);
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(pa);
    if (wg == 0) bar_arrive(other, kThreads);
  }

  // out = O / l, lse = m ln 2 + log(l), rows that see no key: 0 and
  // log(1e-30)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = q0 + 64 * wg + 16 * warp + g + 8 * hh;
    if (row >= sq) continue;
    const float lsafe = fmaxf(lt, 1e-30f);
    const float inv = 1.f / lsafe;
    bf16* orow = out + L.o.at(b, h) + static_cast<int64_t>(row) * L.o.r;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<uint32_t*>(orow + 8 * c + 2 * t) =
          pack_bf16(o_acc[4 * c + 2 * hh] * inv,
                    o_acc[4 * c + 2 * hh + 1] * inv);
    }
    if (t == 0) {
      const float m_safe = m[hh] == -INFINITY ? 0.f : m[hh];
      lse[(static_cast<int64_t>(b) * heads + h) * sq + row] =
          m_safe * kLn2 + logf(lsafe);
    }
  }
}

template <int D>
int fwd(const bf16* q, const bf16* k, const bf16* v, const Layout& layout,
        bf16* out, float* lse, int batch, int sq, int sk, int heads,
        int kv_heads, int causal, cudaStream_t stream) {
  auto* kernel = fwd_kernel<D>;
  constexpr size_t smem = FwdSmem<D>::kAlloc;
  static bool smem_set = false;
  const int rc = ptt_flash::set_smem(kernel, smem, &smem_set);
  if (rc != 0) return rc;
  const dim3 grid((sq + kTQ - 1) / kTQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, layout, out, lse, sq, sk, heads, heads / kv_heads,
      1.f / sqrtf(static_cast<float>(D)), causal);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v,
             const Layout& layout, void* out, void* lse, int batch, int sq,
             int sk, int heads, int kv_heads, int head_dim, int causal,
             cudaStream_t stream) {
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  auto* op = static_cast<bf16*>(out);
  auto* lp = static_cast<float*>(lse);
  switch (head_dim) {
    case 32:
      return fwd<32>(qp, kp, vp, layout, op, lp, batch, sq, sk, heads,
                     kv_heads, causal, stream);
    case 64:
      return fwd<64>(qp, kp, vp, layout, op, lp, batch, sq, sk, heads,
                     kv_heads, causal, stream);
    default:
      return fwd<128>(qp, kp, vp, layout, op, lp, batch, sq, sk, heads,
                      kv_heads, causal, stream);
  }
}

}  // namespace

// K4, bf16. q: [batch, sq, heads * head_dim] rows of stride q_stride
// elements; k, v: [batch, sk, kv_heads * head_dim] rows of stride
// kv_stride (k and v may be column views of one packed array; kv_heads
// divides heads); out: [batch, sq, heads * head_dim] contiguous; lse:
// [batch, heads, sq] fp32. Pointers and row strides are 16-byte aligned;
// head_dim is 32, 64 or 128; dtype must be bf16 (ptt::DType; fp32 calls
// go to ptt_flash_fwd_fp32). Returns cudaGetLastError() after the launch.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             int64_t q_stride, int64_t kv_stride, void* out,
                             void* lse, int batch, int sq, int sk, int heads,
                             int kv_heads, int head_dim, int causal,
                             int dtype, void* stream) {
  if (!ptt_flash::args_ok(batch, sq, sk, heads, kv_heads, head_dim) ||
      dtype != ptt::kBFloat16 || q == nullptr || k == nullptr ||
      v == nullptr || out == nullptr || lse == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t d = head_dim;
  const Layout layout{{sq * q_stride, d, q_stride},
                      {sk * kv_stride, d, kv_stride},
                      {sq * heads * d, d, heads * d}};
  return dispatch(q, k, v, layout, out, lse, batch, sq, sk, heads, kv_heads,
                  head_dim, causal, static_cast<cudaStream_t>(stream));
}

// K6, bf16. q: [groups, sq, head_dim] with group stride q_gstride and row
// stride q_rstride elements; k, v: [groups, sk, head_dim] sharing strides
// kv_gstride, kv_rstride (one head per group: grouped k, v come
// repeated); out: [groups, sq, head_dim] contiguous; lse: [groups, sq]
// fp32. The last dim is contiguous; pointers, group and row strides are
// 16-byte aligned; head_dim is 32, 64 or 128; dtype must be bf16 (fp32:
// ptt_flash_fwd_hm_fp32). Returns cudaGetLastError().
extern "C" int ptt_flash_fwd_hm(const void* q, const void* k, const void* v,
                                int64_t q_gstride, int64_t q_rstride,
                                int64_t kv_gstride, int64_t kv_rstride,
                                void* out, void* lse, int groups, int sq,
                                int sk, int head_dim, int causal, int dtype,
                                void* stream) {
  if (!ptt_flash::args_ok(groups, sq, sk, 1, 1, head_dim) ||
      dtype != ptt::kBFloat16 || q == nullptr || k == nullptr ||
      v == nullptr || out == nullptr || lse == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t d = head_dim;
  const Layout layout{{q_gstride, 0, q_rstride},
                      {kv_gstride, 0, kv_rstride},
                      {sq * d, 0, d}};
  return dispatch(q, k, v, layout, out, lse, groups, sq, sk, 1, 1, head_dim,
                  causal, static_cast<cudaStream_t>(stream));
}
