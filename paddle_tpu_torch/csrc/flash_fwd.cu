// Flash attention forward for Hopper (sm_90a): native layout (K4) and
// head-major (K6), one kernel addressed through per-operand strides.
//
// Replaces the TPU kernels `_fwd_nl_single` / `_fwd_nl_stream`
// (paddle_tpu/incubate/nn/functional/flash_attention.py:769,805, driven by
// `_nl_forward`; entry `ptt_flash_fwd`) and `_fwd_kernel_single` /
// `_fwd_kernel` (:135,167, driven by `_flash_forward_pallas`; entry
// `ptt_flash_fwd_hm`). Each operand is a base pointer and a (batch, head,
// row) stride triple, so both layouts run the same code:
// - native: q [B,Sq,H*D] and k, v [B,Sk,KVH*D] at their row strides, so
//   the packed [B,S,3E] qkv of a fused projection is read in place at
//   column offsets 0, E and 2E with no slice copies; out [B,Sq,H*D]
//   contiguous. Grouped query: KVH divides H and q head h reads kv head
//   h / (H / KVH) in place at its own column offset, so K and V are never
//   repeated (the TPU kernels pick the shared head out of a 128-lane pair
//   block, `_pair_kv`; here it is only a pointer).
// - head-major: q [G,Sq,D] and k, v [G,Sk,D] with G = B*H heads and one
//   head each (the caller repeats grouped k, v to H heads, as the JAX
//   package's "ramp" does), at their group and row strides; out [G,Sq,D]
//   contiguous.
// lse is [B,H,Sq] fp32 in both, which is [G,Sq] head-major (the TPU's
// [B,H/hpb,hpb,S] and [G,1,Sq] are lane artefacts).
//
// What is computed (as the TPU kernels, per head): logits = (q . k^T in
// fp32) * 1/sqrt(D), causal mask bottom-right (q_pos + Sk - Sq >= k_pos),
// keys past Sk masked; an online softmax over kv tiles with fp32 running
// max m and sum l, p cast to the input dtype before the P.V product;
// out = acc / max(l, 1e-30), lse = m_safe + log(max(l, 1e-30)) with
// m_safe = 0 where a row sees no key.
//
// Bound: operations. Causal attention at B=4, S=2048, H=16, D=128 is
// 68.7 GFLOP against 0.1 GB of bf16 inputs and outputs, far above the
// card's flop/byte balance: the least time is FLOPs / 989 TFLOP/s.
//
// Design (a simple tensor-core kernel; wgmma/TMA pipelines are later
// work): one CTA of 4 warps per (q tile of 64 rows, head, batch), each
// warp owning 16 q rows; a loop over kv tiles of 64 replaces the TPU's
// sequential kv grid axis, and fully masked causal tiles are never
// visited. K and V tiles are double-buffered in shared memory: cp.async
// brings tile i+1 while tile i is computed. bf16 products run on
// `mma.sync.m16n8k16` with `ldmatrix` fragment loads (`.trans` for V); S
// and P stay in registers, the S accumulator re-packed as the A operand
// of P.V. Only tiles that cross the causal diagonal or the ragged end are
// masked. CTAs with the most causal work are issued first, and the q heads
// that share a kv head are neighbours in the grid, so their K/V tiles are
// read from device memory about once and from L2 after that.

#include "flash_common.cuh"

namespace {

using namespace ptt_flash;

constexpr int kTileQ = 64;   // q rows per CTA (16 per warp)
constexpr int kTileKV = 64;  // kv rows per step

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  return static_cast<size_t>(kTileQ + 4 * kTileKV) * Ld<T, D>::value *
         sizeof(T);
}

// The operands' strides: q, k and v (shared), out.
struct Layout {
  Strides q, kv, o;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, Layout L, T* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int heads,
                     int rep, float scale, int causal) {
  using P = typename Pair<T>::type;
  constexpr int LD = Ld<T, D>::value;
  constexpr int NKT = kTileKV / 8;  // n-tiles of S
  constexpr int NDT = D / 8;        // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kTileQ * LD;         // [2][kTileKV][LD]
  T* sV = sK + 2 * kTileKV * LD;    // [2][kTileKV][LD]

  const int nq = (sq + kTileQ - 1) / kTileQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int off = sk - sq;
  const int r0 = warp * 16;

  const T* qb = q + L.q.at(b, h);
  const int64_t kvoff = L.kv.at(b, h / rep);  // shared kv head
  const T* kb = k + kvoff;
  const T* vb = v + kvoff;

  int kv_end = sk;
  if (causal) {
    const int last_q = (q0 + kTileQ < sq ? q0 + kTileQ : sq) - 1;
    kv_end = last_q + off + 1 < sk ? last_q + off + 1 : sk;
  }
  const int n_tiles = kv_end > 0 ? (kv_end + kTileKV - 1) / kTileKV : 0;

  load_tile_async<T, D, kTileQ>(sQ, qb, L.q.r, q0, sq);
  if (n_tiles > 0) {
    load_tile_async<T, D, kTileKV>(sK, kb, L.kv.r, 0, sk);
    load_tile_async<T, D, kTileKV>(sV, vb, L.kv.r, 0, sk);
  }
  cp_async_commit();

  P qf[D / 16][4];
  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTileKV;
    const T* cK = sK + (it & 1) * kTileKV * LD;
    const T* cV = sV + (it & 1) * kTileKV * LD;
    cp_async_wait_all();  // tile it (and, first, Q) has landed
    __syncthreads();      // ... for every thread; tile it-1 is read out
    if (it + 1 < n_tiles) {
      T* nK = sK + ((it + 1) & 1) * kTileKV * LD;
      T* nV = sV + ((it + 1) & 1) * kTileKV * LD;
      load_tile_async<T, D, kTileKV>(nK, kb, L.kv.r, k0 + kTileKV, sk);
      load_tile_async<T, D, kTileKV>(nV, vb, L.kv.r, k0 + kTileKV, sk);
      cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        frag_a<T>(qf[ks], sQ, LD, r0, ks * 16);
      }
    }

    float s[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int j = 0; j < NKT; j += 2) {
        P b0[2], b1[2];
        frag_bt2<T>(b0, b1, cK, LD, ks * 16, j * 8);
        mma(s[j], qf[ks], b0);
        mma(s[j + 1], qf[ks], b1);
      }
    }
    // scale; mask only where the tile crosses the diagonal or the end
    const bool need_mask =
        k0 + kTileKV > sk || (causal && k0 + kTileKV - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (need_mask) {
          const int row = q0 + r0 + g + (e >= 2 ? 8 : 0);
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= sk || (causal && col > row + off)) x = -INFINITY;
        }
        s[j][e] = x;
      }
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        mx = fmaxf(mx, fmaxf(s[j][2 * rh], s[j][2 * rh + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rh], mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[rh] - m_safe);  // 0 while m is -inf
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        const float p0 = expf(s[j][2 * rh] - m_safe);
        const float p1 = expf(s[j][2 * rh + 1] - m_safe);
        s[j][2 * rh] = p0;
        s[j][2 * rh + 1] = p1;
        rs += p0 + p1;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[rh] = alpha * l[rh] + rs;
      m[rh] = m_new;
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        o[n][2 * rh] *= alpha;
        o[n][2 * rh + 1] *= alpha;
      }
    }
#pragma unroll
    for (int ks = 0; ks < kTileKV / 16; ++ks) {
      P af[4];
      c_to_a<T>(af, s[2 * ks], s[2 * ks + 1]);  // p in the input dtype
#pragma unroll
      for (int n = 0; n < NDT; n += 2) {
        P b0[2], b1[2];
        frag_b2<T>(b0, b1, cV, LD, ks * 16, n * 8);
        mma(o[n], af, b0);
        mma(o[n + 1], af, b1);
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the CTA (n_tiles == 0)

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = q0 + r0 + g + 8 * rh;
    if (row >= sq) continue;
    const float lsafe = fmaxf(l[rh], 1e-30f);
    T* orow = out + L.o.at(b, h) + row * L.o.r;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      st_pair<T>(orow + n * 8 + 2 * t, o[n][2 * rh] / lsafe,
                 o[n][2 * rh + 1] / lsafe);
    }
    if (t == 0) {
      const float m_safe = m[rh] == -INFINITY ? 0.f : m[rh];
      lse[(static_cast<int64_t>(b) * heads + h) * sq + row] =
          m_safe + logf(lsafe);
    }
  }
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, const Layout& layout,
        void* out, void* lse, int batch, int sq, int sk, int heads,
        int kv_heads, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, D>();
  auto* kernel = flash_fwd_kernel<T, D>;
  static bool smem_set = false;
  const int rc = set_smem(kernel, smem, &smem_set);
  if (rc != 0) return rc;
  const dim3 grid((sq + kTileQ - 1) / kTileQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), layout, static_cast<T*>(out),
      static_cast<float*>(lse), sq, sk, heads, heads / kv_heads,
      1.f / sqrtf(static_cast<float>(D)), causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PTT_FWD(T, D)                                                      \
  fwd<T, D>(q, k, v, layout, out, lse, batch, sq, sk, heads, kv_heads,     \
            causal, static_cast<cudaStream_t>(stream))

// K4. q: [batch, sq, heads * head_dim] rows of stride q_stride elements;
// k, v: [batch, sk, kv_heads * head_dim] rows of stride kv_stride (k and v
// may be column views of one packed array; kv_heads divides heads); out:
// [batch, sq, heads * head_dim] contiguous; lse: [batch, heads, sq] fp32.
// Pointers and row strides are 16-byte aligned; head_dim is 32, 64 or
// 128; one dtype (ptt::DType). Returns cudaGetLastError() after the
// launch.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             int64_t q_stride, int64_t kv_stride, void* out,
                             void* lse, int batch, int sq, int sk, int heads,
                             int kv_heads, int head_dim, int causal,
                             int dtype, void* stream) {
  if (!ptt_flash::args_ok(batch, sq, sk, heads, kv_heads, head_dim) ||
      q == nullptr ||
      k == nullptr || v == nullptr || out == nullptr || lse == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t d = head_dim;
  const Layout layout{{sq * q_stride, d, q_stride},
                      {sk * kv_stride, d, kv_stride},
                      {sq * heads * d, d, heads * d}};
  PTT_FLASH_DISPATCH(dtype, head_dim, PTT_FWD)
}

// K6. q: [groups, sq, head_dim] with group stride q_gstride and row
// stride q_rstride elements; k, v: [groups, sk, head_dim] sharing strides
// kv_gstride, kv_rstride (one head per group: grouped k, v come repeated);
// out: [groups, sq, head_dim] contiguous; lse: [groups, sq] fp32. The
// last dim is contiguous; pointers and row strides are 16-byte aligned;
// head_dim is 32, 64 or 128; one dtype. Returns cudaGetLastError().
extern "C" int ptt_flash_fwd_hm(const void* q, const void* k, const void* v,
                                int64_t q_gstride, int64_t q_rstride,
                                int64_t kv_gstride, int64_t kv_rstride,
                                void* out, void* lse, int groups, int sq,
                                int sk, int head_dim, int causal, int dtype,
                                void* stream) {
  if (!ptt_flash::args_ok(groups, sq, sk, 1, 1, head_dim) || q == nullptr ||
      k == nullptr || v == nullptr || out == nullptr || lse == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int batch = groups, heads = 1, kv_heads = 1;
  const int64_t d = head_dim;
  const Layout layout{{q_gstride, 0, q_rstride},
                      {kv_gstride, 0, kv_rstride},
                      {sq * d, 0, d}};
  PTT_FLASH_DISPATCH(dtype, head_dim, PTT_FWD)
}
#undef PTT_FWD
