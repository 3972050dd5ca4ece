// Building blocks of the Hopper attention backward (flash_bwd_sm90.cu):
// warpgroup products (`wgmma.mma_async`, bf16 in, fp32 accumulators in
// registers), their shared-memory descriptors, the swizzled tile layout
// they read and the cp.async copies that fill it, and the ordered add's
// acquire / release counters.
//
// Tile layout. A [ROWS, D] bf16 tile is stored as D / CB column blocks of
// CB = min(D, 64) columns, each block [ROWS][CB] row-major with rows of
// RB = 2 CB bytes (128, or 64 at D = 32) in the matching swizzle: the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8) (128-byte rows) or
// c ^ ((r / 2) % 4) (64-byte rows), a function of the address bits, so
// every block starts on a 1024-byte boundary. The same stored tile is
// read K-major (its columns are the product's depth: K in S^T = K Q^T)
// and MN-major (its rows are the depth: dO in dV = P^T dO), with the
// transpose flag of `wgmma` and the descriptor below.
//
// Accumulator layout of a 64 x N product (each warp w of the warpgroup
// owns rows 16 w .. 16 w + 15; g = lane / 4, t = lane % 4): d[e] is row
// 16 w + g + 8 ((e / 2) % 2), column 8 (e / 4) + 2 t + e % 2. The A
// operand from registers for depth step s (16 columns) is the m16n8k16 A
// fragment of this warp's rows, which is accumulator entries 8 s .. 8 s
// + 7 of a 64-column product, packed in pairs (pack_a).
#pragma once

#include "flash_common.cuh"

namespace ptt_sm90 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Columns of one column block at head dim D, and its row bytes.
template <int D>
struct Block {
  static constexpr int kCols = D < 64 ? D : 64;
  static constexpr int kRowBytes = 2 * kCols;
};

// Byte offset of `off` (a row-major offset within a column block of
// RB-byte rows) after the RB-byte swizzle.
template <int RB>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  constexpr uint32_t kMask = RB == 128 ? 7u : 3u;
  return off ^ (((off >> 7) & kMask) << 4);
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode of RB-byte rows (1: 128
// bytes, 2: 64 bytes).
template <int RB>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t kMode = RB == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (kMode << 62);
}

// K-major operand: rows [row0, row0 + 64) (A) or the tile's first N rows
// (B) of a [ROWS, D] tile at `tile`, depth step s (columns 16 s .. 16 s +
// 15). Swizzled K-major layouts read 8-row groups SBO = 8 RB bytes apart.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int s) {
  constexpr int CB = Block<D>::kCols, RB = Block<D>::kRowBytes;
  const uint32_t addr = tile + (s * 16 / CB) * (ROWS * RB) + row0 * RB +
                        (s * 16 % CB) * 2;
  return make_desc<RB>(addr, 16, 8 * RB);
}

// MN-major operand: depth rows [krow0, krow0 + 16) and columns from col0
// of a [ROWS, D] tile at `tile`. LBO steps from one column block (64 or 32
// columns) to the next, SBO from one group of 8 depth rows to the next.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int krow0,
                                           int col0) {
  constexpr int CB = Block<D>::kCols, RB = Block<D>::kRowBytes;
  const uint32_t addr = tile + (col0 / CB) * (ROWS * RB) + krow0 * RB +
                        (col0 % CB) * 2;
  return make_desc<RB>(addr, ROWS * RB, 8 * RB);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across an issue or a wait: the products write them asynchronously.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Make this thread's generic-proxy shared-memory writes (cp.async,
// st.shared) visible to the async proxy that `wgmma` reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of the 4 depth steps of a 64 x 64 accumulator.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&d)[32]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[s][r] = pack_bf16(d[8 * s + 2 * r], d[8 * s + 2 * r + 1]);
    }
  }
}

// Start copying rows [r0, r0 + ROWS) of a [n, D] operand with row stride
// `stride` elements into the swizzled tile at `tile`, NT threads sharing
// the 16-byte chunks; rows at or past n become zeros.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile(unsigned char* tile,
                                          const bf16* src, int64_t stride,
                                          int r0, int n) {
  constexpr int CB = Block<D>::kCols, RB = Block<D>::kRowBytes;
  constexpr int kChunks = D / 8, kPerBlock = CB / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool live = r0 + r < n;
    ptt_flash::cp_async16(
        tile + (c / kPerBlock) * (ROWS * RB) +
            swz<RB>(r * RB + (c % kPerBlock) * 16),
        src + (live ? static_cast<int64_t>(r0 + r) * stride + c * 8 : 0),
        live);
  }
}

// The ordered add's counters: an acquire load, and a release add made
// by one thread after a barrier that follows the whole CTA's writes.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
// Spin until *p reaches `target`. A wait past about a second (2^31 SM
// cycles) is a schedule fault: trap, so the launch fails with a CUDA
// error instead of hanging.
__device__ __forceinline__ void wait_count(const int* p, int target) {
  const long long t0 = clock64();
  while (ld_acquire(p) < target) {
    if (clock64() - t0 > (1ll << 31)) __trap();
  }
}

// The live tiles under bottom-right causal alignment (q row r sees keys
// k <= r + off, off = sk - sq), mirrored by `hm_bwd_schedule` in
// paddle_tpu_torch/incubate/nn/functional/flash_attention.py. Key 0 is
// visible to every q row that sees any key, so a q tile's live kv tiles
// run from 0 to kv_last, and a kv tile's live q tiles from q_first to the
// last q tile.
struct Schedule {
  int sq, sk, causal;
  // Last kv tile (TK rows) with a key visible to q rows [q0, q0 + rows)
  // (clipped at sq); -1 where those rows see no key.
  __device__ __forceinline__ int kv_last(int q0, int rows, int tk) const {
    const int nkv = (sk + tk - 1) / tk;
    if (!causal) return nkv - 1;
    const int top = min(q0 + rows, sq) - 1 + sk - sq;
    return top < 0 ? -1 : min(nkv - 1, top / tk);
  }
  // First q tile (TQ rows) with a row that sees a key of kv tile j.
  __device__ __forceinline__ int q_first(int j, int tk, int tq) const {
    const int first = j * tk - (sk - sq);
    return causal && first > 0 ? first / tq : 0;
  }
};

// --- warpgroup products: d (+)= A B over one depth step of 16 --------------
// `accumulate` 0 overwrites d; kTransA / kTransB 1 read that operand
// MN-major.

// d[64 x 16] (+)= A B, A and B in shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d[64 x 32] (+)= A B, A and B in shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d[64 x 32] (+)= A B, A in registers, B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(kTransB));
}

// d[64 x 64] (+)= A B, A and B in shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d[64 x 64] (+)= A B, A in registers, B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(kTransB));
}

// d[64 x 128] (+)= A B, A in registers, B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(kTransB));
}

}  // namespace ptt_sm90
