// Warp-level tensor-core building blocks of the matmul kernels
// (int4h_mma.cuh: K9 on bf16 x and K1 on float x; int8w_mma.cuh: K7 on
// bf16 x and K3's int8-w / bf16 modes; s8_mma.cuh: K8, K3 W8A8, K1 W4A8;
// moe_decode_int4h.cu: K2). A kernel adds only its B tile and decode.
//
//   - cp.async copies (16 or 4 bytes, the rest zero-filled through the
//     source-size operand) into a ring of pipeline stages in dynamic shared
//     memory;
//   - the A tile of a stage (ATileLoader): BM rows x 128 bytes (kBK = 64
//     bf16 k, or 128 int8 k), 16-byte chunk c of row r stored at chunk
//     c ^ (r & 7), so the eight rows an ldmatrix phase reads sit in eight
//     distinct bank groups;
//   - ldmatrix.x4 A fragments (.trans: B fragments of row-major [k][n]
//     bf16, for flash_attention.cu's P V, dS K, dK and dV) and mma.sync
//     m16n8k16 (bf16 x bf16 -> f32);
//   - the int4 nibble -> bf16x2 B-register decode;
//   - the epilogue store of eight neighbouring outputs of one row (bf16 or
//     f32).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), lane = 4 g + t:
//   A a0a1: row g, k 2t..2t+1; a2a3: row g+8; a4a5: row g, k 2t+8..;
//     a6a7: row g+8, k 2t+8..
//   B b0b1: k 2t..2t+1, column g; b2b3: k 2t+8..2t+9, column g
//   C c0c1: row g, columns 2t..2t+1; c2c3: row g+8
// In each .b32 register the lower half holds the lower index.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmatile {

constexpr int kBK = 64;         // logical k per pipeline stage
constexpr int kARow = kBK * 2;  // bytes of one A-tile row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// SIZE (16 or 4) bytes global -> shared; only src_bytes are read, the rest
// of the destination is zero-filled (src_bytes = 0: all zeros).
template <int SIZE>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  static_assert(SIZE == 16 || SIZE == 4, "cp.async size");
  if constexpr (SIZE == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies of the A tile of one stage: rows m0 .. m0 + BM of x (M rows,
// `pitch` bytes apart), bytes kb0 .. kb0 + 128 of each; rows >= M and bytes
// >= kbytes are zero. Each thread copies one 16-byte chunk c of ITERS rows
// ROW_STEP apart; the addresses are worked out once, so a stage costs a
// few adds a copy. A 16-byte aligned x and pitch keep every copy aligned.
// PERM stores tile row 32 G + 4 g + j at smem row 32 G + 8 j + g: a weight
// tile whose rows are output columns then holds n-tile j's eight columns
// 4 g + j in smem rows 8 j .. 8 j + 7 (the column map of s8_mma.cuh).
template <int BM, int THREADS, bool PERM = false>
struct ATileLoader {
  static constexpr int ITERS = BM * 8 / THREADS;
  static constexpr int ROW_STEP = THREADS / 8;
  static_assert(BM * 8 % THREADS == 0 && ROW_STEP % 8 == 0, "A tile copies");
  const char* src;  // the thread's first row at its chunk, kb0 = 0
  size_t step;      // bytes between its rows
  int r, c16, dst, rows;  // its first row, chunk byte, smem offset, rows < M

  // smem byte offset of 16-byte chunk c of tile row row
  __device__ static int offset(int row, int c) {
    if constexpr (PERM)
      row = (row & ~31) | ((row & 3) << 3) | ((row >> 2) & 7);
    return row * kARow + ((c ^ (row & 7)) << 4);
  }

  __device__ ATileLoader(const void* x, size_t pitch, int M, int m0) {
    r = threadIdx.x >> 3;
    const int c = threadIdx.x & 7;
    c16 = 16 * c;
    dst = offset(r, c);
    rows = min(ITERS, max(0, (M - m0 - r + ROW_STEP - 1) / ROW_STEP));
    src = static_cast<const char*>(x) + (size_t)(m0 + r) * pitch + c16;
    step = (size_t)ROW_STEP * pitch;
  }

  __device__ __forceinline__ void load(char* tile, const void* x, int kbytes,
                                       int kb0) const {
    const int left = kbytes - kb0 - c16;
    const int bytes = left >= 16 ? 16 : max(left, 0);
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const bool ok = i < rows && bytes > 0;
      const int d = PERM ? offset(r + i * ROW_STEP, c16 >> 4)
                         : dst + i * ROW_STEP * kARow;
      cp_async<16>(tile + d, ok ? src + i * step + kb0 : x, ok ? bytes : 0);
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same with .trans: each lane gets the transposed 8 x 8 blocks, i.e.
// from row-major [k][n] bf16 rows the .col B fragments (k 2t, 2t+1 of
// column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The lane's ldmatrix.x4 offset in an A tile for the 16-row m-tile at
// tile rows r0 (a multiple of 8), k-step s (bytes 32 s .. 32 s + 32 of the
// stage's rows: 16 bf16 or 32 int8 k): lanes 0-15 address rows r0 + 0..15
// of chunk 2 s, lanes 16-31 the same rows of chunk 2 s + 1.
__device__ __forceinline__ uint32_t a_frag_offset(int r0, int s) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane & 15), c = 2 * s + (lane >> 4);
  return r * kARow + ((c ^ (lane & 7)) << 4);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two packed int4h bytes -> the two bf16x2 registers of a B fragment: bits
// 0-7 hold the pair (k, k+1) (low nibble k), bits 8-15 the pair (k+8,
// k+9); higher bits are ignored. A two's-complement nibble u becomes the
// bf16 0x4300 | (u ^ 8) = 128 + (u ^ 8) = 136 + nibble, and 136 is
// subtracted: exact, no int -> float conversion. The low nibbles (and the
// high ones) of both bytes are masked and flipped in one op, beside two
// 0x43 bytes, and two byte permutes pair each byte's nibbles.
__device__ __forceinline__ void nibbles_to_bf16x2(uint32_t two, uint32_t& b0,
                                                  uint32_t& b1) {
  const uint32_t lo = (two & 0x0F0Fu) ^ 0x43430808u;         // l0 l1 43 43
  const uint32_t hi = ((two >> 4) & 0x0F0Fu) ^ 0x43430808u;  // h0 h1 43 43
  uint32_t v0 = __byte_perm(lo, hi, 0x6420);  // (l0, 43, h0, 43)
  uint32_t v1 = __byte_perm(lo, hi, 0x7531);  // (l1, 43, h1, 43)
  const uint32_t k136 = 0x43084308u;          // bf16x2 (136, 136)
  const __nv_bfloat162 bias = *reinterpret_cast<const __nv_bfloat162*>(&k136);
  __nv_bfloat162 r0 =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v0), bias);
  __nv_bfloat162 r1 =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v1), bias);
  b0 = *reinterpret_cast<uint32_t*>(&r0);
  b1 = *reinterpret_cast<uint32_t*>(&r1);
}

// Eight f32 outputs of row `row`, columns col0 .. col0 + 8, rounded to bf16:
// one 16-byte store where the row is whole and aligned, else guarded
// element stores.
__device__ __forceinline__ void store_row8_bf16(__nv_bfloat16* out, int row,
                                                int col0, int N,
                                                const float (&v)[8]) {
  __nv_bfloat16* o = out + (size_t)row * N + col0;
  if ((N & 7) == 0 && col0 + 8 <= N) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(h);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col0 + i < N) o[i] = __float2bfloat16_rn(v[i]);
  }
}

// The same eight outputs in f32: two 16-byte stores where the row is whole
// and aligned, else guarded element stores.
__device__ __forceinline__ void store_row8_f32(float* out, int row, int col0,
                                               int N, const float (&v)[8]) {
  float* o = out + (size_t)row * N + col0;
  if ((N & 3) == 0 && col0 + 8 <= N) {
    reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col0 + i < N) o[i] = v[i];
  }
}

}  // namespace mmatile
