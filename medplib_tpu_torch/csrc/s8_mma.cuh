// Tensor-core s8 x s8 -> s32 matmul with the W8A8 epilogues: the kernel of
// K8 (int8_matmul.cu: w8a8_matmul / w8a8_matmul_t), of K3's W8A8 mode
// (gmm.cu, grouped over experts) and of K1's W4A8 mode (gmm_int4h.cu:
// int4h pairs widened to s8 in registers), built from mma_tile.cuh. K2's
// A8 kernels (moe_decode_int4h.cu) take its kPairs loader, widening,
// transpose and mma on their own 16-row tiles.
//
//   acc[m, n] = sum_k x_q[m, k] * w[k, n]       (mma.sync m16n8k32, s32)
//   K8 (kAsWs):   out = (out dtype)(__fmul_rn(__fmul_rn(float(acc),
//                                   a_scale[m]), w_scale[n]))
//   K3 (kWsAs):   out = (out dtype)(__fmul_rn(__fmul_rn(float(acc),
//                                   w_scale[n]), a_scale[m]))
//   K1 (kHalves): acc_lo / acc_hi over the first / second half of k (the
//                two scale groups), p = __fmul_rn(float(acc_lo), s0[n]),
//                out = (out dtype)(__fmul_rn(__fadd_rn(p,
//                          __fmul_rn(float(acc_hi), s1[n])), a_scale[m]))
//
// The s32 sums are exact, so the order of the sums is free and the result
// is bit-equal to the plain versions (exact integer sums, the same f32
// products and sum in the same order, one cast). The two product orders
// differ in the last bit on ordinary inputs: each caller keeps its
// reference's.
//
// Grouped (K3, K1): rows are group-aligned and tile_gid[m0 / bm] names the
// expert of a block's rows; the weight is offset by e K N bytes (pairs: e
// K/2 N), w_scale by e N (pairs: e 2 N, s1 = s0 + N). BM divides bm.
//
// Fragment layouts (PTX ISA, mma.m16n8k32 .s8), lane = 4 g + t:
//   A a0: row g, k 4t..4t+3; a1: row g+8; a2: row g, k 16+4t..16+4t+3;
//     a3: row g+8, k 16+4t..
//   B b0: k 4t..4t+3, column g; b1: k 16+4t..16+4t+3, column g
//   C c0 c1: row g, columns 2t, 2t+1; c2 c3: row g+8
// Byte i of a .b32 register holds the i-th of its four k.
//
// An s8 m16k32 A tile is 16 rows x 32 bytes, the byte geometry of the bf16
// m16k16 tile: mma_tile.cuh's ATileLoader (128 bytes = 128 k a row per
// stage, chunk c of row r at c ^ (r & 7)), a_frag_offset and ldmatrix.x4
// give the A registers unchanged, four 32-deep k-steps a stage.
//
// Column map (K7's, int8w_mma.cuh): n-tile j of a warp's 32 columns gives
// its B column g to warp column 4 g + j. Each thread's outputs are then the
// eight neighbouring columns 8 t .. 8 t + 7 of its rows (c0 / c2 of n-tile
// j: 8 t + j; c1 / c3: 8 t + 4 + j): one 16-byte bf16 store a row.
//
// B fragments per weight layout:
//   kNK, w [N, K] (transposed): a k row per output column, the .col operand
//     as it is. The stage's tile is a second A tile (ATileLoader<BN, ..,
//     PERM>) whose row 4 g + j lies at smem row 8 j + g, so a_frag_offset at
//     warp rows 16 h gives, by one ldmatrix.x4, {b0, b0, b1, b1} of n-tiles
//     2 h, 2 h + 1.
//   kKN, w [K, N]: a k row holds the columns. sm_90 has no byte ldmatrix
//     .trans, so lane (g, t) reads the 32-bit words of k rows 4t..4t+3 at
//     columns 4g..4g+3 and transposes the 4 x 4 bytes in registers
//     (transpose4x4: eight byte permutes give b0 of the four n-tiles; the k
//     rows 16 + 4t.. do the same for b1). The tile is 128 k rows of BN
//     bytes, chunk c of row r at c ^ (2 ((r >> 2) & 3)) (within the row's
//     chunks), so the four t of one load read four distinct pairs of
//     chunks: every word of a load phase in its own bank.
//   kPairs, packed int4h [K/2, N]: logical k row 2 r is the low nibble of
//     packed row r, 2 r + 1 its high nibble (utils/quantize.py). A stage's
//     128 k are 64 packed rows of BN bytes. b0's k rows 4t..4t+3 are the
//     low and high nibbles of packed rows 2t and 2t+1 (b1: 8+2t, 9+2t), so
//     a lane reads two words where kKN reads four, widens each word's
//     nibbles to two s8 words (widen_pairs) and transposes those four as
//     kKN does. widen_pairs keeps each nibble in the high half of its byte:
//     the s8 value is 16 x the nibble, exact for all 16 values in one AND
//     (high nibbles) or a shift and an AND (low), and the sums carry the
//     factor 16 (|sum| <= K/2 x 128 x 128 < 2^31 for K/2 <= 2^17), which the
//     epilogue removes by an exact shift. Chunk c of packed row r sits at
//     chunk address (r CPR + c) ^ (2 ((r >> 1) & 3)) (CPR = BN / 16): the
//     four t of one load (rows 2t + const) fall in four distinct chunk
//     pairs at BN = 128 and, at BN = 64, in two pairs of two rows' halves;
//     every word of a load phase in its own bank either way.
// tests/test_torch_s8_fragments.py and
// tests/test_torch_s8_int4h_fragments.py read the selectors and the nibble
// constants from this file and replay the loads, the widening and the
// transpose on the CPU against the m16n8k32 layout.
//
// What bounds it on the H100: at the dense W8A8 shapes (M = 16 x 623,
// K = 4096 / 11008, N = 12288 / 4096) ~1 TOP per call against 50-60 MB of
// operands; at the MoE prefill (K3: Sp = 5632, K1: Sp = 10752, K = 4096 /
// 11264) 0.5-1 TOP against 23-92 MB of expert weights: compute bound
// (0.25-0.51 ms at the 1,979 TOP/s s8 peak).
// Tiles, K9's: 64 x 128 outputs, 4 warps of 64 x 32 (16 mma a k-step, A
// fragments shared by 4 n-tiles, B by 4 m-tiles); M <= 16 (K8) or bm % 64
// != 0 (grouped): 16 x 64, 2 warps of 16 x 32. STAGES-deep cp.async ring
// (ragged rows, columns and the K tail zero-filled by the copies); blocks
// sweep kGroupM m-tiles at a time across the n-tiles so that the blocks in
// flight share x rows and weight columns in L2. K1 folds acc_lo into f32
// registers (p) at the first stage of the high half: K/2 % 128 == 0 puts
// every stage wholly in one group.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tile.cuh"

namespace s8mma {

constexpr int kStageK = 128;  // int8 k per pipeline stage (mma_tile's kARow)
constexpr int kGroupM = 16;  // m-tiles a raster group sweeps together

// transpose4x4 selectors (__byte_perm): kPairLo / kPairHi interleave bytes
// 0-1 / 2-3 of two k rows' words, kHalfLo / kHalfHi take the low / high
// byte pairs of two such results.
constexpr uint32_t kPairLo = 0x5140u;
constexpr uint32_t kPairHi = 0x7362u;
constexpr uint32_t kHalfLo = 0x5410u;
constexpr uint32_t kHalfHi = 0x7632u;

// widen_pairs: the high nibble of each byte, in place (16 x its value as
// an s8), and the low nibble shifted up into it.
constexpr uint32_t kNibMask = 0xF0F0F0F0u;
constexpr int kNibShift = 4;

enum Layout { kKN = 0, kNK = 1, kPairs = 2 };
enum Epilogue { kAsWs = 0, kWsAs = 1, kHalves = 2 };

// The words of four consecutive k rows (byte j = column 4 g + j) -> the B
// register of n-tiles 0..3 (byte i = k row i).
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1,
                                             uint32_t w2, uint32_t w3,
                                             uint32_t (&b)[4]) {
  const uint32_t x0 = __byte_perm(w0, w1, kPairLo);  // w0.0 w1.0 w0.1 w1.1
  const uint32_t x1 = __byte_perm(w0, w1, kPairHi);  // w0.2 w1.2 w0.3 w1.3
  const uint32_t y0 = __byte_perm(w2, w3, kPairLo);
  const uint32_t y1 = __byte_perm(w2, w3, kPairHi);
  b[0] = __byte_perm(x0, y0, kHalfLo);  // column byte 0 of rows 0..3
  b[1] = __byte_perm(x0, y0, kHalfHi);
  b[2] = __byte_perm(x1, y1, kHalfLo);
  b[3] = __byte_perm(x1, y1, kHalfHi);
}

// A word of a packed row (byte j: the pair of column 4 g + j) -> the s8
// words of its two logical k rows, each byte 16 x the nibble.
__device__ __forceinline__ void widen_pairs(uint32_t w, uint32_t& lo,
                                            uint32_t& hi) {
  lo = (w << kNibShift) & kNibMask;
  hi = w & kNibMask;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies of the row-major weight tile of one stage: ROWS rows (128 k rows
// of [K, N], or 64 packed rows of [K/2, N] when PAIRS) from row r0,
// columns n0 .. n0 + BN (BN bytes a row, chunks swizzled as above), with
// ATileLoader's interface (w with `pitch` = N bytes a row; load takes the
// row count and r0). Each thread copies chunk c of ITERS rows ROW_STEP
// apart (ROW_STEP % 16 == 0 keeps its swizzle); rows past the count are
// zero, and N % 16 == 0 keeps every chunk wholly in or out.
template <int BN, int THREADS, bool PAIRS>
struct KNLoader {
  static constexpr int ROWS = PAIRS ? kStageK / 2 : kStageK;
  static constexpr int CPR = BN / 16;
  static constexpr int ITERS = ROWS * CPR / THREADS;
  static constexpr int ROW_STEP = THREADS / CPR;
  static_assert(ROWS * CPR % THREADS == 0 && ROW_STEP % 16 == 0, "B copies");
  const char* src;  // the thread's first row at its chunk, r0 = 0
  size_t pitch;     // bytes between rows
  int r, dst, in_n;  // its first row, smem offset, chunk lies below N

  // smem byte offset of chunk c of tile row `row`
  __device__ static int offset(int row, int c) {
    if constexpr (PAIRS)
      return ((row * CPR + c) ^ (2 * ((row >> 1) & 3))) << 4;
    else
      return row * BN + ((c ^ ((2 * ((row >> 2) & 3)) & (CPR - 1))) << 4);
  }

  __device__ KNLoader(const void* w, size_t pitch_, int N, int n0) {
    pitch = pitch_;
    r = threadIdx.x / CPR;
    const int c = threadIdx.x % CPR;
    dst = offset(r, c);
    in_n = n0 + 16 * c < N;
    src = static_cast<const char*>(w) + r * pitch + n0 + 16 * c;
  }

  __device__ __forceinline__ void load(char* tile, const void* w, int rows,
                                       int r0) const {
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int k = r0 + r + i * ROW_STEP;
      const bool ok = in_n && k < rows;
      mmatile::cp_async<16>(tile + dst + i * ROW_STEP * BN,
                            ok ? src + (size_t)(k - r) * pitch : w,
                            ok ? 16 : 0);
    }
  }
};

// eight consecutive f32 of p (16-byte aligned), or ones where p is null
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  if (!p) {
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = 1.0f;  // x * 1 is exact
    return;
  }
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

template <int BM, int BN, int WM, int STAGES, int LAYOUT, int EPI>
__global__ void __launch_bounds__((BM / WM) * (BN / 32) * 32)
s8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ a_scale,
              const float* __restrict__ w_scale,
              const int* __restrict__ tile_gid, void* __restrict__ out,
              int M, int N, int K, int bm, int out_f32) {
  using namespace mmatile;
  constexpr bool PAIRS = LAYOUT == kPairs;
  static_assert(PAIRS == (EPI == kHalves), "the pairs take K1's epilogue");
  constexpr int WARPS_N = BN / 32;
  constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  constexpr int MT = WM / 16;
  constexpr int A_BYTES = BM * kARow;
  constexpr int B_ROWS = PAIRS ? kStageK / 2 : kStageK;
  constexpr int STAGE = A_BYTES + BN * B_ROWS;
  extern __shared__ __align__(16) char smem[];

  // kGroupM m-tiles at a time sweep the n-tiles
  const int tiles_n = (N + BN - 1) / BN, tiles_m = (M + BM - 1) / BM;
  const int per_group = kGroupM * tiles_n;
  const int first_m = blockIdx.x / per_group * kGroupM;
  const int gm = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gm) * BM, n0 = in_group / gm * BN;

  if (tile_gid) {
    const size_t e = tile_gid[m0 / bm];
    w += e * (PAIRS ? K / 2 : K) * (size_t)N;
    if (w_scale) w_scale += e * (PAIRS ? 2 : 1) * (size_t)N;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int ktiles = (K + kStageK - 1) / kStageK;
  // the thread's columns 8 t .. 8 t + 7; N % 8 == 0 keeps them wholly in
  // or out
  const int col0 = n0 + wn0 + 8 * t;

  // [N, K]: a second A tile (k bytes a row), rows permuted to the column
  // map; [K, N] / pairs: rows of N bytes
  using BLoad = typename std::conditional<LAYOUT == kNK,
      ATileLoader<BN, THREADS, true>, KNLoader<BN, THREADS, PAIRS>>::type;
  const ATileLoader<BM, THREADS> aload(x, K, M, m0);
  const BLoad bload(w, LAYOUT == kNK ? K : N, N, n0);
  auto load_stage = [&](int slot, int kt) {
    char* a = smem + slot * STAGE;
    aload.load(a, x, K, kt * kStageK);
    bload.load(a + A_BYTES, w, PAIRS ? K / 2 : K, kt * B_ROWS);
  };
  uint32_t a_off[4], b_off[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a_off[s] = a_frag_offset(wm0, s);
    // [N, K]: n-tiles 0, 1 at smem rows wn0 + 0..15 (h = 0); [K, N]: the
    // lane's word of k row 32 s + 4 t at columns wn0 + 4 g; pairs: of
    // packed rows 2 t (s = 0) and 2 t + 1 (s = 1), k-step 0
    if constexpr (LAYOUT == kNK)
      b_off[s] = a_frag_offset(wn0, s);
    else if constexpr (LAYOUT == kKN)
      b_off[s] = BLoad::offset(32 * s + 4 * t, (wn0 + 4 * g) >> 4) +
                 4 * (g & 3);
    else
      b_off[s] = s < 2 ? BLoad::offset(2 * t + s, (wn0 + 4 * g) >> 4) +
                             4 * (g & 3)
                       : 0;
  }
  const uint32_t smem0 = smem_u32(smem);

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
  // K1: acc_lo * s0, folded at the first stage of the high half
  [[maybe_unused]] float p[PAIRS ? MT : 1][4][4];

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; the slot refilled below is free
    {
      const int nk = kt + STAGES - 1;
      if (nk < ktiles) load_stage(nk % STAGES, nk);
      cp_async_commit();
    }
    if constexpr (PAIRS) {
      if (kt == K / (2 * kStageK)) {
        float s0[8];
        load8(w_scale && col0 < N ? w_scale + col0 : nullptr, s0);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              p[i][j][c] = __fmul_rn(
                  __int2float_rn(acc[i][j][c] >> kNibShift),
                  s0[(c & 1) * 4 + j]);
              acc[i][j][c] = 0;
            }
      }
    }
    const int slot = kt % STAGES;
    const uint32_t a = smem0 + slot * STAGE;
    const char* b = smem + slot * STAGE + A_BYTES;
    const int k0 = kt * kStageK;
    // k-step s: A by ldmatrix; B by ldmatrix ([N, K]), the raw words of k
    // rows 4t..4t+3 and 16 + 4t.. ([K, N]) or of packed rows 2t, 2t+1,
    // 8 + 2t, 9 + 2t (pairs)
    auto load_frags = [&](int s, uint32_t (&af)[MT][4], uint32_t (&bw)[8]) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], a + a_off[s] + i * 16 * kARow);
      if constexpr (LAYOUT == kNK) {
        uint32_t r[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          ldmatrix_x4(r, smem_u32(b) + b_off[s] + 16 * h * kARow);
          bw[4 * h] = r[0];      // b0, n-tile 2h
          bw[4 * h + 1] = r[2];  // b1, n-tile 2h
          bw[4 * h + 2] = r[1];  // b0, n-tile 2h + 1
          bw[4 * h + 3] = r[3];  // b1, n-tile 2h + 1
        }
      } else if constexpr (LAYOUT == kKN) {
        const char* q = b + b_off[s];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          bw[c] = *reinterpret_cast<const uint32_t*>(q + c * BN);
          bw[4 + c] = *reinterpret_cast<const uint32_t*>(q + (16 + c) * BN);
        }
      } else {
        const char* q = b + 16 * s * BN;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bw[2 * h] = *reinterpret_cast<const uint32_t*>(q + b_off[0] +
                                                         8 * h * BN);
          bw[2 * h + 1] = *reinterpret_cast<const uint32_t*>(q + b_off[1] +
                                                             8 * h * BN);
        }
      }
    };
    // raw words -> the B registers (b0, b1) of n-tiles 0..3
    auto decode = [&](const uint32_t (&bw)[8], uint32_t (&bf)[4][2]) {
      if constexpr (LAYOUT == kNK) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bf[j][0] = bw[2 * j];
          bf[j][1] = bw[2 * j + 1];
        }
      } else {
        uint32_t lo[4], hi[4];
        if constexpr (PAIRS) {
          uint32_t r[8];  // k rows 4t .. 4t + 3, then 16 + 4t ..
#pragma unroll
          for (int c = 0; c < 4; ++c)
            widen_pairs(bw[c], r[2 * c], r[2 * c + 1]);
          transpose4x4(r[0], r[1], r[2], r[3], lo);
          transpose4x4(r[4], r[5], r[6], r[7], hi);
        } else {
          transpose4x4(bw[0], bw[1], bw[2], bw[3], lo);
          transpose4x4(bw[4], bw[5], bw[6], bw[7], hi);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bf[j][0] = lo[j];
          bf[j][1] = hi[j];
        }
      }
    };
    uint32_t afs[2][MT][4], bws[2][8];
    load_frags(0, afs[0], bws[0]);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (k0 + 32 * s >= K) break;
      if (s < 3) load_frags(s + 1, afs[(s + 1) & 1], bws[(s + 1) & 1]);
      uint32_t bf[4][2];
      decode(bws[s & 1], bf);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], afs[s & 1][i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  if (col0 >= N) return;
  float ws[8];  // K1: s1
  load8(w_scale ? w_scale + (PAIRS ? N : 0) + col0 : nullptr, ws);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm0 + 16 * i + g + 8 * h;
      if (row >= M) continue;
      const float as = a_scale ? a_scale[row] : 1.0f;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {  // c0 / c2: 8t + j; c1 / c3: 8t + 4 + j
          const int c = 2 * h + u, o = 4 * u + j;
          if constexpr (EPI == kAsWs)
            v[o] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][c]), as),
                             ws[o]);
          else if constexpr (EPI == kWsAs)
            v[o] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][c]), ws[o]),
                             as);
          else
            v[o] = __fmul_rn(
                __fadd_rn(p[i][j][c],
                          __fmul_rn(__int2float_rn(acc[i][j][c] >> kNibShift),
                                    ws[o])),
                as);
        }
      if (out_f32) {
        float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) +
                                              (size_t)row * N + col0);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        store_row8_bf16(static_cast<__nv_bfloat16*>(out), row, col0, N, v);
      }
    }
}

template <int BM, int BN, int WM, int LAYOUT, int EPI>
int launch_tile(const int8_t* x, const int8_t* w, const float* a_scale,
                const float* w_scale, const int* tile_gid, int bm, void* out,
                int m, int n, int k, int out_f32, cudaStream_t stream) {
  constexpr int STAGES = 4;
  constexpr int THREADS = (BM / WM) * (BN / 32) * 32;
  constexpr int SMEM =
      STAGES * (BM * mmatile::kARow +
                BN * (LAYOUT == kPairs ? kStageK / 2 : kStageK));
  static_assert(SMEM <= 227 * 1024, "shared memory");
  auto kern = s8_mma_kernel<BM, BN, WM, STAGES, LAYOUT, EPI>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  kern<<<tiles, THREADS, SMEM, stream>>>(x, w, a_scale, w_scale, tile_gid,
                                         out, m, n, k, bm, out_f32);
  return (int)cudaGetLastError();
}

// x_q int8 [m, k] @ w -> out [m, n], bf16 (f32 when out_f32), with a_scale
// f32 [m] and w_scale f32 [n], either null for ones. EPI kAsWs (K8) /
// kWsAs (K3): w int8 [k, n], or [n, k] when trans. kHalves (K1): w the
// int4h pairs [k/2, n], w_scale [2, n] (s0, s1), k/2 % 128 == 0.
// Grouped when tile_gid is given: w [E, ...], w_scale [E, ...], row block
// i of bm rows on expert tile_gid[i], bm % 16 == 0, m % bm == 0. The
// caller checks m > 0, k % 16 == 0, n % 16 == 0, contiguity and 16-byte
// aligned pointers. Returns the cudaError_t of the launch.
template <int EPI>
int launch(const int8_t* x, const int8_t* w, const float* a_scale,
           const float* w_scale, const int* tile_gid, int bm, void* out,
           int m, int n, int k, int trans, int out_f32, cudaStream_t s) {
  const bool small = tile_gid ? bm % 64 != 0 : m <= 16;
  if constexpr (EPI == kHalves) {
    return small ? launch_tile<16, 64, 16, kPairs, EPI>(
                       x, w, a_scale, w_scale, tile_gid, bm, out, m, n, k,
                       out_f32, s)
                 : launch_tile<64, 128, 64, kPairs, EPI>(
                       x, w, a_scale, w_scale, tile_gid, bm, out, m, n, k,
                       out_f32, s);
  } else {
    if (small)
      return trans ? launch_tile<16, 64, 16, kNK, EPI>(
                         x, w, a_scale, w_scale, tile_gid, bm, out, m, n, k,
                         out_f32, s)
                   : launch_tile<16, 64, 16, kKN, EPI>(
                         x, w, a_scale, w_scale, tile_gid, bm, out, m, n, k,
                         out_f32, s);
    return trans ? launch_tile<64, 128, 64, kNK, EPI>(
                       x, w, a_scale, w_scale, tile_gid, bm, out, m, n, k,
                       out_f32, s)
                 : launch_tile<64, 128, 64, kKN, EPI>(
                       x, w, a_scale, w_scale, tile_gid, bm, out, m, n, k,
                       out_f32, s);
  }
}

}  // namespace s8mma
