// Tensor-core matmul of bf16 x against an int8 weight with per-channel f32
// scales, or against a bf16 weight: the kernel of K7 on bf16 x
// (int8_matmul.cu) and of K3's int8-w and bf16 modes (gmm.cu, grouped over
// experts). It is K9's design (int4_matmul.cu) with one scale group and a
// whole byte (or a bf16) per B element, built from mma_tile.cuh.
//
//   acc[m, n] = sum_k x[m, k] * w[k, n]   (mma.sync m16n8k16, f32 sums)
//   out[m, n] = acc[m, n] * scale[n]      (__fmul_rn; bf16 w: no scale)
//
// rounded once to the output (bf16, or f32 for K3's f32 outputs). An int8
// weight is exact in bf16 and a bf16 x times a bf16 weight is exact in f32,
// so against the plain versions (f32 sums of the same products, then the
// same scale product) only the order of the f32 sums differs.
//
// Grouped (K3): rows are group-aligned and tile_gid[m0 / bm] names the
// expert of a block's rows; the weight is offset by e K N and the scale by
// e N. BM divides bm.
//
// Memory: x tiles (ATileLoader) and weight tiles arrive by 16-byte
// cp.async in a ring of STAGES stages in dynamic shared memory; rows and
// columns past M, N, K are zero-filled. The weight tile of a stage (64 k):
//   int8 [K, N]  64 k rows of BN bytes, pitch BN + 16;
//   int8 [N, K]  BN rows of 64 bytes, pitch 80, weight row 32 w + 4 g + j
//                at smem row 32 w + 8 j + g;
//   bf16 [K, N]  64 k rows of 2 BN bytes, pitch 2 BN + 16;
//   bf16 [N, K]  BN rows of 128 bytes, chunk c of row r at c ^ ((r >> 2) & 7).
// Each layout keeps the words one fragment load reads in distinct banks.
// B fragments (lane = 4 g + t holds k 2t, 2t+1 and 2t+8, 2t+9 of column g)
// use K9's column map, n-tile j's column g = warp column 4 g + j:
//   int8 [K, N]: one 32-bit word of a k row holds the bytes of all four
//     n-tiles, so 4 LDS.32 a 16-deep step feed the 16 mma of a 64 x 32
//     warp tile;
//   int8 [N, K]: the pairs (2t, 2t+1) and (2t+8, 2t+9) are bytes 2 (t & 1)
//     and 2 (t & 1) + 1 of the words at 4 (t >> 1) and 8 + 4 (t >> 1) of
//     the step's 16 bytes of the column;
//   bf16 [K, N]: one 8-byte load of a k row holds the four n-tiles'
//     values, paired into registers by byte permutes;
//   bf16 [N, K]: ldmatrix.x4, one lane per (n-tile, column) row address.
// Each thread's outputs are the 8 neighbouring columns 8 t .. 8 t + 7 of
// its rows (one 16-byte bf16 store). Bytes become bf16 in registers (the
// decode below): the dequantized weight never exists in device or shared
// memory.
// Tiles, K9's: 64 x 128 outputs, 4 warps of 64 x 32; M <= 16 (K7 decode)
// or bm % 64 != 0 (K3 with small blocks): 16 x 64, 2 warps of 16 x 32.
// Stages, chosen on the card (PERF.md): 3 for int8 (three blocks share an
// SM; 6, K9's choice, ran slower at prefill and no faster at decode), 4
// for bf16 (two blocks). Blocks run kGroupM m-tiles at a time across the
// n-tiles, so the blocks in flight share x rows and weight columns in L2
// (a 7B gate-up weight, 90 MB of int8, does not fit; no grouping ran
// slower).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace w8mma {

// int8 -> bf16, exact for every byte (-128 included). bf16 keeps 8
// significant bits, so K9's nibble route (bf16 0x4300 | u = 128 + u) holds
// only for u < 128; a byte goes through f32:
//   u = byte ^ 0x80                 (kI8Flip on a whole word) = s + 128,
//                                   s the signed value, 0 <= u <= 255
//   __byte_perm(word, kI8Magic, kI8Sel | j)
//                                   f32 bits 0x4B0000uu (byte j) = 2^23 + u
//   f - kI8Bias                     (2^23 + u) - (2^23 + 128) = s, exact
//   __byte_perm(lo, hi, kI8Pack)    the high halves of two such f32 (their
//                                   low 16 bits are zero: |s| <= 128)
//                                   -> bf16x2, lo in the low half
// tests/test_torch_int8_decode.py reads these five constants from this
// file and checks the route bit for bit on all 256 bytes.
constexpr uint32_t kI8Flip = 0x80808080u;
constexpr uint32_t kI8Magic = 0x4B000000u;
constexpr uint32_t kI8Sel = 0x7650u;
constexpr float kI8Bias = 8388736.0f;
constexpr uint32_t kI8Pack = 0x7632u;

// byte (sel & 3) of a word already XOR-ed with kI8Flip -> its value
__device__ __forceinline__ float i8_f32(uint32_t flipped, uint32_t sel) {
  return __uint_as_float(__byte_perm(flipped, kI8Magic, sel)) - kI8Bias;
}

// two decoded values (k, k + 1) -> one bf16x2 B register
__device__ __forceinline__ uint32_t bf16x2_of(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), kI8Pack);
}

enum WType { kWI8 = 0, kWBF16 = 1 };

constexpr int kGroupM = 16;  // m-tiles a raster group sweeps together

// The weight tile of one stage (layouts at the top of this file).
template <int WT, bool TRANS, int BN>
struct BTile {
  static constexpr int ES = WT == kWI8 ? 1 : 2;  // bytes a weight
  static constexpr int ROWS = TRANS ? BN : mmatile::kBK;
  static constexpr int CPR = (TRANS ? mmatile::kBK : BN) * ES / 16;
  static constexpr bool SWIZZLE = WT == kWBF16 && TRANS;
  static constexpr int PITCH = CPR * 16 + (SWIZZLE ? 0 : 16);
  static constexpr int BYTES = ROWS * PITCH;

  // smem byte offset of 16-byte chunk c of tile row r
  __host__ __device__ static constexpr int offset(int r, int c) {
    return SWIZZLE ? r * PITCH + ((c ^ ((r >> 2) & 7)) << 4)
           : (WT == kWI8 && TRANS)
               ? ((r & ~31) | ((r & 3) << 3) | ((r >> 2) & 7)) * PITCH +
                     16 * c
               : r * PITCH + 16 * c;
  }
};

namespace {

// Copies of the weight tile of one stage (logical k0 .. k0 + 64, columns
// n0 .. n0 + BN). Each thread copies chunk c of ITERS rows ROW_STEP apart;
// K % 16 == 0 and N % 16 == 0 keep every chunk wholly in or out.
template <int WT, bool TRANS, int BN, int THREADS>
struct BLoader {
  using T = BTile<WT, TRANS, BN>;
  static constexpr int ITERS = T::ROWS * T::CPR / THREADS;
  static constexpr int ROW_STEP = THREADS / T::CPR;
  static_assert(T::ROWS * T::CPR % THREADS == 0 && THREADS % T::CPR == 0,
                "B copies");
  const char* src;  // the thread's first row at its chunk, k0 = 0
  size_t step;      // bytes between its rows
  int dst[ITERS];   // smem offsets of its copies
  int r0, c16;      // its first tile row, its chunk's byte offset
  int lim;  // TRANS: its rows < N; else 1 if its chunk lies below N

  __device__ BLoader(const char* w, int N, int K, int n0) {
    const int c = threadIdx.x % T::CPR;
    r0 = threadIdx.x / T::CPR;
    c16 = 16 * c;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) dst[i] = T::offset(r0 + i * ROW_STEP, c);
    if constexpr (TRANS) {
      src = w + (size_t)(n0 + r0) * K * T::ES + c16;
      step = (size_t)ROW_STEP * K * T::ES;
      lim = min(ITERS, max(0, (N - n0 - r0 + ROW_STEP - 1) / ROW_STEP));
    } else {
      src = w + ((size_t)r0 * N + n0) * T::ES + c16;
      step = (size_t)ROW_STEP * N * T::ES;
      lim = (n0 * T::ES + c16) < N * T::ES;
    }
  }

  __device__ __forceinline__ void load(char* tile, const char* w, int N,
                                       int K, int k0) const {
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      bool ok;
      const char* s;
      if constexpr (TRANS) {
        ok = i < lim && k0 * T::ES + c16 < K * T::ES;
        s = src + i * step + (size_t)k0 * T::ES;
      } else {
        ok = lim && k0 + r0 + i * ROW_STEP < K;
        s = src + i * step + (size_t)k0 * N * T::ES;
      }
      mmatile::cp_async<16>(tile + dst[i], ok ? s : w, ok ? 16 : 0);
    }
  }
};

__device__ __forceinline__ uint32_t lds32(const char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int BM, int BN, int WM, int STAGES, int WT, bool TRANS>
__global__ void __launch_bounds__((BM / WM) * (BN / 32) * 32)
w8_mma_kernel(const __nv_bfloat16* __restrict__ x,
              const void* __restrict__ weight,
              const float* __restrict__ scale,
              const int* __restrict__ tile_gid, void* __restrict__ out,
              int M, int N, int K, int bm, int out_f32) {
  using namespace mmatile;
  using BT = BTile<WT, TRANS, BN>;
  constexpr int WARPS_N = BN / 32;
  constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  constexpr int MT = WM / 16;
  constexpr int A_BYTES = BM * kARow;
  constexpr int STAGE = A_BYTES + BT::BYTES;
  constexpr int P = BT::PITCH;
  extern __shared__ __align__(16) char smem[];

  // kGroupM m-tiles at a time sweep the n-tiles
  const int tiles_n = (N + BN - 1) / BN, tiles_m = (M + BM - 1) / BM;
  const int per_group = kGroupM * tiles_n;
  const int first_m = blockIdx.x / per_group * kGroupM;
  const int gm = min(tiles_m - first_m, kGroupM);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gm) * BM, n0 = in_group / gm * BN;

  const char* w = static_cast<const char*>(weight);
  if (tile_gid) {
    const size_t e = tile_gid[m0 / bm];
    w += e * K * N * BT::ES;
    if (scale) scale += e * N;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int ktiles = (K + kBK - 1) / kBK;

  const ATileLoader<BM, THREADS> aload(x, 2 * (size_t)K, M, m0);
  const BLoader<WT, TRANS, BN, THREADS> bload(w, N, K, n0);
  auto load_stage = [&](int slot, int kt) {
    char* a = smem + slot * STAGE;
    aload.load(a, x, 2 * K, 2 * kt * kBK);
    bload.load(a + A_BYTES, w, N, K, kt * kBK);
  };
  uint32_t a_off[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) a_off[s] = a_frag_offset(wm0, s);
  const uint32_t smem0 = smem_u32(smem);

  // the lane's B offsets in a stage's weight tile, k-step 0
  int b_off[4] = {0, 0, 0, 0};
  if constexpr (WT == kWI8 && TRANS) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b_off[j] = BT::offset(wn0 + 4 * g + j, 0) + 4 * (t >> 1);
  } else if constexpr (TRANS) {
    // ldmatrix: lane 8 q + i addresses row (column) 4 i + j of n-tile
    // j = 2 h + (q >> 1), chunk 2 s + (q & 1)
    const int q = lane >> 3, i = lane & 7;
    b_off[0] = (wn0 + 4 * i + (q >> 1)) * P;
    b_off[1] = q & 1;
    b_off[2] = i;
  } else {
    b_off[0] = 2 * t * P + (wn0 + 4 * g) * BT::ES;  // k row 2t, column 4g
  }
  const uint32_t sel0 = kI8Sel | (2 * (t & 1)), sel1 = sel0 + 1;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

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
    const int slot = kt % STAGES;
    const uint32_t a = smem0 + slot * STAGE;
    const char* b = smem + slot * STAGE + A_BYTES;
    const int k0 = kt * kBK;
    // the fragments of k-step s: A by ldmatrix, the B words raw (int8: the
    // k rows 2t, 2t+1, 2t+8, 2t+9, or each n-tile's two words; bf16 [K,
    // N]: the four k rows' 8-byte loads; bf16 [N, K]: the B registers)
    auto load_frags = [&](int s, uint32_t (&af)[MT][4], uint32_t (&bw)[8]) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], a + a_off[s] + i * 16 * kARow);
      if constexpr (WT == kWI8 && TRANS) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const char* p = b + b_off[j] + 16 * s;
          bw[2 * j] = lds32(p);
          bw[2 * j + 1] = lds32(p + 8);
        }
      } else if constexpr (WT == kWI8) {
        const char* p = b + b_off[0] + 16 * s * P;
        bw[0] = lds32(p);
        bw[1] = lds32(p + P);
        bw[2] = lds32(p + 8 * P);
        bw[3] = lds32(p + 9 * P);
      } else if constexpr (TRANS) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t r[4];
          ldmatrix_x4(r, smem_u32(b) + b_off[0] + 2 * h * P +
                             (((2 * s + b_off[1]) ^ b_off[2]) << 4));
#pragma unroll
          for (int c = 0; c < 4; ++c) bw[4 * h + c] = r[c];
        }
      } else {
        const char* p = b + b_off[0] + 16 * s * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {  // k rows 2t, 2t+1, 2t+8, 2t+9
          const uint2 d = *reinterpret_cast<const uint2*>(
              p + (c < 2 ? c : c + 6) * P);
          bw[2 * c] = d.x;
          bw[2 * c + 1] = d.y;
        }
      }
    };
    // raw words -> the B registers of n-tiles 0..3
    auto decode = [&](const uint32_t (&bw)[8], uint32_t (&bf)[4][2]) {
      if constexpr (WT == kWI8 && TRANS) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t lo = bw[2 * j] ^ kI8Flip;
          const uint32_t hi = bw[2 * j + 1] ^ kI8Flip;
          bf[j][0] = bf16x2_of(i8_f32(lo, sel0), i8_f32(lo, sel1));
          bf[j][1] = bf16x2_of(i8_f32(hi, sel0), i8_f32(hi, sel1));
        }
      } else if constexpr (WT == kWI8) {
        uint32_t u[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) u[c] = bw[c] ^ kI8Flip;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t sel = kI8Sel | j;
          bf[j][0] = bf16x2_of(i8_f32(u[0], sel), i8_f32(u[1], sel));
          bf[j][1] = bf16x2_of(i8_f32(u[2], sel), i8_f32(u[3], sel));
        }
      } else if constexpr (TRANS) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bf[j][0] = bw[2 * j];
          bf[j][1] = bw[2 * j + 1];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = j >> 1;
          const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
          bf[j][0] = __byte_perm(bw[v], bw[2 + v], sel);
          bf[j][1] = __byte_perm(bw[4 + v], bw[6 + v], sel);
        }
      }
    };
    uint32_t afs[2][MT][4], bws[2][8];
    load_frags(0, afs[0], bws[0]);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (k0 + 16 * s >= K) break;
      if (s < 3) load_frags(s + 1, afs[(s + 1) & 1], bws[(s + 1) & 1]);
      uint32_t bf[4][2];
      decode(bws[s & 1], bf);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], afs[s & 1][i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // the thread's columns 8 t .. 8 t + 7 (c0 / c2 of n-tile j: 8 t + j;
  // c1 / c3: 8 t + 4 + j); N % 8 == 0 keeps them wholly in or out
  const int col0 = n0 + wn0 + 8 * t;
  if (col0 >= N) return;
  float sv[8];
  if (scale) {
    const float4 lo = *reinterpret_cast<const float4*>(scale + col0);
    const float4 hi = *reinterpret_cast<const float4*>(scale + col0 + 4);
    sv[0] = lo.x; sv[1] = lo.y; sv[2] = lo.z; sv[3] = lo.w;
    sv[4] = hi.x; sv[5] = hi.y; sv[6] = hi.z; sv[7] = hi.w;
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) sv[c] = 1.0f;  // x * 1 is exact
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm0 + 16 * i + g + 8 * h;
      if (row >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = __fmul_rn(acc[i][j][2 * h], sv[j]);
        v[4 + j] = __fmul_rn(acc[i][j][2 * h + 1], sv[4 + j]);
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

template <int BM, int BN, int WM, int WT, bool TRANS>
int launch_tile(const void* x, const void* w, const float* scale,
                const int* tile_gid, void* out, int m, int n, int k, int bm,
                int out_f32, cudaStream_t stream) {
  constexpr int STAGES = WT == kWI8 ? 3 : 4;
  constexpr int THREADS = (BM / WM) * (BN / 32) * 32;
  constexpr int SMEM =
      STAGES * (BM * mmatile::kARow + BTile<WT, TRANS, BN>::BYTES);
  static_assert(SMEM <= 227 * 1024, "shared memory");
  auto kern = w8_mma_kernel<BM, BN, WM, STAGES, WT, TRANS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  kern<<<tiles, THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, scale, tile_gid, out, m, n, k,
      bm, out_f32);
  return (int)cudaGetLastError();
}

// bf16 x [m, k] @ w -> out [m, n], bf16 (f32 when out_f32). w: int8 (WT
// kWI8, with scale f32 [n]) or bf16 (kWBF16, scale null), [k, n] or (trans)
// [n, k]; grouped when tile_gid is given: w [E, ...], scale [E, n], row
// block i of bm rows on expert tile_gid[i], bm % 16 == 0. The caller checks
// m > 0, k % 16 == 0, n % 16 == 0, contiguity and 16-byte aligned pointers.
// Returns the cudaError_t of the launch.
template <int WT>
int launch(const void* x, const void* w, const float* scale,
           const int* tile_gid, void* out, int m, int n, int k, int bm,
           int trans, int out_f32, cudaStream_t s) {
  const bool small = tile_gid ? bm % 64 != 0 : m <= 16;
  if (small)
    return trans ? launch_tile<16, 64, 16, WT, true>(x, w, scale, tile_gid,
                                                     out, m, n, k, bm,
                                                     out_f32, s)
                 : launch_tile<16, 64, 16, WT, false>(x, w, scale, tile_gid,
                                                      out, m, n, k, bm,
                                                      out_f32, s);
  return trans ? launch_tile<64, 128, 64, WT, true>(x, w, scale, tile_gid,
                                                    out, m, n, k, bm, out_f32,
                                                    s)
               : launch_tile<64, 128, 64, WT, false>(x, w, scale, tile_gid,
                                                     out, m, n, k, bm,
                                                     out_f32, s);
}

}  // namespace
}  // namespace w8mma
