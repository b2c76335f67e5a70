// Shared tile routine of the int4 "interleaved pairs" FMA / __dp4a kernels
// (moe_decode_int4h.cu in both modes, gmm_int4h.cu on bf16 x; gmm_int4h's
// A8 mode runs on the s8 tensor cores, s8_mma.cuh; int4_matmul.cu uses the
// nibble helpers).
//
// Weights are packed int8 [K/2, N] (one expert): logical reduction row 2r is
// the LOW nibble of packed row r, row 2r+1 its HIGH nibble, both
// sign-extended (medplib_tpu/utils/quantize.py:_quantize_kernel4h).
//
// tile_accum() accumulates a TM x 64 output tile over logical rows
// [k_begin, k_end) (multiples of 64) in chunks of 64 logical rows:
//   - the activation chunk [TM, 64] and the packed weight chunk [32, 64]
//     are staged in shared memory with 16-byte loads; nibbles are unpacked
//     once per chunk into a column-major [64 cols][64 k] tile;
//   - A8 mode: x is int8, products run on __dp4a (4 s8 x s8 MACs into s32,
//     exact);
//   - float mode: x is bf16, products are f32 FMAs (bf16 x int4 is exact in
//     f32), matching the reference's bf16-input / f32-accumulate dots.
// 256 threads: ty = tid / 16 owns rows ty + 16 i, tx = tid % 16 owns
// columns tx + 16 j, j < 4.
//
// This is the simple, correct first version: no tensor cores (mma / wgmma),
// no TMA, no multi-stage pipeline.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace int4h {

constexpr int kThreads = 256;
constexpr int kTN = 64;        // output columns per tile
constexpr int kKC = 64;        // logical reduction rows per chunk
constexpr int kPadW = 17;      // int32 words per smem row (A8), +1 pad
constexpr int kPadF = 65;      // floats per smem row (float mode), +1 pad

template <bool A8, int TM>
struct Acc {
  static constexpr int R = TM / 16;
  typename std::conditional<A8, int, float>::type v[R][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0;
  }
};

// Shared staging buffers, sized for the larger (float) mode and TM = 64.
struct Smem {
  float x[64 * kPadF];
  float w[kTN * kPadF];
};

// sign-extending nibble extraction from a sign-extended byte
__device__ __forceinline__ int lo_nibble(int b) {
  return (int)((unsigned)b << 28) >> 28;
}
__device__ __forceinline__ int hi_nibble(int b) {
  return (int)((unsigned)b << 24) >> 28;
}

// x: row-major activations (int8 when A8, bf16 otherwise), ldx elements per
// row, TM rows starting at the tile's first row. w: packed [K/2, N] of one
// expert. n0: first output column of the tile.
template <bool A8, int TM>
__device__ void tile_accum(const void* __restrict__ x, int ldx,
                           const int8_t* __restrict__ w, int N, int n0,
                           int k_begin, int k_end, Smem& sm,
                           Acc<A8, TM>& acc) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  for (int k0 = k_begin; k0 < k_end; k0 += kKC) {
    __syncthreads();  // previous chunk fully consumed
    // ---- activation chunk [TM, 64] -> smem
    if constexpr (A8) {
      int* xs = reinterpret_cast<int*>(sm.x);
      const int8_t* xp = static_cast<const int8_t*>(x);
      for (int v = tid; v < TM * 4; v += kThreads) {
        int row = v / 4, kq = v % 4;
        int4 d = *reinterpret_cast<const int4*>(
            xp + (size_t)row * ldx + k0 + kq * 16);
        int* dst = xs + row * kPadW + kq * 4;
        dst[0] = d.x; dst[1] = d.y; dst[2] = d.z; dst[3] = d.w;
      }
    } else {
      const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
      for (int v = tid; v < TM * 8; v += kThreads) {
        int row = v / 8, kq = v % 8;
        int4 d = *reinterpret_cast<const int4*>(
            xp + (size_t)row * ldx + k0 + kq * 8);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&d);
        float* dst = sm.x + row * kPadF + kq * 8;
#pragma unroll
        for (int t = 0; t < 8; ++t) dst[t] = __bfloat162float(e[t]);
      }
    }
    // ---- packed weight chunk [32, 64] -> unpacked column-major [64][64]
    if (tid < 128) {
      int pr = tid / 4, cq = tid % 4;
      int4 d = *reinterpret_cast<const int4*>(
          w + (size_t)(k0 / 2 + pr) * N + n0 + cq * 16);
      const int8_t* b = reinterpret_cast<const int8_t*>(&d);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        int c = cq * 16 + t;
        int byte = (int)b[t];
        int lo = lo_nibble(byte), hi = hi_nibble(byte);
        if constexpr (A8) {
          int8_t* ws = reinterpret_cast<int8_t*>(sm.w);
          ws[c * kPadW * 4 + 2 * pr] = (int8_t)lo;
          ws[c * kPadW * 4 + 2 * pr + 1] = (int8_t)hi;
        } else {
          sm.w[c * kPadF + 2 * pr] = (float)lo;
          sm.w[c * kPadF + 2 * pr + 1] = (float)hi;
        }
      }
    }
    __syncthreads();
    // ---- multiply-accumulate
    if constexpr (A8) {
      const int* xs = reinterpret_cast<const int*>(sm.x);
      const int* ws = reinterpret_cast<const int*>(sm.w);
#pragma unroll 4
      for (int k4 = 0; k4 < kKC / 4; ++k4) {
        int xa[Acc<A8, TM>::R], wb[4];
#pragma unroll
        for (int i = 0; i < Acc<A8, TM>::R; ++i)
          xa[i] = xs[(ty + 16 * i) * kPadW + k4];
#pragma unroll
        for (int j = 0; j < 4; ++j) wb[j] = ws[(tx + 16 * j) * kPadW + k4];
#pragma unroll
        for (int i = 0; i < Acc<A8, TM>::R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc.v[i][j] = __dp4a(xa[i], wb[j], (int)acc.v[i][j]);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        float xa[Acc<A8, TM>::R], wb[4];
#pragma unroll
        for (int i = 0; i < Acc<A8, TM>::R; ++i)
          xa[i] = sm.x[(ty + 16 * i) * kPadF + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) wb[j] = sm.w[(tx + 16 * j) * kPadF + k];
#pragma unroll
        for (int i = 0; i < Acc<A8, TM>::R; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc.v[i][j] = fmaf(xa[i], wb[j], (float)acc.v[i][j]);
      }
    }
  }
}

}  // namespace int4h
