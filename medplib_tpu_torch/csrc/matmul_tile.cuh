// Shared tile routines of the dense matmul kernels on the CUDA cores
// (int8_matmul.cu: K7 on f32 x; int4_matmul.cu: K9 on f32 x, with the
// int4h nibble helpers). K7 and K9 on bf16 x run on the tensor cores
// (int8w_mma.cuh, int4h_mma.cuh), and so does K8 (s8_mma.cuh).
//
// A block of 256 threads computes a TM x 64 output tile (TM = 64 or 16)
// over 64-deep reduction chunks staged in shared memory: the activation
// chunk [TM][64] row-major, the weight chunk column-major [64 cols][64 k]
// (each kernel has its own weight loader). Thread ty = tid / 16 owns rows
// ty + 16 i (i < TM / 16), tx = tid % 16 owns columns tx + 16 j (j < 4).
// Float tiles have a row pitch of 65 (the +1 pad keeps the column reads of
// the MAC loop off one bank).
//
// This is the simple, correct first version: no tensor cores (mma /
// wgmma), no TMA, no multi-stage pipeline.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mtile {

constexpr int kThreads = 256;
constexpr int kTN = 64;    // output columns per tile
constexpr int kKC = 64;    // reduction depth per chunk
constexpr int kPadF = 65;  // floats per smem row (float tiles), +1 pad

enum DType { kI8 = 0, kBF16 = 1, kF32 = 2 };

struct Smem {
  float x[64 * kPadF];
  float w[kTN * kPadF];
};

// sign-extending nibble extraction from a sign-extended packed int4h byte
__device__ __forceinline__ int lo_nibble(int b) {
  return (int)((unsigned)b << 28) >> 28;
}
__device__ __forceinline__ int hi_nibble(int b) {
  return (int)((unsigned)b << 24) >> 28;
}

// Activation chunk [TM, kKC] of rows m0.., columns k0.. (x row-major f32
// [M, K]) -> smem floats. Rows >= M and columns >= K are zero; K % 16 == 0
// keeps every 16-byte vector wholly in or out.
template <int TM>
__device__ void load_x(const float* __restrict__ x, int M, int K, int m0,
                       int k0, Smem& sm) {
  constexpr int PER_ROW = kKC / 4;
  for (int v = threadIdx.x; v < TM * PER_ROW; v += kThreads) {
    const int row = v / PER_ROW, kq = v % PER_ROW, k = k0 + kq * 4;
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + row < M && k < K)
      d = *reinterpret_cast<const float4*>(x + (size_t)(m0 + row) * K + k);
    float* dst = sm.x + row * kPadF + kq * 4;
    dst[0] = d.x; dst[1] = d.y; dst[2] = d.z; dst[3] = d.w;
  }
}

// One staged chunk into the thread's R x 4 accumulators: f32 FMA over
// float tiles.
template <int R>
__device__ __forceinline__ void mac_chunk(const Smem& sm, int ty, int tx,
                                          float (&acc)[R][4]) {
#pragma unroll 4
  for (int k = 0; k < kKC; ++k) {
    float xa[R], wb[4];
#pragma unroll
    for (int i = 0; i < R; ++i) xa[i] = sm.x[(ty + 16 * i) * kPadF + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) wb[j] = sm.w[(tx + 16 * j) * kPadF + k];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
  }
}

}  // namespace mtile
