// int4h_matmul (K9): x @ dequant(int4 "interleaved pairs" weight) with G
// contiguous scale groups along the reduction axis.
//
// Replaces the TPU kernels of medplib_tpu/ops/pallas/int4_matmul.py
// (`_kernel` for int4h_matmul_pallas, `_kernel_t` for
// int4h_matmul_t_pallas). Logical reduction row 2r of the weight is the
// LOW nibble of packed row r, row 2r+1 its HIGH nibble, both sign-extended
// (utils/quantize._quantize_kernel4h):
//   - normal:     packed [K/2, N], scale [G, 1, N]; packed row r holds
//                 logical rows 2r, 2r+1 of every column;
//   - transposed: packed [N, K/2], scale [G, N, 1]; packed column j of
//                 row n holds logical k = 2j, 2j+1 of column n.
// Both scale layouts read as scale[g * N + n], g = k / gsize.
//
// What bounds it on the H100. On the packed int4h serving path, prefill
// (M = 12 x 623 rows, K = 4096, N = 12288 qkv / 22016 gate-up) does
// 0.75-1.35 TFLOP per call: compute bound, 0.76-1.36 ms at the bf16
// tensor-core peak. Decode (M = 12) reads 0.5 byte per weight for 24
// FLOP: bound by the weight bytes (8-14 us). The first version of this
// kernel ran f32 FMA on the CUDA cores (~27 TFLOP/s, 30x a cuBLAS bf16
// call); this one runs on the tensor cores.
//
// bf16 x (the serving dtype): the tensor-core kernel int4h_mma_kernel of
//   int4h_mma.cuh (bf16 mma.sync m16n8k16, nibbles decoded to bf16x2 in
//   registers, f32 group sums folded by fmaf into an f32 total, one bf16
//   cast): 64 x 128 tiles at prefill, 16 x 64 at M <= 16, 6 stages.
// f32 x: the first version's f32-FMA kernel (matmul_tile.cuh), as the
//   reference: w = __fmul_rn(nibble, scale) before an f32 dot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4h_mma.cuh"
#include "matmul_tile.cuh"

namespace {

using namespace i4mma;

template <bool TRANS, int WV>
int launch_bf16(const __nv_bfloat16* x, const int8_t* p, const float* scale,
                __nv_bfloat16* out, int m, int n, int k, int lda, int wpitch,
                int groups, int gsize, cudaStream_t s) {
  if (m <= 16)
    return launch_mma<16, 64, 16, 6, TRANS, WV>(x, p, scale, out, m, n, k,
                                                lda, wpitch, groups, gsize, s);
  return launch_mma<64, 128, 64, 6, TRANS, WV>(x, p, scale, out, m, n, k,
                                               lda, wpitch, groups, gsize, s);
}

// ---------------------------------------------------------------------------
// f32 x: f32 FMA on the CUDA cores
// ---------------------------------------------------------------------------

using namespace mtile;

// packed weight chunk (logical rows k0 .. k0 + 64, columns n0 .. n0 + 64)
// -> smem column-major [kTN cols][kKC k] of scaled f32 weights. 128
// threads each load 16 packed bytes (32 weights). Logical rows past the
// groups (zero padding) take the last group's scale.
__device__ void load_w(const int8_t* __restrict__ p,
                       const float* __restrict__ scale, int K, int N,
                       int groups, int gsize, int n0, int k0, bool trans,
                       Smem& sm) {
  const int tid = threadIdx.x;
  if (tid >= 128) return;
  const int k2 = K / 2;
  if (trans) {
    // packed [N, K/2]: 2 threads per column, 16 bytes = 32 logical k each
    const int c = tid / 2, h = tid % 2;
    const int n = n0 + c, j0 = k0 / 2 + h * 16;
    int4 d = make_int4(0, 0, 0, 0);
    const bool ok = n < N && j0 < k2;
    if (ok) d = *reinterpret_cast<const int4*>(p + (size_t)n * k2 + j0);
    const int8_t* b = reinterpret_cast<const int8_t*>(&d);
    float* dst = sm.w + c * kPadF + h * 32;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int byte = (int)b[t];
      // logical k = 2 (j0 + t) and its odd neighbour share a group
      const int gg = min((2 * (j0 + t)) / gsize, groups - 1);
      const float s = ok ? scale[(size_t)gg * N + n] : 0.0f;
      dst[2 * t] = __fmul_rn((float)lo_nibble(byte), s);
      dst[2 * t + 1] = __fmul_rn((float)hi_nibble(byte), s);
    }
  } else {
    // packed [K/2, N]: 4 threads per packed row (64 columns), 32 rows
    const int pr = tid / 4, cq = tid % 4;
    const int r = k0 / 2 + pr, n = n0 + cq * 16;
    int4 d = make_int4(0, 0, 0, 0);
    const bool ok = r < k2 && n < N;
    if (ok) d = *reinterpret_cast<const int4*>(p + (size_t)r * N + n);
    const int8_t* b = reinterpret_cast<const int8_t*>(&d);
    const int gg = min((2 * r) / gsize, groups - 1);
    const float* srow = scale + (size_t)gg * N + n;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int byte = (int)b[t];
      const float s = ok ? srow[t] : 0.0f;
      float* dst = sm.w + (cq * 16 + t) * kPadF + 2 * pr;
      dst[0] = __fmul_rn((float)lo_nibble(byte), s);
      dst[1] = __fmul_rn((float)hi_nibble(byte), s);
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
int4h_matmul_f32_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ p,
                        const float* __restrict__ scale,
                        float* __restrict__ out, int M, int K, int N,
                        int groups, int gsize, int trans) {
  constexpr int R = TM / 16;
  __shared__ Smem sm;
  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * TM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();  // previous chunk fully consumed
    load_x<TM>(x, M, K, m0, k0, sm);
    load_w(p, scale, K, N, groups, gsize, n0, k0, trans != 0, sm);
    __syncthreads();
    mac_chunk<R>(sm, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)r * N + n] = acc[i][j];
    }
  }
}

int launch_f32(const float* x, const int8_t* p, const float* scale,
               float* out, int m, int k, int n, int groups, int gsize,
               int trans, cudaStream_t stream) {
  const int tm = m > 32 ? 64 : 16;
  dim3 grid((n + kTN - 1) / kTN, (m + tm - 1) / tm);
  if (tm == 64)
    int4h_matmul_f32_kernel<64><<<grid, kThreads, 0, stream>>>(
        x, p, scale, out, m, k, n, groups, gsize, trans);
  else
    int4h_matmul_f32_kernel<16><<<grid, kThreads, 0, stream>>>(
        x, p, scale, out, m, k, n, groups, gsize, trans);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m, lda] of dtype xt (1 bf16, 2 f32) holding k logical columns; out
// [m, n] of x's dtype; logical row k of the weight is in scale group
// min(k / gsize, groups - 1); scale f32 [groups, 1, n] / [groups, n, 1].
//   bf16: packed [k/2, n] (pitch wpitch >= n bytes) or (trans) [n, k/2]
//     (pitch wpitch >= k/2); any m, n and even k = groups * gsize; the
//     caller checks lda % 8 == 0, wpitch % 4 == 0 and 16-byte aligned
//     pointers (wpitch % 16 == 0 -> 16-byte weight copies, else 4).
//   f32: lda == k, wpitch == n (normal) or k / 2 (trans), k % 32 == 0,
//     n % 16 == 0 (the caller zero-pads; gsize stays the unpadded K / G).
// Returns the cudaError_t of the launch.
extern "C" int int4h_matmul_launch(const void* x, const void* packed,
                                   const void* scale, void* out, int m,
                                   int n, int k, int lda, int wpitch,
                                   int groups, int gsize, int xt, int trans,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  if (xt == kF32)
    return launch_f32(static_cast<const float*>(x), p, sc,
                      static_cast<float*>(out), m, k, n, groups, gsize,
                      trans, s);
  if (xt != kBF16) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  const bool v16 = wpitch % 16 == 0;
  if (trans)
    return v16 ? launch_bf16<true, 16>(xb, p, sc, ob, m, n, k, lda, wpitch,
                                       groups, gsize, s)
               : launch_bf16<true, 4>(xb, p, sc, ob, m, n, k, lda, wpitch,
                                      groups, gsize, s);
  return v16 ? launch_bf16<false, 16>(xb, p, sc, ob, m, n, k, lda, wpitch,
                                      groups, gsize, s)
             : launch_bf16<false, 4>(xb, p, sc, ob, m, n, k, lda, wpitch,
                                     groups, gsize, s);
}
