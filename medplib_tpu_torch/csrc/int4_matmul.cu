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
// Both scale layouts read as scale[g * N + n], g = k / (K / G). As the
// reference, the group scale multiplies the WEIGHT before the product:
//   w[k, n] = __fmul_rn(float(nibble), scale[g, n])      (f32)
//   out[m, n] = (x dtype)(sum_k float(x[m, k]) * w[k, n])  (f32, FMA)
// so only the order of the f32 sums differs from the reference (which,
// transposed, adds an even-column and an odd-column dot).
//
// What bounds it on the H100: on the packed int4h serving path prefill
// (M = 12 x 623 rows, K = 4096, N = 12288 / 22016) is compute bound and
// decode (M = 12) bound by the 0.5-byte weights on the tensor cores, by
// the FMA rate on the CUDA cores. This first version does f32 FMA from
// shared-memory tiles (TM x 64 outputs, 64 logical k per chunk, R x 4
// outputs per thread; the tile routines of matmul_tile.cuh). Nibbles are
// unpacked in registers from 16-byte loads of packed bytes (int4h_tile.cuh:
// sign-extending shifts of the 32-bit byte value) and scaled into the f32
// smem tile: the dequantized
// weight never exists in device memory. The transposed layout pairs the
// nibble planes with x's even / odd columns by writing each nibble at its
// logical k, so x is read once, in order, with no [2, M, K/2] copy. Ragged
// rows, columns and the last K chunk are zero-filled in smem; stores are
// guarded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4h_tile.cuh"
#include "matmul_tile.cuh"

namespace {

using namespace mtile;
using int4h::hi_nibble;
using int4h::lo_nibble;

// packed weight chunk (logical rows k0 .. k0 + 64, columns n0 .. n0 + 64)
// -> smem column-major [kTN cols][kKC k] of scaled f32 weights. 128
// threads each load 16 packed bytes (32 weights).
__device__ void load_w(const int8_t* __restrict__ p,
                       const float* __restrict__ scale, int K, int N,
                       int gsize, int n0, int k0, bool trans, Smem& sm) {
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
      const float s = ok ? scale[(size_t)((2 * (j0 + t)) / gsize) * N + n]
                         : 0.0f;
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
    const float* srow = scale + (size_t)((2 * r) / gsize) * N + n;
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

template <int XT, int TM>
__global__ void __launch_bounds__(kThreads)
int4h_matmul_kernel(const void* __restrict__ x, const int8_t* __restrict__ p,
                    const float* __restrict__ scale, void* __restrict__ out,
                    int M, int K, int N, int gsize, int trans) {
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
    load_x<XT, TM>(x, M, K, m0, k0, sm);
    load_w(p, scale, K, N, gsize, n0, k0, trans != 0, sm);
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
      if (n >= N) continue;
      const size_t o = (size_t)r * N + n;
      if constexpr (XT == kBF16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(acc[i][j]);
      else
        static_cast<float*>(out)[o] = acc[i][j];
    }
  }
}

template <int XT>
int launch(const void* x, const int8_t* p, const float* scale, void* out,
           int m, int k, int n, int gsize, int trans, cudaStream_t stream) {
  const int tm = m > 32 ? 64 : 16;
  dim3 grid((n + kTN - 1) / kTN, (m + tm - 1) / tm);
  if (tm == 64)
    int4h_matmul_kernel<XT, 64><<<grid, kThreads, 0, stream>>>(
        x, p, scale, out, m, k, n, gsize, trans);
  else
    int4h_matmul_kernel<XT, 16><<<grid, kThreads, 0, stream>>>(
        x, p, scale, out, m, k, n, gsize, trans);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m, k] of dtype xt (1 bf16, 2 f32); packed int8 [k/2, n] with scale f32
// [groups, 1, n], or (trans) [n, k/2] with scale [groups, n, 1]; out [m, n]
// of x's dtype. The caller checks shapes, dtypes, contiguity, 16-byte
// alignment, k % 32 == 0, n % 16 == 0 and an even k / groups. Returns the
// cudaError_t of the launch.
extern "C" int int4h_matmul_launch(const void* x, const void* packed,
                                   const void* scale, void* out, int m, int k,
                                   int n, int groups, int xt, int trans,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  const int gsize = k / groups;
  if (xt == kBF16)
    return launch<kBF16>(x, p, sc, out, m, k, n, gsize, trans, s);
  if (xt == kF32)
    return launch<kF32>(x, p, sc, out, m, k, n, gsize, trans, s);
  return (int)cudaErrorInvalidValue;
}
