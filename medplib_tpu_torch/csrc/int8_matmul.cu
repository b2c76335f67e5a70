// int8_matmul (K7) and w8a8_matmul (K8): matmuls against an int8 weight
// with per-output-channel f32 scales.
//
// Replaces the TPU kernels of medplib_tpu/ops/pallas/int8_matmul.py:
//   - K7, `_kernel` (int8_matmul / int8_matmul_t): weight-only.
//       acc[m, n] = sum_k x[m, k] * float(w[k, n])   (f32 sums)
//       out[m, n] = (out dtype)(acc * scale[n])
//     x is bf16 or f32; an int8 weight converts to either exactly, and a
//     bf16 x times an int8 weight is exact in f32, so only the order of the
//     f32 sums differs from the reference. bf16 x (the serving dtype) runs
//     on the tensor cores (int8w_mma.cuh); f32 x stays on f32 FMA here,
//     since a bf16 mma would round x.
//   - K8, `_w8a8_kernel` (w8a8_matmul / w8a8_matmul_t): x is already
//     quantized per row (int8 x_q, f32 a_scale, done outside as in the
//     reference); s8 mma.sync m16n8k32 into s32 sums (exact), then
//       out[m, n] = (out dtype)(__fmul_rn(__fmul_rn(float(acc), a_scale[m]),
//                                         w_scale[n]))
//     K8's own epilogue order ((acc * a_s) * w_s; K3's is the other way).
//     The kernel is s8_mma.cuh's.
// The weight is [K, N] (scale [1, N]) or transposed [N, K] (scale [N, 1]);
// both read as scale[n].
//
// What bounds it on the H100. K7 on the packed dense serving path: prefill
// (M = 16 x 623 rows, K = 4096, N = 12288 qkv / 22016 gate-up) does
// ~1-1.8 TFLOP per call against 50-90 MB of int8 weight: compute bound.
// Decode (M = 16) does 2 x 16 FLOP per weight byte: bound by the weight
// bytes on the tensor cores. K7 on bf16 x therefore runs bf16 mma.sync
// from a cp.async ring (int8w_mma.cuh: the int8 bytes decoded to bf16 in
// registers, exactly; the f32 sum scaled once). The FMA kernel below
// serves K7 on f32 x: TM x 64 output tiles (TM = 64 at prefill, 16 at
// decode), 64-deep K chunks, 16-byte global loads, R x 4 outputs per
// thread (matmul_tile.cuh), ragged rows, columns and the last K chunk
// zero-filled in shared memory. In neither kernel does the dequantized
// weight exist in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8w_mma.cuh"
#include "matmul_tile.cuh"
#include "s8_mma.cuh"

namespace {

using namespace mtile;

// ---- int8 weight chunk (reduction rows k0.., columns n0..) -> smem
// column-major [kTN cols][kKC k] as floats (exact int8 -> f32).
__device__ void load_w(const int8_t* __restrict__ w, int K, int N, int n0,
                       int k0, bool trans, Smem& sm) {
  const int tid = threadIdx.x;
  if (trans) {
    // w [N, K]: column n's reduction axis is contiguous; 4 threads read
    // one column's 64 bytes
    constexpr int PER_ROW = kKC / 16;
    for (int v = tid; v < kTN * PER_ROW; v += kThreads) {
      const int c = v / PER_ROW, kq = v % PER_ROW;
      const int n = n0 + c, k = k0 + kq * 16;
      int4 d = make_int4(0, 0, 0, 0);
      if (n < N && k < K)
        d = *reinterpret_cast<const int4*>(w + (size_t)n * K + k);
      const int8_t* b = reinterpret_cast<const int8_t*>(&d);
      float* dst = sm.w + c * kPadF + kq * 16;
#pragma unroll
      for (int t = 0; t < 16; ++t) dst[t] = (float)b[t];
    }
  } else {
    // w [K, N]: row k holds the columns contiguously; 4 threads read one
    // row's 64 bytes, transposed into smem
    constexpr int PER_ROW = kTN / 16;
    for (int v = tid; v < kKC * PER_ROW; v += kThreads) {
      const int r = v / PER_ROW, cq = v % PER_ROW;
      const int k = k0 + r, n = n0 + cq * 16;
      int4 d = make_int4(0, 0, 0, 0);
      if (k < K && n < N)
        d = *reinterpret_cast<const int4*>(w + (size_t)k * N + n);
      const int8_t* b = reinterpret_cast<const int8_t*>(&d);
#pragma unroll
      for (int t = 0; t < 16; ++t)
        sm.w[(cq * 16 + t) * kPadF + r] = (float)b[t];
    }
  }
}

// K7 on f32 x (f32 out).
template <int TM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale, float* __restrict__ out,
                   int M, int K, int N, int trans) {
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
    load_w(w, K, N, n0, k0, trans != 0, sm);
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
      if (n < N) out[(size_t)r * N + n] = __fmul_rn(acc[i][j], w_scale[n]);
    }
  }
}

int launch_f32(const void* x, const int8_t* w, const float* w_scale,
               void* out, int m, int k, int n, int trans,
               cudaStream_t stream) {
  // 16-row tiles for decode-sized M: the weight is streamed by more
  // column tiles instead of being padded to 64 rows
  const int tm = m > 32 ? 64 : 16;
  dim3 grid((n + kTN - 1) / kTN, (m + tm - 1) / tm);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (tm == 64)
    int8_matmul_kernel<64><<<grid, kThreads, 0, stream>>>(xf, w, w_scale, o,
                                                           m, k, n, trans);
  else
    int8_matmul_kernel<16><<<grid, kThreads, 0, stream>>>(xf, w, w_scale, o,
                                                           m, k, n, trans);
  return (int)cudaGetLastError();
}

}  // namespace

// K7. x [m, k] of dtype xt (1 bf16, 2 f32); w int8 [k, n] (or [n, k] when
// trans); scale f32 [n]; out [m, n] of x's dtype. The caller checks shapes,
// dtypes, contiguity, 16-byte alignment, k % 16 == 0 and n % 16 == 0.
// Returns the cudaError_t of the launch.
extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* scale, void* out, int m, int k,
                                  int n, int xt, int trans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  if (xt == kBF16)
    return w8mma::launch<w8mma::kWI8>(x, w, sp, nullptr, out, m, n, k, 0,
                                      trans, 0, s);
  if (xt == kF32)
    return launch_f32(x, wp, sp, out, m, k, n, trans, s);
  return (int)cudaErrorInvalidValue;
}

// K8. x_q int8 [m, k]; a_scale f32 [m]; w int8 [k, n] (or [n, k] when
// trans); w_scale f32 [n]; out [m, n], bf16 when out_t is 1, f32 when 2.
// Same caller checks as K7.
extern "C" int w8a8_matmul_launch(const void* x_q, const void* a_scale,
                                  const void* w, const void* w_scale,
                                  void* out, int m, int k, int n, int out_t,
                                  int trans, void* stream) {
  if (out_t != kBF16 && out_t != kF32) return (int)cudaErrorInvalidValue;
  return s8mma::launch<s8mma::kAsWs>(
      static_cast<const int8_t*>(x_q), static_cast<const int8_t*>(w),
      static_cast<const float*>(a_scale), static_cast<const float*>(w_scale),
      nullptr, 0, out, m, n, k, trans, out_t == kF32,
      static_cast<cudaStream_t>(stream));
}
