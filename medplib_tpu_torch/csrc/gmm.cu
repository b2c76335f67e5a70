// gmm: grouped matmul over group-aligned rows (int8, bf16 or f32 experts).
//
// Replaces the TPU kernel medplib_tpu/ops/pallas/gmm.py:gmm (_kernel).
// Rows of x are group-aligned: every m-tile of `bm` rows belongs to one
// expert, tile_gid[i] names it (gap tiles of the two-ended E = 2 layout
// carry a valid id and zero rows). For each row r of tile i and column n,
// with g = tile_gid[r / bm]:
//   acc[r, n] = sum_k x[r, k] * w[g, k, n]        (w[g, n, k] if transposed)
//   out[r, n] = acc * w_scale[g, 0, n] (int8 w) * a_scale[r] (int8 x)
//
// Modes, as the Pallas kernel's `_kernel`:
//   - W8A8: x int8, w int8; s32 sums (exact); the epilogue converts the sum
//     to f32 and multiplies by w_scale, then by a_scale, each product
//     rounded (__fmul_rn), in the reference's order.
//   - int8-w: x bf16 (the wrapper rounds f32 x to bf16 first, as the
//     reference casts both operands to bf16), w int8; f32 sums of exact
//     products, scaled by w_scale at the epilogue.
//   - float: x and w bf16 or f32; f32 sums; no scale.
//   - transposed: w [E, N, K] contracted on its last axis; w_scale stays
//     channel-last [E, 1, N].
//
// What bounds it on the H100: at the int8 flagship prefill (Sp = 5632
// rows, K = 4096 / N = 11264 and K = 11264 / N = 4096) one call does
// ~0.26 T MACs against ~92 MB of int8 weights, at the ICL prefill (Sp =
// 7680) ~0.35 T: compute bound (thousands of operations per byte). So the
// modes run on the tensor cores from a cp.async ring, a block reading its
// expert from tile_gid: W8A8 on s8 mma.sync m16n8k32 (s8_mma.cuh, exact
// s32 sums, bit-equal to the plain version), the bf16-x modes (int8-w,
// bf16 w) on bf16 mma.sync (int8w_mma.cuh). The kernel below keeps the f32
// pairs, which the bf16 tensor cores cannot take exactly, on f32 FMA from
// shared-memory tiles (TM x 64 output tile, 64-deep K chunks, 4 x 4
// outputs per thread). Ragged K chunks and column tiles are zero-filled in
// shared memory and the stores are guarded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8w_mma.cuh"
#include "s8_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 64;    // output columns per tile
constexpr int kKC = 64;    // reduction depth per chunk
constexpr int kPadF = 65;  // floats per smem row, +1 pad

enum DType { kI8 = 0, kBF16 = 1, kF32 = 2 };

template <int T>
struct Elem;
template <>
struct Elem<kBF16> {
  using type = __nv_bfloat16;
  static constexpr int kVec = 8;  // elements per 16-byte load
};
template <>
struct Elem<kF32> {
  using type = float;
  static constexpr int kVec = 4;
};

struct Smem {
  float x[64 * kPadF];
  float w[kTN * kPadF];
};

template <int T>
__device__ __forceinline__ float to_f32(typename Elem<T>::type v) {
  if constexpr (T == kBF16)
    return __bfloat162float(v);
  else
    return v;
}

// One 16-byte vector of a T-typed row: the values as floats, zero where
// `ok` is false.
template <int T>
__device__ __forceinline__ void load_vec(const void* p, bool ok,
                                         float (&out)[Elem<T>::kVec]) {
  int4 d = make_int4(0, 0, 0, 0);
  if (ok) d = *reinterpret_cast<const int4*>(p);
  const typename Elem<T>::type* e =
      reinterpret_cast<const typename Elem<T>::type*>(&d);
#pragma unroll
  for (int t = 0; t < Elem<T>::kVec; ++t) out[t] = to_f32<T>(e[t]);
}

// ---- activation chunk [TM, kKC] of rows m0.., columns k0.. -> smem
template <int XT, int TM>
__device__ void load_x(const void* __restrict__ x, int K, size_t m0, int k0,
                       Smem& sm) {
  using E = typename Elem<XT>::type;
  constexpr int V = Elem<XT>::kVec, PER_ROW = kKC / V;
  for (int v = threadIdx.x; v < TM * PER_ROW; v += kThreads) {
    const int row = v / PER_ROW, kq = v % PER_ROW, k = k0 + kq * V;
    float f[V];
    load_vec<XT>(static_cast<const E*>(x) + (m0 + row) * K + k, k < K, f);
    float* dst = sm.x + row * kPadF + kq * V;
#pragma unroll
    for (int t = 0; t < V; ++t) dst[t] = f[t];
  }
}

// ---- weight chunk, reduction rows k0.., columns n0.. of one expert ->
// smem column-major [kTN cols][kKC k]
template <int WT>
__device__ void load_w(const void* __restrict__ w, int K, int N, int n0,
                       int k0, bool trans, Smem& sm) {
  using E = typename Elem<WT>::type;
  constexpr int V = Elem<WT>::kVec;
  const int tid = threadIdx.x;
  const E* wp = static_cast<const E*>(w);
  if (trans) {
    // w [N, K]: row n holds the reduction axis contiguously
    constexpr int PER_ROW = kKC / V;
    for (int v = tid; v < kTN * PER_ROW; v += kThreads) {
      const int c = v / PER_ROW, kq = v % PER_ROW;
      const int n = n0 + c, k = k0 + kq * V;
      float f[V];
      load_vec<WT>(wp + (size_t)n * K + k, n < N && k < K, f);
      float* dst = sm.w + c * kPadF + kq * V;
#pragma unroll
      for (int t = 0; t < V; ++t) dst[t] = f[t];
    }
  } else {
    // w [K, N]: row k holds the columns contiguously; transpose into smem
    constexpr int PER_ROW = kTN / V;
    for (int v = tid; v < kKC * PER_ROW; v += kThreads) {
      const int r = v / PER_ROW, cq = v % PER_ROW;
      const int k = k0 + r, n = n0 + cq * V;
      float f[V];
      load_vec<WT>(wp + (size_t)k * N + n, k < K && n < N, f);
#pragma unroll
      for (int t = 0; t < V; ++t) sm.w[(cq * V + t) * kPadF + r] = f[t];
    }
  }
}

template <int XT, int WT, int TM>
__global__ void __launch_bounds__(kThreads)
gmm_kernel(const void* __restrict__ x, const void* __restrict__ w,
           const int* __restrict__ tile_gid, void* __restrict__ out, int K,
           int N, int bm, int trans, int out_bf16) {
  constexpr int R = TM / 16;
  __shared__ Smem sm;

  const int n0 = blockIdx.x * kTN;
  const size_t m0 = (size_t)blockIdx.y * TM;
  const int g = tile_gid[m0 / bm];
  const void* wg = static_cast<const typename Elem<WT>::type*>(w) +
                   (size_t)g * K * N;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();  // previous chunk fully consumed
    load_x<XT, TM>(x, K, m0, k0, sm);
    load_w<WT>(wg, K, N, n0, k0, trans != 0, sm);
    __syncthreads();
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

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[r * N + n] =
            __float2bfloat16_rn(acc[i][j]);
      else
        static_cast<float*>(out)[r * N + n] = acc[i][j];
    }
  }
}

template <int XT, int WT>
int launch(const void* x, const void* w, const int* tile_gid, void* out,
           int sp, int k, int n, int bm, int tm, int trans, int out_bf16,
           cudaStream_t stream) {
  dim3 grid((n + kTN - 1) / kTN, sp / tm);
  if (tm == 64)
    gmm_kernel<XT, WT, 64><<<grid, kThreads, 0, stream>>>(
        x, w, tile_gid, out, k, n, bm, trans, out_bf16);
  else
    gmm_kernel<XT, WT, 16><<<grid, kThreads, 0, stream>>>(
        x, w, tile_gid, out, k, n, bm, trans, out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. x [sp, k] of dtype xt; w [E, k, n] (or [E, n, k] when
// trans) of dtype wt; xt / wt: 0 int8, 1 bf16, 2 f32: (int8, int8) W8A8,
// (bf16, int8), (bf16, bf16) and the f32 pairs (f32, f32), (bf16, f32),
// (f32, bf16). tile_gid [sp / bm] int32; w_scale [E, 1, n] f32 (int8 w) or
// null; a_scale [sp] f32 or null (int8 x only); out [sp, n], bf16 when
// out_bf16 else f32. bm % 16 == 0; tm (64 or 16, the FMA kernel's rows)
// divides bm. The caller checks shapes, dtypes, contiguity, 16-byte
// alignment, k % 16 == 0 and n % 16 == 0.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// dtype pair the kernels do not take).
extern "C" int gmm_launch(const void* x, const void* w, const void* tile_gid,
                          const void* w_scale, const void* a_scale, void* out,
                          int sp, int k, int n, int bm, int tm, int xt, int wt,
                          int trans, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(tile_gid);
  const float* ws = static_cast<const float*>(w_scale);
  const float* as = static_cast<const float*>(a_scale);
  // the tensor cores
  if (xt == kI8 && wt == kI8)
    return s8mma::launch<s8mma::kWsAs>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), as, ws,
        gid, bm, out, sp, n, k, trans, !out_bf16, s);
  if (xt == kBF16 && wt == kI8)
    return w8mma::launch<w8mma::kWI8>(x, w, ws, gid, out, sp, n, k, bm,
                                      trans, !out_bf16, s);
  if (xt == kBF16 && wt == kBF16)
    return w8mma::launch<w8mma::kWBF16>(x, w, nullptr, gid, out, sp, n, k,
                                        bm, trans, !out_bf16, s);
#define GMM_CASE(X, W)                                                   \
  if (xt == X && wt == W)                                                \
    return launch<X, W>(x, w, gid, out, sp, k, n, bm, tm, trans, out_bf16, \
                        s);
  GMM_CASE(kF32, kF32)
  GMM_CASE(kBF16, kF32)
  GMM_CASE(kF32, kBF16)
#undef GMM_CASE
  return (int)cudaErrorInvalidValue;
}
