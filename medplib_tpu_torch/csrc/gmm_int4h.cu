// gmm_int4h: grouped matmul over int4 interleaved-pairs expert weights.
//
// Replaces the TPU kernel medplib_tpu/ops/pallas/gmm.py:gmm_int4h
// (_kernel_int4h, unpack_pairs). Rows of x are group-aligned: every m-tile
// of `bm` rows belongs to one expert, tile_gid[i] names it. For each row r
// of tile i and column n:
//   out[r, n] = (acc_lo[r, n] * scale[g, 0, n] + acc_hi[r, n] * scale[g, 1, n])
//               * a_scale[r]                      (A8 only)
// with acc_lo / acc_hi the products over the first / second half of the
// logical reduction rows (the two scale groups), g = tile_gid[r / bm].
//
// Modes: A8 (x int8 + per-row a_scale, s32 accumulation, bf16 output) and
// float (x bf16, f32 accumulation, f32 output).
//
// What bounds it on the H100: at the flagship prefill (Sp = 10752 rows,
// K = 4096 / N = 11264 and K = 11264 / N = 4096) each call does ~0.5 T
// MACs against ~23 MB of packed weights, ~3000 int8 ops per weight byte:
// compute bound. This first version does the MACs on __dp4a from shared
// memory tiles (64 x 64 output tile, 64-row K chunks, 4 x 4 outputs per
// thread), far below the int8 tensor-core rate; the int8 mma / wgmma path
// is later work. The epilogue uses explicitly rounded multiplies and adds
// so A8 results equal the plain PyTorch version bit for bit.

#include "int4h_tile.cuh"

namespace {

using namespace int4h;

template <bool A8, int TM>
__global__ void __launch_bounds__(kThreads)
gmm_int4h_kernel(const void* __restrict__ x, const int8_t* __restrict__ packed,
                 const float* __restrict__ scale,
                 const int* __restrict__ tile_gid,
                 const float* __restrict__ a_scale, void* __restrict__ out,
                 int K, int N, int bm) {
  __shared__ Smem sm;
  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * TM;
  const int g = tile_gid[m0 / bm];
  const int8_t* w = packed + (size_t)g * (K / 2) * N;
  const void* xt = A8 ? (const void*)((const int8_t*)x + (size_t)m0 * K)
                      : (const void*)((const __nv_bfloat16*)x + (size_t)m0 * K);

  Acc<A8, TM> lo, hi;
  lo.zero();
  hi.zero();
  tile_accum<A8, TM>(xt, K, w, N, n0, 0, K / 2, sm, lo);
  tile_accum<A8, TM>(xt, K, w, N, n0, K / 2, K, sm, hi);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* s0 = scale + (size_t)g * 2 * N;
  const float* s1 = s0 + N;
#pragma unroll
  for (int i = 0; i < Acc<A8, TM>::R; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      float v = __fadd_rn(__fmul_rn((float)lo.v[i][j], s0[n]),
                          __fmul_rn((float)hi.v[i][j], s1[n]));
      if constexpr (A8) {
        v = __fmul_rn(v, a_scale[r]);
        static_cast<__nv_bfloat16*>(out)[(size_t)r * N + n] =
            __float2bfloat16_rn(v);
      } else {
        static_cast<float*>(out)[(size_t)r * N + n] = v;
      }
    }
  }
}

template <bool A8, int TM>
void launch(const void* x, const int8_t* packed, const float* scale,
            const int* tile_gid, const float* a_scale, void* out, int sp,
            int k, int n, int bm, cudaStream_t stream) {
  dim3 grid(n / kTN, sp / TM);
  gmm_int4h_kernel<A8, TM><<<grid, kThreads, 0, stream>>>(
      x, packed, scale, tile_gid, a_scale, out, k, n, bm);
}

template <bool A8>
void dispatch_tm(int tm, const void* x, const int8_t* packed,
                 const float* scale, const int* tile_gid,
                 const float* a_scale, void* out, int sp, int k, int n,
                 int bm, cudaStream_t stream) {
  if (tm == 64)
    launch<A8, 64>(x, packed, scale, tile_gid, a_scale, out, sp, k, n, bm,
                   stream);
  else if (tm == 32)
    launch<A8, 32>(x, packed, scale, tile_gid, a_scale, out, sp, k, n, bm,
                   stream);
  else
    launch<A8, 16>(x, packed, scale, tile_gid, a_scale, out, sp, k, n, bm,
                   stream);
}

}  // namespace

// C entry point. x [sp, k] (int8 when a8, else bf16); packed [E, k/2, n]
// int8; scale [E, 2, 1, n] f32; tile_gid [sp / bm] int32; a_scale [sp] f32
// (a8 only); out [sp, n] (bf16 when a8, else f32). tm (16/32/64) divides bm;
// the caller checks shapes, dtypes, contiguity and 16-byte alignment.
// Returns the cudaError_t of the launch.
extern "C" int gmm_int4h_launch(const void* x, const void* packed,
                                const void* scale, const void* tile_gid,
                                const void* a_scale, void* out, int sp, int k,
                                int n, int bm, int tm, int a8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a8)
    dispatch_tm<true>(tm, x, (const int8_t*)packed, (const float*)scale,
                      (const int*)tile_gid, (const float*)a_scale, out, sp,
                      k, n, bm, s);
  else
    dispatch_tm<false>(tm, x, (const int8_t*)packed, (const float*)scale,
                       (const int*)tile_gid, (const float*)a_scale, out, sp,
                       k, n, bm, s);
  return (int)cudaGetLastError();
}
