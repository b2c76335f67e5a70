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
// compute bound. The A8 mode therefore runs on the s8 tensor cores
// (s8_mma.cuh, kPairs / kHalves: a cp.async ring of x and packed-weight
// tiles, the nibbles widened to s8 in registers, mma.sync m16n8k32, acc_lo
// folded into f32 at the group boundary); its sums are exact and its
// epilogue the plain version's rounded f32 ops in the same order, so it is
// bit-equal to it. The float mode stays on the first version's f32 FMA
// from shared-memory tiles (int4h_tile.cuh: 64 x 64 output tile, 64-row K
// chunks, 4 x 4 outputs per thread); K9's bf16 tensor-core kernel grouped
// by tile_gid is the later step for it.

#include "int4h_tile.cuh"
#include "s8_mma.cuh"

namespace {

using namespace int4h;

template <int TM>
__global__ void __launch_bounds__(kThreads)
gmm_int4h_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ packed,
                 const float* __restrict__ scale,
                 const int* __restrict__ tile_gid, float* __restrict__ out,
                 int K, int N, int bm) {
  __shared__ Smem sm;
  const int n0 = blockIdx.x * kTN;
  const int m0 = blockIdx.y * TM;
  const int g = tile_gid[m0 / bm];
  const int8_t* w = packed + (size_t)g * (K / 2) * N;
  const __nv_bfloat16* xt = x + (size_t)m0 * K;

  Acc<false, TM> lo, hi;
  lo.zero();
  hi.zero();
  tile_accum<false, TM>(xt, K, w, N, n0, 0, K / 2, sm, lo);
  tile_accum<false, TM>(xt, K, w, N, n0, K / 2, K, sm, hi);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* s0 = scale + (size_t)g * 2 * N;
  const float* s1 = s0 + N;
#pragma unroll
  for (int i = 0; i < Acc<false, TM>::R; ++i) {
    const int r = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      out[(size_t)r * N + n] = __fadd_rn(__fmul_rn(lo.v[i][j], s0[n]),
                                         __fmul_rn(hi.v[i][j], s1[n]));
    }
  }
}

template <int TM>
int launch_f32(const void* x, const int8_t* packed, const float* scale,
               const int* tile_gid, void* out, int sp, int k, int n, int bm,
               cudaStream_t stream) {
  dim3 grid(n / kTN, sp / TM);
  gmm_int4h_kernel<TM><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), packed, scale, tile_gid,
      static_cast<float*>(out), k, n, bm);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. x [sp, k] (int8 when a8, else bf16); packed [E, k/2, n]
// int8; scale [E, 2, 1, n] f32; tile_gid [sp / bm] int32; a_scale [sp] f32
// (a8 only); out [sp, n] (bf16 when a8, else f32). k/2 % 128 == 0; a8:
// bm % 16 == 0, n % 16 == 0; float: tm (16/32/64) divides bm, n % 64 == 0.
// The caller checks shapes, dtypes, contiguity and 16-byte alignment.
// Returns the cudaError_t of the launch.
extern "C" int gmm_int4h_launch(const void* x, const void* packed,
                                const void* scale, const void* tile_gid,
                                const void* a_scale, void* out, int sp, int k,
                                int n, int bm, int tm, int a8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  const int* gid = static_cast<const int*>(tile_gid);
  if (a8)
    return s8mma::launch<s8mma::kHalves>(
        static_cast<const int8_t*>(x), p,
        static_cast<const float*>(a_scale), sc, gid, bm, out, sp, n, k, 0,
        0, s);
  if (tm == 64) return launch_f32<64>(x, p, sc, gid, out, sp, k, n, bm, s);
  if (tm == 32) return launch_f32<32>(x, p, sc, gid, out, sp, k, n, bm, s);
  return launch_f32<16>(x, p, sc, gid, out, sp, k, n, bm, s);
}
