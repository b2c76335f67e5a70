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
// Modes: A8 (x int8 + per-row a_scale or ones, s32 accumulation, bf16 or
// f32 output) and float (x bf16, f32 accumulation, f32 output).
//
// What bounds it on the H100: at the flagship prefill (Sp = 10752 rows,
// K = 4096 / N = 11264 and K = 11264 / N = 4096) each call does ~0.5 T
// MACs against ~23 MB of packed weights, ~3000 int8 ops per weight byte:
// compute bound. Both modes therefore run on the tensor cores:
//   - A8 on the s8 tile (s8_mma.cuh, kPairs / kHalves: a cp.async ring of
//     x and packed-weight tiles, the nibbles widened to s8 in registers,
//     mma.sync m16n8k32, acc_lo folded into f32 at the group boundary);
//     its sums are exact and its epilogue the plain version's rounded f32
//     ops in the same order, so it is bit-equal to it;
//   - float on K9's bf16 tile grouped by tile_gid (int4h_mma.cuh, K1 = true:
//     nibbles decoded to bf16x2 in registers, mma.sync m16n8k16, G = 2
//     groups of K/2, the fold (acc_lo * s0) + (acc_hi * s1) rounded op by
//     op as the plain version, f32 stores); only the f32 summation order
//     differs from the plain version.
// Tiles: 64 x 128 where bm % 64 == 0, else 16 x 64.

#include "int4h_mma.cuh"
#include "s8_mma.cuh"

// C entry point. x [sp, k] (int8 when a8, else bf16); packed [E, k/2, n]
// int8; scale [E, 2, 1, n] f32; tile_gid [sp / bm] int32; a_scale [sp] f32
// or null (a8: ones); out [sp, n], bf16 when a8 and out_bf16, else f32.
// k/2 % 128 == 0, bm % 16 == 0, n % 16 == 0. The caller checks shapes,
// dtypes, contiguity and 16-byte alignment. Returns the cudaError_t of the
// launch.
extern "C" int gmm_int4h_launch(const void* x, const void* packed,
                                const void* scale, const void* tile_gid,
                                const void* a_scale, void* out, int sp, int k,
                                int n, int bm, int a8, int out_bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  const int* gid = static_cast<const int*>(tile_gid);
  if (a8)
    return s8mma::launch<s8mma::kHalves>(
        static_cast<const int8_t*>(x), p,
        static_cast<const float*>(a_scale), sc, gid, bm, out, sp, n, k, 0,
        !out_bf16, s);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (bm % 64 == 0)
    return i4mma::launch_mma<64, 128, 64, 6, false, 16, true>(
        xb, p, sc, out, sp, n, k, k, n, 2, k / 2, s, gid, bm);
  return i4mma::launch_mma<16, 64, 16, 6, false, 16, true>(
      xb, p, sc, out, sp, n, k, k, n, 2, k / 2, s, gid, bm);
}
