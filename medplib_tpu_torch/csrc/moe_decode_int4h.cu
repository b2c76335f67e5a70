// moe_ffn_decode_int4h: the routed SwiGLU expert FFN of one decode step.
//
// Replaces the TPU kernel medplib_tpu/ops/pallas/moe_decode.py:
// moe_ffn_decode_int4h (_kernel). For expert e and decode rows x [B, H]:
//   g = (x[:, :H/2] @ Wg_lo) * sg[0] + (x[:, H/2:] @ Wg_hi) * sg[1]  (x row
//       scale applied in A8 mode); u likewise
//   act = silu(g) * u * (gate[b, j] if route_idx[b, j] == e for a j < topk,
//         else 0): every row routes to topk distinct experts (top-1 for
//         MedPLIB-7b-2e; DeepSeek-V2's top-6 of 64 sums its six experts'
//         gated outputs in the combine below, in one pass)
//   out = sum over the bn-column blocks c of M, in the TPU grid's order
//         (e, j, nh), c = nh * n_j + j, from 0:  act[:, c] @ Wd[c] * sd[nh]
// In A8 mode act is quantized to int8 per row PER BLOCK c of M (scale per
// row and block), exactly as the TPU kernel does, and each block's s32
// product is rescaled by its own scales before the f32 sum.
//
// What bounds it on the H100: a decode step reads every expert byte of the
// layer once (flagship: 2 experts x 3 int4 matrices of 4096 x 11264, about
// 138 MB per layer) for 16 rows of math: HBM bandwidth (0.042 ms at
// 3.35 TB/s). The design spreads those bytes over the whole card, every
// block streaming its own weight tile through a cp.async ring into the
// tensor cores, and keeps the sums in a fixed order (no atomics):
//   0. prep: grid (Bp): x [B, H] into the padded operand [Bp, H], A8
//      quantized per row (ops/cuda/gmm.quantize_rows' ops) with its row
//      scales, else rounded to bf16 (one launch in place of the wrapper's
//      quantize and pad ops);
//   1. gate / up: grid (Bp / 16, M / 128, 2 E), one 16 x 128 tile of g or
//      u a block over K = H (352 blocks at the flagship), written f32 to
//      gu [E, 2, Bp, M]; the K1 fold (acc_lo * s0) + (acc_hi * s1) at the
//      k-step where the high half starts, then * xs (A8);
//   2. act: grid (M / bn, Bp, E): act = silu(g) * u * mask, then the
//      per-row-per-block quantization (A8: act_q int8 + act_s) or the bf16
//      rounding of act;
//   3. down: grid (Bp / 16, H / 128, E * 2 * n_j), one block per (e, j, nh)
//      and 128 output columns (1408 blocks at the flagship), K = bn: the
//      f32 partial p = (f32(acc) * a_s) * sd[nh] (bf16: acc * sd[nh]) into
//      part [(e * n_j + j) * 2 + nh, Bp, H];
//   4. combine: out = ((0 + p_0) + p_1) + ..., the partials added in the
//      reference's (e, j, nh) order, so the down sum is the plain version's
//      sequential `acc +=` bit for bit; the B real rows stored in x's
//      dtype (f32, or rounded to bf16 once).
// Products (pairs_product): A8 on s8 mma.sync m16n8k32 with K1's kPairs
// fragments (s8_mma.cuh: 64 packed rows of 128 bytes a stage, the nibbles
// widened to 16 x the nibble as s8 in registers, the s32 sums shifted
// right by 4, exact); bf16 on bf16 mma.sync m16n8k16 from the same packed
// tile (K9's B fragments: the words of packed rows 8 s + t and 8 s + 4 + t,
// nibbles decoded to bf16x2 in registers, mma_tile.cuh). Blocks are 16
// rows x 128 columns, 4 warps of 16 x 32, the column map of s8_mma.cuh
// (each thread's outputs are 8 neighbouring columns of two rows).
// Rows are padded to Bp in {16, 32, 64}: the padded rows of x are zeros
// and carry a zero gate.

#include <type_traits>

#include "mma_tile.cuh"
#include "s8_mma.cuh"

namespace {

using namespace mmatile;

constexpr int kBM = 16;       // rows a block: one m16 tile
constexpr int kBN = 128;      // output columns a block: 4 warps of 32
constexpr int kThreads = kBN;
constexpr int kStageK = 128;  // logical k a pipeline stage, both modes

template <bool A8>
using AccT = typename std::conditional<A8, int, float>::type;

// jax.nn.silu's op sequence: g * (1 / (1 + exp(-g))), each op rounded
__device__ __forceinline__ float silu_f(float g) {
  return __fmul_rn(g, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));
}

template <bool A8>
__host__ __device__ constexpr int stage_bytes() {
  // A: 16 rows of 128 bytes (A8: 128 k; bf16: two such tiles of 64 k);
  // B: 64 packed rows (128 logical k) of kBN bytes
  return (A8 ? 1 : 2) * kBM * kARow + (kStageK / 2) * kBN;
}

// The f32 value of a sum: A8 sums carry the factor 16 of the widened
// nibbles, removed by an exact shift.
template <bool A8>
__device__ __forceinline__ float sum_f32(AccT<A8> v) {
  if constexpr (A8)
    return __int2float_rn(v >> s8mma::kNibShift);
  else
    return v;
}

// acc[j][c] += A [16, K] @ unpack(w)[K, kBN]: A at the block's first row
// and k (`a_pitch` bytes between rows; int8 when A8, else bf16), w the
// packed int4h pairs at the first packed row (`w_pitch` bytes between
// rows, columns n0 .. n0 + kBN of N). K % 128 == 0. on_split(acc) runs
// before the k-step that starts at logical k == split (-1: never).
// acc[j] is n-tile j of the warp's columns wn0 + 4 g + j (mma C layout).
template <bool A8, int STAGES, class Split>
__device__ __forceinline__ void pairs_product(
    const char* a, size_t a_pitch, const int8_t* w, int w_pitch, int N,
    int n0, int K, int split, char* smem, AccT<A8> (&acc)[4][4],
    Split on_split) {
  using BLoad = s8mma::KNLoader<kBN, kThreads, true>;
  constexpr int A_BYTES = (A8 ? 1 : 2) * kBM * kARow;
  constexpr int STAGE = stage_bytes<A8>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn0 = warp * 32, g = lane >> 2, t = lane & 3;
  const int ktiles = K / kStageK;
  const int row_bytes = A8 ? K : 2 * K;

  const ATileLoader<kBM, kThreads> aload(a, a_pitch, kBM, 0);
  const BLoad bload(w, w_pitch, N, n0);
  auto load_stage = [&](int slot, int kt) {
    char* s = smem + slot * STAGE;
    if constexpr (A8) {
      aload.load(s, a, row_bytes, kt * kARow);
    } else {
      aload.load(s, a, row_bytes, 2 * kt * kARow);
      aload.load(s + kBM * kARow, a, row_bytes, (2 * kt + 1) * kARow);
    }
    bload.load(s + A_BYTES, w, K / 2, kt * (kStageK / 2));
  };
  uint32_t a_off[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) a_off[s] = a_frag_offset(0, s);
  // the lane's words: A8, packed rows 2 t and 2 t + 1 (k-step 0, low
  // half); bf16, packed rows t and 4 + t (k-step 0), at columns
  // wn0 + 4 g .. + 3
  const int cc = (wn0 + 4 * g) >> 4, wb = 4 * (g & 3);
  const int b0 = BLoad::offset(A8 ? 2 * t : t, cc) + wb;
  const int b1 = BLoad::offset(A8 ? 2 * t + 1 : 4 + t, cc) + wb;
  const uint32_t smem0 = smem_u32(smem);

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
    const uint32_t sa = smem0 + slot * STAGE;
    const char* sb = smem + slot * STAGE + A_BYTES;
    if constexpr (A8) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // 32 k a step
        if (kt * kStageK + 32 * s == split) on_split(acc);
        uint32_t af[4];
        ldmatrix_x4(af, sa + a_off[s]);
        const char* q = sb + 16 * s * kBN;
        uint32_t r[8];  // k rows 4 t .. 4 t + 3, then 16 + 4 t ..
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s8mma::widen_pairs(
              *reinterpret_cast<const uint32_t*>(q + b0 + 8 * h * kBN),
              r[4 * h], r[4 * h + 1]);
          s8mma::widen_pairs(
              *reinterpret_cast<const uint32_t*>(q + b1 + 8 * h * kBN),
              r[4 * h + 2], r[4 * h + 3]);
        }
        uint32_t lo[4], hi[4];
        s8mma::transpose4x4(r[0], r[1], r[2], r[3], lo);
        s8mma::transpose4x4(r[4], r[5], r[6], r[7], hi);
#pragma unroll
        for (int j = 0; j < 4; ++j) s8mma::mma_s8(acc[j], af, lo[j], hi[j]);
      }
    } else {
#pragma unroll
      for (int s = 0; s < 8; ++s) {  // 16 k a step
        if (kt * kStageK + 16 * s == split) on_split(acc);
        uint32_t af[4];
        ldmatrix_x4(af, sa + (s >> 2) * kBM * kARow + a_off[s & 3]);
        const char* q = sb + 8 * s * kBN;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(q + b0);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(q + b1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t f0, f1;
          nibbles_to_bf16x2(__byte_perm(w0, w1, j | ((j + 4) << 4)), f0, f1);
          mma_bf16(acc[j], af, f0, f1);
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <bool A8>
__device__ __forceinline__ void zero(AccT<A8> (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0;
}

// 0. prep. grid (Bp), kPrepThreads threads: row r of x [B, H] (T = bf16
// or f32) into the kernels' padded operand xk [Bp, H]: A8, the per-row
// int8 quantization of ops/cuda/gmm.quantize_rows (s = max(amax, 1e-12) *
// f32(1 / 127), q = clip(rint(x / s), -127, 127)) with xs [Bp] = s; bf16,
// x rounded to bf16. Rows r >= B are zeros (xs 0). Eight elements a
// thread a step (16- or 32-byte loads), H % 8 == 0.
constexpr int kPrepThreads = 256;

template <typename T>
__device__ __forceinline__ void load8_as_f32(const T* p, float (&v)[8]) {
  if constexpr (std::is_same<T, float>::value) {
    s8mma::load8(p, v);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <bool A8, typename T>
__global__ void __launch_bounds__(kPrepThreads)
moe_prep_kernel(const T* __restrict__ x, void* __restrict__ xk,
                float* __restrict__ xs, int B, int H) {
  __shared__ float red[kPrepThreads / 32];
  const int r = blockIdx.x;
  const T* xr = x + (size_t)r * H;
  const int step = 8 * kPrepThreads;
  if constexpr (!A8) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(xk) + (size_t)r * H;
    for (int i = 8 * threadIdx.x; i < H; i += step) {
      float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (r < B) load8_as_f32(xr + i, v);
      __nv_bfloat162 h[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      *reinterpret_cast<uint4*>(o + i) = *reinterpret_cast<const uint4*>(h);
    }
  } else {
    int8_t* o = static_cast<int8_t*>(xk) + (size_t)r * H;
    if (r >= B) {
      for (int i = 8 * threadIdx.x; i < H; i += step)
        *reinterpret_cast<uint2*>(o + i) = make_uint2(0, 0);
      if (threadIdx.x == 0) xs[r] = 0.0f;
      return;
    }
    float amax = 0.0f;
    for (int i = 8 * threadIdx.x; i < H; i += step) {
      float v[8];
      load8_as_f32(xr + i, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(v[k]));
    }
    for (int k = 16; k > 0; k >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, k));
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
    __syncthreads();
    float m = 0.0f;
#pragma unroll
    for (int w = 0; w < kPrepThreads / 32; ++w) m = fmaxf(m, red[w]);
    const float sc = __fmul_rn(fmaxf(m, 1e-12f), 1.0f / 127.0f);
    for (int i = 8 * threadIdx.x; i < H; i += step) {
      float v[8];
      load8_as_f32(xr + i, v);
      uint32_t w[2] = {0, 0};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float q =
            fminf(fmaxf(rintf(__fdiv_rn(v[k], sc)), -127.0f), 127.0f);
        w[k / 4] |= (uint32_t)(uint8_t)(int8_t)q << (8 * (k % 4));
      }
      *reinterpret_cast<uint2*>(o + i) = make_uint2(w[0], w[1]);
    }
    if (threadIdx.x == 0) xs[r] = sc;
  }
}

// 1. gate / up. grid (Bp / 16, M / kBN, 2 E); blockIdx.z = 2 e + (0 gate,
// 1 up). x [Bp, H] (int8 or bf16), xs [Bp] f32 (A8); gp / up packed
// [E, H/2, M], gs / us [E, 2, 1, M]; gu f32 [E, 2, Bp, M].
template <bool A8, int STAGES>
__global__ void __launch_bounds__(kThreads)
moe_gateup_kernel(const void* __restrict__ x, const float* __restrict__ xs,
                  const int8_t* __restrict__ gp, const float* __restrict__ gs,
                  const int8_t* __restrict__ up, const float* __restrict__ us,
                  float* __restrict__ gu, int bp, int H, int M) {
  extern __shared__ __align__(16) char smem[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, z = blockIdx.z;
  const int e = z >> 1;
  const int8_t* w = (z & 1 ? up : gp) + (size_t)e * (H / 2) * M;
  const float* sc = (z & 1 ? us : gs) + (size_t)e * 2 * M;
  const size_t pitch = (A8 ? 1 : 2) * (size_t)H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col0 = n0 + (threadIdx.x >> 5) * 32 + 8 * t;

  AccT<A8> acc[4][4];
  float p[4][4];  // acc_lo * s0 (c0 / c2 of n-tile j: column 8 t + j)
  zero<A8>(acc);
  pairs_product<A8, STAGES>(
      static_cast<const char*>(x) + m0 * pitch, pitch, w, M, M, n0, H, H / 2,
      smem, acc, [&](AccT<A8> (&c)[4][4]) {
        float s0[8];
        s8mma::load8(sc + col0, s0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            p[j][u] = __fmul_rn(sum_f32<A8>(c[j][u]), s0[(u & 1) * 4 + j]);
            c[j][u] = 0;
          }
      });
  float s1[8];
  s8mma::load8(sc + M + col0, s1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + g + 8 * h;
    const float xr = A8 ? xs[row] : 1.0f;
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = 2 * h + u, o = 4 * u + j;
        const float f = __fadd_rn(
            p[j][c], __fmul_rn(sum_f32<A8>(acc[j][c]), s1[o]));
        v[o] = A8 ? __fmul_rn(f, xr) : f;
      }
    store_row8_f32(gu + (size_t)z * bp * M, row, col0, M, v);
  }
}

// 2. act. grid (M / bn, Bp, E), 128 threads, bn floats of dynamic shared
// memory (A8). act = silu(g) * u * mask (mask 0 on the padded rows
// r >= B); A8: per row and block, a_sc =
// max(amax, 1e-12) * f32(1 / 127) (XLA compiles the reference's / 127.0
// so), act_q = clip(rint(act / a_sc), -127, 127); bf16: act_q = bf16(act).
template <bool A8>
__global__ void moe_act_kernel(const float* __restrict__ gu,
                               const int* __restrict__ route_idx,
                               const float* __restrict__ route_gate,
                               void* __restrict__ act_q,
                               float* __restrict__ act_s, int B, int bp,
                               int M, int bn, int topk) {
  extern __shared__ float sact[];
  __shared__ float red[32];
  const int c = blockIdx.x, r = blockIdx.y, e = blockIdx.z;
  const size_t col = (size_t)c * bn;
  const float* gr = gu + ((size_t)2 * e * bp + r) * M + col;
  const float* ur = gu + ((size_t)(2 * e + 1) * bp + r) * M + col;
  const size_t row = ((size_t)e * bp + r) * M + col;
  float mask = 0.0f;
  if (r < B)
    for (int j = 0; j < topk; ++j)
      if (route_idx[r * topk + j] == e) mask = route_gate[r * topk + j];
  float amax = 0.0f;
  for (int i = threadIdx.x; i < bn; i += blockDim.x) {
    const float a = __fmul_rn(__fmul_rn(silu_f(gr[i]), ur[i]), mask);
    if constexpr (A8) {
      sact[i] = a;
      amax = fmaxf(amax, fabsf(a));
    } else {
      static_cast<__nv_bfloat16*>(act_q)[row + i] = __float2bfloat16_rn(a);
    }
  }
  if constexpr (A8) {
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = 0.0f;
      for (int w = 0; w < (int)(blockDim.x / 32); ++w) m = fmaxf(m, red[w]);
      red[0] = __fmul_rn(fmaxf(m, 1e-12f), 1.0f / 127.0f);
    }
    __syncthreads();
    const float sc = red[0];
    for (int i = threadIdx.x; i < bn; i += blockDim.x) {
      float q = rintf(__fdiv_rn(sact[i], sc));
      q = fminf(fmaxf(q, -127.0f), 127.0f);
      static_cast<int8_t*>(act_q)[row + i] = (int8_t)q;
    }
    if (threadIdx.x == 0) act_s[((size_t)e * bp + r) * (M / bn) + c] = sc;
  }
}

// 3. down. grid (Bp / 16, H / kBN, E * 2 * n_j); blockIdx.z = q =
// (e * n_j + j) * 2 + nh, c = nh * n_j + j. act_q [E, Bp, M] (int8 or
// bf16), act_s [E, Bp, M / bn]; dp packed [E, M/2, H], ds [E, 2, 1, H];
// part f32 [E * 2 * n_j, Bp, H].
template <bool A8, int STAGES>
__global__ void __launch_bounds__(kThreads)
moe_down_kernel(const void* __restrict__ act_q,
                const float* __restrict__ act_s,
                const int8_t* __restrict__ dp, const float* __restrict__ ds,
                float* __restrict__ part, int bp, int H, int M, int bn) {
  extern __shared__ __align__(16) char smem[];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, q = blockIdx.z;
  const int n_j = M / 2 / bn, nblk = M / bn;
  const int e = q / (2 * n_j), j = (q >> 1) % n_j, nh = q & 1;
  const int c = nh * n_j + j;
  const size_t esz = A8 ? 1 : 2;
  const char* a = static_cast<const char*>(act_q) +
                  (((size_t)e * bp + m0) * M + (size_t)c * bn) * esz;
  const int8_t* w = dp + ((size_t)e * (M / 2) + (size_t)c * (bn / 2)) * H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col0 = n0 + (threadIdx.x >> 5) * 32 + 8 * t;

  AccT<A8> acc[4][4];
  zero<A8>(acc);
  pairs_product<A8, STAGES>(a, M * esz, w, H, H, n0, bn, -1, smem, acc,
                            [](AccT<A8> (&)[4][4]) {});
  float dsv[8];
  s8mma::load8(ds + ((size_t)e * 2 + nh) * H + col0, dsv);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + g + 8 * h;
    const float as = A8 ? act_s[((size_t)e * bp + row) * nblk + c] : 1.0f;
    float v[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cc = 2 * h + u, o = 4 * u + jj;
        const float f = sum_f32<A8>(acc[jj][cc]);
        v[o] = __fmul_rn(A8 ? __fmul_rn(f, as) : f, dsv[o]);
      }
    store_row8_f32(part + (size_t)q * bp * H, row, col0, H, v);
  }
}

// 4. combine. out[i] = ((0 + part[0][i]) + part[1][i]) + ..., in q order,
// four consecutive elements of the first B rows a thread; the f32 sum is
// stored as it is or rounded to bf16 once. part [Q, Bp, H] (n4 = B H / 4
// float4 of each q's first B rows, stride s4 = Bp H / 4 between q).
template <bool OUT_F32>
__global__ void moe_combine_kernel(const float4* __restrict__ part,
                                   void* __restrict__ out, int n4, int s4,
                                   int Q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int q = 0; q < Q; ++q) {
    const float4 v = part[(size_t)q * s4 + i];
    s.x = __fadd_rn(s.x, v.x);
    s.y = __fadd_rn(s.y, v.y);
    s.z = __fadd_rn(s.z, v.z);
    s.w = __fadd_rn(s.w, v.w);
  }
  if constexpr (OUT_F32) {
    static_cast<float4*>(out)[i] = s;
  } else {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(s.x, s.y),
                           __floats2bfloat162_rn(s.z, s.w)};
    static_cast<uint2*>(out)[i] = *reinterpret_cast<const uint2*>(h);
  }
}

// The dynamic shared memory a kernel needs above the default 48 KB, set
// once per kernel (the first launch of each instance).
template <class Kern>
int set_smem(Kern kern, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Args {
  const void* x;
  const int* route_idx;
  const float* route_gate;
  const int8_t *gp, *up, *dp;
  const float *gs, *us, *ds;
  void* xk;
  float* xs;
  float* gu;
  void* act_q;
  float* act_s;
  float* part;
  void* out;
  int b, bp, h, m, e, bn, topk;
};

template <bool A8, typename T>
int run(const Args& a, cudaStream_t s) {
  constexpr int kGateUpStages = 6, kDownStages = 4;
  constexpr int smem_gu = kGateUpStages * stage_bytes<A8>();
  constexpr int smem_down = kDownStages * stage_bytes<A8>();
  const int smem_act = A8 ? a.bn * (int)sizeof(float) : 0;
  static const int attr =
      set_smem(moe_gateup_kernel<A8, kGateUpStages>, smem_gu) |
      set_smem(moe_down_kernel<A8, kDownStages>, smem_down);
  int err = attr ? attr : set_smem(moe_act_kernel<A8>, smem_act);
  if (err) return err;

  moe_prep_kernel<A8, T><<<a.bp, kPrepThreads, 0, s>>>(
      static_cast<const T*>(a.x), a.xk, a.xs, a.b, a.h);
  if ((err = (int)cudaGetLastError())) return err;
  moe_gateup_kernel<A8, kGateUpStages>
      <<<dim3(a.bp / kBM, a.m / kBN, 2 * a.e), kThreads, smem_gu, s>>>(
          a.xk, a.xs, a.gp, a.gs, a.up, a.us, a.gu, a.bp, a.h, a.m);
  if ((err = (int)cudaGetLastError())) return err;
  moe_act_kernel<A8><<<dim3(a.m / a.bn, a.bp, a.e), 128, smem_act, s>>>(
      a.gu, a.route_idx, a.route_gate, a.act_q, a.act_s, a.b, a.bp, a.m,
      a.bn, a.topk);
  if ((err = (int)cudaGetLastError())) return err;
  const int nq = a.e * (a.m / a.bn);
  moe_down_kernel<A8, kDownStages>
      <<<dim3(a.bp / kBM, a.h / kBN, nq), kThreads, smem_down, s>>>(
          a.act_q, a.act_s, a.dp, a.ds, a.part, a.bp, a.h, a.m, a.bn);
  if ((err = (int)cudaGetLastError())) return err;
  const int n4 = a.b * a.h / 4;
  moe_combine_kernel<std::is_same<T, float>::value>
      <<<(n4 + 127) / 128, 128, 0, s>>>(
      reinterpret_cast<const float4*>(a.part), a.out, n4, a.bp * a.h / 4,
      nq);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. x [b, h] and out [b, h], f32 when f32 else bf16; b <= bp
// rows, bp in {16, 32, 64}; route_idx [b, topk] int32 (distinct experts
// a row); route_gate [b, topk] f32;
// gate/up packed [e, h/2, m] int8 + scale [e, 2, 1, m] f32; down packed
// [e, m/2, h] int8 + scale [e, 2, 1, h] f32; scratch: xk [bp, h] (int8
// when a8, else bf16), xs f32 [bp], gu f32 [e, 2, bp, m], act_q [e, bp, m]
// (int8 when a8, else bf16), act_s f32 [e, bp, m/bn], part f32
// [e * m / bn, bp, h]. The caller checks shapes (h % 128 == 0,
// m % 256 == 0, bn % 128 == 0, bn | m/2), dtypes, contiguity and 16-byte
// alignment. Five launches; returns the first cudaError_t.
extern "C" int moe_decode_int4h_launch(
    const void* x, const void* route_idx, const void* route_gate,
    const void* gp, const void* gs, const void* up, const void* us,
    const void* dp, const void* ds, void* xk, void* xs, void* gu,
    void* act_q, void* act_s, void* part, void* out, int b, int bp, int h,
    int m, int e, int bn, int topk, int a8, int f32, void* stream) {
  const Args a{x,
               static_cast<const int*>(route_idx),
               static_cast<const float*>(route_gate),
               static_cast<const int8_t*>(gp),
               static_cast<const int8_t*>(up),
               static_cast<const int8_t*>(dp),
               static_cast<const float*>(gs),
               static_cast<const float*>(us),
               static_cast<const float*>(ds),
               xk,
               static_cast<float*>(xs),
               static_cast<float*>(gu),
               act_q,
               static_cast<float*>(act_s),
               static_cast<float*>(part),
               out,
               b, bp, h, m, e, bn, topk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a8)
    return f32 ? run<true, float>(a, s) : run<true, __nv_bfloat16>(a, s);
  return f32 ? run<false, float>(a, s) : run<false, __nv_bfloat16>(a, s);
}
