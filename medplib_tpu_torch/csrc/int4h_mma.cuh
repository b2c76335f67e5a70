// The bf16 tensor-core kernel of the int4 "interleaved pairs" matmuls:
// K9 (int4_matmul.cu: int4h_matmul / int4h_matmul_t on bf16 x) and, grouped
// by tile_gid, K1 on float x (gmm_int4h.cu). Logical reduction row 2r of
// the weight is the LOW nibble of packed row r, row 2r+1 its HIGH nibble,
// both sign-extended (utils/quantize._quantize_kernel4h):
//   - normal:     packed [K/2, N], scale [G, 1, N]; packed row r holds
//                 logical rows 2r, 2r+1 of every column;
//   - transposed: packed [N, K/2], scale [G, N, 1]; packed column j of
//                 row n holds logical k = 2j, 2j+1 of column n.
// Both scale layouts read as scale[g * N + n], g = k / gsize.
//
// Numerics: a nibble is exact in bf16 and bf16 x times a nibble exact in
// f32, so mma.sync m16n8k16 (bf16 in, f32 sums) forms
//   acc_g[m, n] = sum_{k in group g} x[m, k] * nibble[k, n]
// and at each group end the block folds it into an f32 running total,
//   K9: tot[m, n] = fmaf(acc_g[m, n], scale[g, n], tot[m, n]),
//   K1: tot[m, n] = __fadd_rn(tot, __fmul_rn(acc_g, scale[g, n])),
// K1 (G = 2, gsize = K/2) thereby (acc_lo * s0) + (acc_hi * s1), each op
// rounded, as its plain version and its reference's epilogue; K9 is cast
// to bf16 once at the end, K1 stored in f32 (the wrapper casts to
// out_dtype). Against the references only the order of the f32 sums
// differs (K9: and one rounding per weight). A 16-deep step that straddles
// a group end runs once per group, the other group's B pairs zeroed.
//
// Memory: x tiles (bf16, 64 k a stage, XOR-swizzled rows) and packed
// weight tiles (32 bytes of k per column a stage) arrive by cp.async in a
// ring of STAGES stages in dynamic shared memory; ragged rows, columns and
// K are zero-filled by the copies' source-size operand. The G x BN scales
// of a block load once. One packed byte is one (k, k+1) pair of one
// column, i.e. one bf16x2 B register, in both layouts, decoded in
// registers (mma_tile.cuh): the dequantized weight never exists in device
// memory and x needs no even / odd copy. K1: tile_gid[m0 / bm] names the
// expert of a block's rows (BM divides bm) and offsets the packed weight
// (e K/2 N bytes) and the scales (e G N), as w8_mma_kernel does.
// Column map: n-tile j of a warp's 32 columns gives its B column g to the
// warp column 4 g + j. One 32-bit word of a normal-layout weight row then
// feeds all four n-tiles, and each thread's outputs are the eight
// neighbouring columns 8 t .. 8 t + 7 (one 16-byte bf16 store, or two f32
// ones, a row). The transposed tile stores weight row 4 g + j at smem row
// 8 j + g (a 48-byte pitch), so the eight rows a load phase reads miss
// each other's banks.
// Tiles (chosen on the card, PERF.md): 64 x 128 outputs, 4 warps of
// 64 x 32 (16 mma per 16-deep step, 4 B decodes shared by 4 m-tiles), 6
// stages; at ~200 registers two blocks share an SM. 128 x 128 blocks of 8
// warps (one a SM) and 64 x 32 warp tiles (half the mma per decode) ran
// slower. K9 at M <= 16 (decode) and K1 at bm % 64 != 0: 16 x 64 outputs,
// 2 warps of 16 x 32, 6 stages, so that the weight bytes of many stages
// are in flight. Each step loads the next step's fragments before its mma.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tile.cuh"

namespace i4mma {

template <bool TRANS, int BN>
__host__ __device__ constexpr int b_stage_bytes() {
  // transposed: BN weight rows of 32 bytes at a 48-byte pitch; normal: 32
  // packed rows of BN bytes at a BN + 32 pitch (8 banks between rows)
  return TRANS ? BN * 48 : 32 * (BN + 32);
}

// Copies of the packed weight tile of one stage (logical k0 .. k0 + 64,
// columns n0 .. n0 + BN) in WV-byte chunks: normal, 32 packed rows of BN
// bytes; transposed, BN weight rows of 32 bytes, weight row 32 w + 4 g + j
// stored at smem row 32 w + 8 j + g. Each thread copies chunk c of ITERS
// rows ROW_STEP apart; ragged columns and K are zero-filled.
template <int BN, int THREADS, bool TRANS, int WV>
struct BTileLoader {
  static constexpr int CPR = TRANS ? 32 / WV : BN / WV;  // copies a row
  static constexpr int ROWS = TRANS ? BN : 32;
  static constexpr int ITERS = ROWS * CPR / THREADS;
  static constexpr int ROW_STEP = THREADS / CPR;
  static_assert(ROWS * CPR % THREADS == 0 && THREADS % CPR == 0, "B copies");
  const int8_t* src;  // the thread's first row at its chunk, k0 = 0
  int wpitch, r, c;
  int fixed;  // transposed: its rows < N; normal: its bytes < N

  __device__ BTileLoader(const int8_t* p, int N, int pitch, int n0)
      : wpitch(pitch), r(threadIdx.x / CPR), c(threadIdx.x % CPR) {
    if constexpr (TRANS) {
      fixed = min(ITERS, max(0, (N - n0 - r + ROW_STEP - 1) / ROW_STEP));
      src = p + (size_t)(n0 + r) * wpitch + c * WV;
    } else {
      fixed = min(WV, max(0, N - n0 - c * WV));
      src = p + (size_t)r * wpitch + n0 + c * WV;
    }
  }

  // j0: first packed k of the stage; k2 = K / 2
  __device__ __forceinline__ void load(char* tile, const int8_t* p, int k2,
                                       int j0) const {
    const int kbytes = min(WV, max(0, k2 - j0 - c * WV));  // transposed
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int row = r + i * ROW_STEP;
      int bytes;
      const int8_t* s;
      char* dst;
      if constexpr (TRANS) {
        bytes = i < fixed ? kbytes : 0;
        s = src + (size_t)i * ROW_STEP * wpitch + j0;
        const int pr = (row & ~31) | ((row & 3) << 3) | ((row >> 2) & 7);
        dst = tile + pr * 48 + c * WV;
      } else {
        bytes = j0 + row < k2 ? fixed : 0;
        s = src + (size_t)(j0 + i * ROW_STEP) * wpitch;
        dst = tile + row * (BN + 32) + c * WV;
      }
      mmatile::cp_async<WV>(dst, bytes ? s : p, bytes);
    }
  }
};

template <int BM, int BN, int WM, int STAGES, bool TRANS, int WV, bool K1>
__global__ void __launch_bounds__((BM / WM) * (BN / 32) * 32)
int4h_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ p,
                 const float* __restrict__ scale,
                 const int* __restrict__ tile_gid, void* __restrict__ out,
                 int M, int N, int K, int lda, int wpitch, int groups,
                 int gsize, int bm) {
  static_assert(!(K1 && TRANS), "K1 takes the normal layout");
  using namespace mmatile;
  constexpr int WARPS_N = BN / 32;
  constexpr int THREADS = (BM / WM) * WARPS_N * 32;
  constexpr int MT = WM / 16;
  constexpr int A_BYTES = BM * kARow;
  constexpr int STAGE = A_BYTES + b_stage_bytes<TRANS, BN>();
  constexpr int PITCH_N = BN + 32;
  extern __shared__ __align__(16) char smem[];
  float* sc = reinterpret_cast<float*>(smem + STAGES * STAGE);  // [G][BN]

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  if constexpr (K1) {
    // grouped: the expert of the block's rows (BM divides bm)
    const size_t e = tile_gid[m0 / bm];
    p += e * (size_t)(K / 2) * wpitch;
    scale += e * groups * (size_t)N;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int k2 = K / 2;
  const int ktiles = (K + kBK - 1) / kBK;

  for (int i = threadIdx.x; i < groups * BN; i += THREADS) {
    const int n = n0 + i % BN;
    sc[i] = n < N ? scale[(size_t)(i / BN) * N + n] : 0.0f;
  }

  const ATileLoader<BM, THREADS> aload(x, 2 * (size_t)lda, M, m0);
  const BTileLoader<BN, THREADS, TRANS, WV> bload(p, N, wpitch, n0);
  auto load_stage = [&](int slot, int kt) {
    char* a = smem + slot * STAGE;
    aload.load(a, x, 2 * K, 2 * kt * kBK);
    bload.load(a + A_BYTES, p, k2, kt * (kBK / 2));
  };
  uint32_t a_off[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) a_off[s] = a_frag_offset(wm0, s);
  const uint32_t smem0 = smem_u32(smem);

  float acc[MT][4][4], tot[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = tot[i][j][c] = 0.0f;

  // tot += acc * scale[gg] over the thread's columns 8 t + (0..7) of the
  // warp (c0 / c2 of n-tile j: column 8 t + j; c1 / c3: 8 t + 4 + j): K9
  // one fmaf, K1 its plain version's separately rounded product and sum
  auto fold = [](float a, float s, float t) {
    return K1 ? __fadd_rn(t, __fmul_rn(a, s)) : fmaf(a, s, t);
  };
  auto flush = [&](int gg) {
    const float* s = sc + gg * BN + wn0 + 8 * t;
    const float4 lo = *reinterpret_cast<const float4*>(s);
    const float4 hi = *reinterpret_cast<const float4*>(s + 4);
    const float sv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tot[i][j][0] = fold(acc[i][j][0], sv[j], tot[i][j][0]);
        tot[i][j][1] = fold(acc[i][j][1], sv[4 + j], tot[i][j][1]);
        tot[i][j][2] = fold(acc[i][j][2], sv[j], tot[i][j][2]);
        tot[i][j][3] = fold(acc[i][j][3], sv[4 + j], tot[i][j][3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
      }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  int gid = 0, next_b = gsize;  // current group and the k where it ends
  const uint32_t tsel = (uint32_t)t | ((uint32_t)(t + 4) << 4);
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; the slot refilled below is free
    {
      const int nk = kt + STAGES - 1;
      if (nk < ktiles) load_stage(nk % STAGES, nk);
      cp_async_commit();
    }
    const int slot = kt % STAGES;
    const uint32_t a = smem0 + slot * STAGE;
    const char* b = smem + slot * STAGE + A_BYTES;
    const int k0 = kt * kBK;
    // the fragments of k-step s: A by ldmatrix, the packed B bytes raw
    // (transposed: 8 bytes of each n-tile's column; normal: the words of
    // packed rows 8 s + t and 8 s + 4 + t); the next step's are loaded
    // before this step's mma
    auto load_frags = [&](int s, uint32_t (&af)[MT][4], uint32_t (&bw)[4][2]) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], a + a_off[s] + i * 16 * kARow);
      if constexpr (TRANS) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint2 w = *reinterpret_cast<const uint2*>(
              b + (wn0 + 8 * j + g) * 48 + 8 * s);
          bw[j][0] = w.x;
          bw[j][1] = w.y;
        }
      } else {
        const char* col = b + wn0 + 4 * g;
        const char* row = col + (8 * s + t) * PITCH_N;
        bw[0][0] = *reinterpret_cast<const uint32_t*>(row);
        bw[0][1] = *reinterpret_cast<const uint32_t*>(row + 4 * PITCH_N);
      }
    };
    uint32_t afs[2][MT][4], bws[2][4][2];
    load_frags(0, afs[0], bws[0]);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int ks = k0 + 16 * s;
      if (ks >= K) break;
      if (s < 3) load_frags(s + 1, afs[(s + 1) & 1], bws[(s + 1) & 1]);
      const uint32_t (&af)[MT][4] = afs[s & 1];
      const uint32_t (&bw)[4][2] = bws[s & 1];
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t two =
            TRANS ? __byte_perm(bw[j][0], bw[j][1], tsel)
                  : __byte_perm(bw[0][0], bw[0][1], j | ((j + 4) << 4));
        nibbles_to_bf16x2(two, bf[j][0], bf[j][1]);
      }
      if (ks + 16 <= next_b) {  // the common case: one group
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
        if (ks + 16 == next_b) {
          flush(gid);
          ++gid;
          next_b += gsize;
        }
      } else {
        // a group ends inside the step: one pass per group, with the B
        // pairs (k = ks + 2t and ks + 8 + 2t) of the other groups zeroed
        const int end = min(ks + 16, K);
        for (int lo = ks; lo < end;) {
          const int hi = min(end, next_b);
          const int k_a = ks + 2 * t, k_b = ks + 8 + 2 * t;
          const bool keep_a = k_a >= lo && k_a < hi;
          const bool keep_b = k_b >= lo && k_b < hi;
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16(acc[i][j], af[i], keep_a ? bf[j][0] : 0u,
                       keep_b ? bf[j][1] : 0u);
          if (hi == next_b) {
            flush(gid);
            ++gid;
            next_b += gsize;
          }
          lo = hi;
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm0 + 16 * i + g + 8 * h;
      if (row >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = tot[i][j][2 * h];
        v[4 + j] = tot[i][j][2 * h + 1];
      }
      if constexpr (K1)
        store_row8_f32(static_cast<float*>(out), row, n0 + wn0 + 8 * t, N,
                       v);
      else
        store_row8_bf16(static_cast<__nv_bfloat16*>(out), row,
                        n0 + wn0 + 8 * t, N, v);
    }
}

template <int BM, int BN, int WM, int STAGES, bool TRANS, int WV,
          bool K1 = false>
int launch_mma(const __nv_bfloat16* x, const int8_t* p, const float* scale,
               void* out, int m, int n, int k, int lda, int wpitch,
               int groups, int gsize, cudaStream_t stream,
               const int* tile_gid = nullptr, int bm = 0) {
  constexpr int THREADS = (BM / WM) * (BN / 32) * 32;
  constexpr int STAGE = BM * mmatile::kARow + b_stage_bytes<TRANS, BN>();
  const size_t smem = (size_t)STAGES * STAGE + (size_t)groups * BN * 4;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = int4h_mma_kernel<BM, BN, WM, STAGES, TRANS, WV, K1>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(x, p, scale, tile_gid, out, m, n, k,
                                        lda, wpitch, groups, gsize, bm);
  return (int)cudaGetLastError();
}

}  // namespace i4mma
