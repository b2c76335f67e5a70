// moe_ffn_decode_int4h: the routed SwiGLU expert FFN of one decode step.
//
// Replaces the TPU kernel medplib_tpu/ops/pallas/moe_decode.py:
// moe_ffn_decode_int4h (_kernel). For expert e and decode rows x [B, H]:
//   g = (x[:, :H/2] @ Wg_lo) * sg[0] + (x[:, H/2:] @ Wg_hi) * sg[1]  (x row
//       scale applied in A8 mode); u likewise
//   act = silu(g) * u * (gate[b] if route_idx[b] == e else 0)
//   out += sum over 512-column blocks c of M (order e, j, nh as on the TPU
//          grid; c = nh * n_j + j):  act[:, c] @ Wd[c] * sd[nh]
// In A8 mode act is quantized to int8 per row PER BLOCK c of M (scale per
// row and block), exactly as the TPU kernel does, and each block's s32
// product is rescaled by its own scales before the f32 accumulation.
//
// Three launches, deterministic (fixed accumulation order, no atomics):
//   1. gate/up + SwiGLU + routing mask -> act f32 [E, Bp, M]
//      grid (M/64, E): every weight byte of gate and up is read once;
//   2. per-row-per-block quantization (A8) or bf16 rounding -> act_q;
//   3. down projection, grid (H/64): each block walks (e, j, nh) in order.
// Rows are padded to Bp in {16, 32, 64}; padded rows carry a zero gate.
//
// What bounds it on the H100: a decode step reads every expert byte of the
// layer once (flagship: 2 experts x 3 int4 matrices of 4096 x 11264, about
// 138 MB per layer) for 16 rows of math, so it is bound by HBM bandwidth.
// The design streams each packed byte exactly once with 16-byte loads and
// keeps the [B, M] intermediate (1.4 MB) on chip-adjacent L2; the down
// launch has only H/64 = 64 blocks, which is the first thing to widen.

#include "int4h_tile.cuh"

namespace {

using namespace int4h;

// jax.nn.silu's op sequence: g * (1 / (1 + exp(-g))), each op rounded
__device__ __forceinline__ float silu_f(float g) {
  return __fmul_rn(g, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));
}

template <bool A8, int TM>
__global__ void __launch_bounds__(kThreads)
gateup_kernel(const void* __restrict__ x, const float* __restrict__ xs,
              const int* __restrict__ route_idx,
              const float* __restrict__ route_gate,
              const int8_t* __restrict__ gp, const float* __restrict__ gs,
              const int8_t* __restrict__ up, const float* __restrict__ us,
              float* __restrict__ act, int H, int M) {
  __shared__ Smem sm;
  const int n0 = blockIdx.x * kTN;
  const int e = blockIdx.y;
  const size_t wofs = (size_t)e * (H / 2) * M;
  Acc<A8, TM> glo, ghi, ulo, uhi;
  glo.zero(); ghi.zero(); ulo.zero(); uhi.zero();
  tile_accum<A8, TM>(x, H, gp + wofs, M, n0, 0, H / 2, sm, glo);
  tile_accum<A8, TM>(x, H, gp + wofs, M, n0, H / 2, H, sm, ghi);
  tile_accum<A8, TM>(x, H, up + wofs, M, n0, 0, H / 2, sm, ulo);
  tile_accum<A8, TM>(x, H, up + wofs, M, n0, H / 2, H, sm, uhi);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* gs0 = gs + (size_t)e * 2 * M;
  const float* us0 = us + (size_t)e * 2 * M;
#pragma unroll
  for (int i = 0; i < Acc<A8, TM>::R; ++i) {
    const int r = ty + 16 * i;
    const float mask = route_idx[r] == e ? route_gate[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      float g = __fadd_rn(__fmul_rn((float)glo.v[i][j], gs0[n]),
                          __fmul_rn((float)ghi.v[i][j], gs0[M + n]));
      float u = __fadd_rn(__fmul_rn((float)ulo.v[i][j], us0[n]),
                          __fmul_rn((float)uhi.v[i][j], us0[M + n]));
      if constexpr (A8) {
        g = __fmul_rn(g, xs[r]);
        u = __fmul_rn(u, xs[r]);
      }
      act[((size_t)e * TM + r) * M + n] =
          __fmul_rn(__fmul_rn(silu_f(g), u), mask);
    }
  }
}

// grid (M / bn, Bp, E), 128 threads: one row's block of bn columns.
template <bool A8>
__global__ void quant_kernel(const float* __restrict__ act,
                             void* __restrict__ act_q,
                             float* __restrict__ act_s, int Bp, int M,
                             int bn) {
  const int c = blockIdx.x, r = blockIdx.y, e = blockIdx.z;
  const size_t row = ((size_t)e * Bp + r) * M + (size_t)c * bn;
  if constexpr (!A8) {
    for (int t = threadIdx.x; t < bn; t += blockDim.x)
      static_cast<__nv_bfloat16*>(act_q)[row + t] =
          __float2bfloat16_rn(act[row + t]);
    return;
  } else {
    __shared__ float red[32];
    float amax = 0.0f;
    for (int t = threadIdx.x; t < bn; t += blockDim.x)
      amax = fmaxf(amax, fabsf(act[row + t]));
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
    __syncthreads();
    if (threadIdx.x == 0) {
      float m = 0.0f;
      for (int w = 0; w < (int)(blockDim.x / 32); ++w) m = fmaxf(m, red[w]);
      // amax * f32(1/127), as XLA compiles the reference's / 127.0
      red[0] = __fmul_rn(fmaxf(m, 1e-12f), 1.0f / 127.0f);
    }
    __syncthreads();
    const float sc = red[0];
    for (int t = threadIdx.x; t < bn; t += blockDim.x) {
      float q = rintf(__fdiv_rn(act[row + t], sc));
      q = fminf(fmaxf(q, -127.0f), 127.0f);
      static_cast<int8_t*>(act_q)[row + t] = (int8_t)q;
    }
    if (threadIdx.x == 0) act_s[((size_t)e * Bp + r) * (M / bn) + c] = sc;
  }
}

template <bool A8, int TM>
__global__ void __launch_bounds__(kThreads)
down_kernel(const void* __restrict__ act_q, const float* __restrict__ act_s,
            const int8_t* __restrict__ dp, const float* __restrict__ ds,
            float* __restrict__ out, int H, int M, int E, int bn) {
  __shared__ Smem sm;
  const int n0 = blockIdx.x * kTN;
  const int n_j = M / 2 / bn;
  const int nblk = M / bn;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  Acc<false, TM> acc;
  acc.zero();
  for (int e = 0; e < E; ++e) {
    const void* xe =
        A8 ? (const void*)((const int8_t*)act_q + (size_t)e * TM * M)
           : (const void*)((const __nv_bfloat16*)act_q + (size_t)e * TM * M);
    const int8_t* we = dp + (size_t)e * (M / 2) * H;
    for (int j = 0; j < n_j; ++j) {
      for (int nh = 0; nh < 2; ++nh) {
        const int c = nh * n_j + j;
        Acc<A8, TM> part;
        part.zero();
        tile_accum<A8, TM>(xe, M, we, H, n0, c * bn, (c + 1) * bn, sm, part);
        const float* dsn = ds + ((size_t)e * 2 + nh) * H;
#pragma unroll
        for (int i = 0; i < Acc<A8, TM>::R; ++i) {
          const int r = ty + 16 * i;
          const float as =
              A8 ? act_s[((size_t)e * TM + r) * nblk + c] : 1.0f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int n = n0 + tx + 16 * jj;
            float p = (float)part.v[i][jj];
            if constexpr (A8) p = __fmul_rn(p, as);
            acc.v[i][jj] = __fadd_rn(acc.v[i][jj], __fmul_rn(p, dsn[n]));
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < Acc<false, TM>::R; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      out[(size_t)(ty + 16 * i) * H + n0 + tx + 16 * jj] = acc.v[i][jj];
}

template <bool A8, int TM>
int run(const void* x, const float* xs, const int* route_idx,
        const float* route_gate, const int8_t* gp, const float* gs,
        const int8_t* up, const float* us, const int8_t* dp, const float* ds,
        float* act, void* act_q, float* act_s, float* out, int h, int m,
        int e, int bn, cudaStream_t s) {
  gateup_kernel<A8, TM><<<dim3(m / kTN, e), kThreads, 0, s>>>(
      x, xs, route_idx, route_gate, gp, gs, up, us, act, h, m);
  int err = (int)cudaGetLastError();
  if (err) return err;
  quant_kernel<A8><<<dim3(m / bn, TM, e), 128, 0, s>>>(act, act_q, act_s, TM,
                                                      m, bn);
  err = (int)cudaGetLastError();
  if (err) return err;
  down_kernel<A8, TM><<<dim3(h / kTN), kThreads, 0, s>>>(act_q, act_s, dp, ds,
                                                        out, h, m, e, bn);
  return (int)cudaGetLastError();
}

template <bool A8>
int run_tm(int bp, const void* x, const float* xs, const int* route_idx,
           const float* route_gate, const int8_t* gp, const float* gs,
           const int8_t* up, const float* us, const int8_t* dp,
           const float* ds, float* act, void* act_q, float* act_s,
           float* out, int h, int m, int e, int bn, cudaStream_t s) {
  if (bp == 64)
    return run<A8, 64>(x, xs, route_idx, route_gate, gp, gs, up, us, dp, ds,
                       act, act_q, act_s, out, h, m, e, bn, s);
  if (bp == 32)
    return run<A8, 32>(x, xs, route_idx, route_gate, gp, gs, up, us, dp, ds,
                       act, act_q, act_s, out, h, m, e, bn, s);
  return run<A8, 16>(x, xs, route_idx, route_gate, gp, gs, up, us, dp, ds,
                     act, act_q, act_s, out, h, m, e, bn, s);
}

}  // namespace

// C entry point. bp in {16, 32, 64} rows (padded); x [bp, h] int8 (a8) or
// bf16; xs [bp] f32 row scales (a8); route_idx [bp] int32; route_gate [bp]
// f32; gate/up packed [e, h/2, m] int8 + scale [e, 2, 1, m] f32; down packed
// [e, m/2, h] int8 + scale [e, 2, 1, h] f32; scratch act f32 [e, bp, m],
// act_q [e, bp, m] (int8 when a8, else bf16), act_s f32 [e, bp, m/bn];
// out f32 [bp, h]. The caller checks shapes (h % 128 == 0, m % 128 == 0,
// bn | m/2, bn % 64 == 0), dtypes, contiguity and alignment.
extern "C" int moe_decode_int4h_launch(
    const void* x, const void* xs, const void* route_idx,
    const void* route_gate, const void* gp, const void* gs, const void* up,
    const void* us, const void* dp, const void* ds, void* act, void* act_q,
    void* act_s, void* out, int bp, int h, int m, int e, int bn, int a8,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a8)
    return run_tm<true>(bp, x, (const float*)xs, (const int*)route_idx,
                        (const float*)route_gate, (const int8_t*)gp,
                        (const float*)gs, (const int8_t*)up,
                        (const float*)us, (const int8_t*)dp,
                        (const float*)ds, (float*)act, act_q, (float*)act_s,
                        (float*)out, h, m, e, bn, s);
  return run_tm<false>(bp, x, (const float*)xs, (const int*)route_idx,
                       (const float*)route_gate, (const int8_t*)gp,
                       (const float*)gs, (const int8_t*)up, (const float*)us,
                       (const int8_t*)dp, (const float*)ds, (float*)act,
                       act_q, (float*)act_s, (float*)out, h, m, e, bn, s);
}
