// The MoE layer's prefill activations around the grouped matmuls (K1 / K3
// under W4A8 / W8A8), in int8: three passes of one data path.
//
// They replace no TPU kernel: in medplib_tpu/ops/moe.py:_gmm_ffn these are
// the elementwise ops around the Pallas gmm (quantize_rows, silu, the
// combine), which XLA fuses on the TPU. In PyTorch each op was its own
// pass over the S·k routed rows in f32 or bf16; here each row is read and
// written once.
//   1. moe_dispatch_quant_kernel: token t's row of x [S, H] quantized once
//      with ops/cuda/gmm.quantize_rows' numerics (s = max(amax, 1e-12) *
//      f32(1 / 127), q = clip(rint(x / s), -127, 127), IEEE division,
//      round half to even), the int8 row and s written to each of its k
//      aligned rows dest[t k + j] of xq [Sp, H] / xs [Sp]. Gap rows
//      (src[r] < 0) get zeros and the scale of a zero row, max(0, 1e-12) *
//      f32(1 / 127), as quantizing the zero-filled aligned buffer gave.
//   2. moe_swiglu_quant_kernel: the bf16 gate and up products h1, h2
//      [Sp, M] to the down projection's int8 rows and scales: act =
//      f32(silu(h1)) * f32(h2), silu in ops/moe._silu's op order with a
//      bf16 rounding after each op (exp(-g), 1 + e, 1 / d, g * r), the
//      product unrounded in f32, then the row quantization of 1.
//   3. moe_topk_combine_kernel: y[t] = the sum over j < k of
//      f32(y_al[dest[t k + j]]) * w[t, j], each product and sum rounded in
//      f32 in a fixed order (PyTorch's for a sum over a strided dim of k,
//      see the kernel), the total rounded once to out's dtype.
// No atomics: every output element is written by one thread in a fixed
// order, so the same inputs give the same bits.
//
// What bounds them on the H100: bytes. Each does a handful of flops an
// element (2's silu and two divisions the most), against 1-8 bytes moved
// an element; at DeepSeek-V2-Lite's prefill (S = 43,968 tokens, k = 6,
// Sp = 296,448 aligned rows, H = 2048, M = 1536) the three move ~0.79,
// ~2.28 and ~1.26 GB a layer. The designs read each input row once (16-
// byte loads, eight or sixteen elements a thread) and write each output
// row once (8- or 16-byte stores):
//   1. one block a token: the row read (amax), reduced in the block, read
//      again from L1 to quantize; the packed int8 written k times, once
//      for each of the token's aligned rows. Blocks after the S token
//      blocks write the gap rows, 64 rows a block, one warp a row.
//   2. one block a row (up to 1024 threads), the row in registers: each
//      thread keeps its one or two chunks of eight act values between the
//      amax and the quantization.
//   3. one block a token: each of the token's k rows read once, eight
//      columns a thread, four rows' loads in flight, summed in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kDispatchThreads = 128;   // 16 elements a thread a step
constexpr int kGapRows = 64;            // gap rows a block, 16 a warp

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// quantize_rows' scale of a row whose largest |value| is amax
__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
}

// clip(rint(v / sc), -127, 127) with the IEEE quotient, from t = v * inv
// (inv = 1 / sc rounded): |t - v / sc| < 2^-15 where |v / sc| <= 128, so
// t rounds to the quotient's integer unless it lies within 2^-10 of a
// half, where the quotient itself is taken
__device__ __forceinline__ uint32_t quant1(float v, float sc, float inv) {
  const float t = __fmul_rn(v, inv);
  int q = __float2int_rn(t);
  if (fabsf(fabsf(t - rintf(t)) - 0.5f) < 1.0f / 1024.0f)
    q = __float2int_rn(__fdiv_rn(v, sc));
  return (uint32_t)(uint8_t)(int8_t)max(-127, min(127, q));
}

// four values -> four int8 packed little-endian in a word
__device__ __forceinline__ uint32_t quant4(const float* v, float sc,
                                           float inv) {
  return quant1(v[0], sc, inv) | quant1(v[1], sc, inv) << 8 |
         quant1(v[2], sc, inv) << 16 | quant1(v[3], sc, inv) << 24;
}

// the largest of every thread's v (blockDim.x a multiple of 32, <= 1024)
__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[32];
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float m = 0.0f;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) m = fmaxf(m, red[w]);
  return m;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ops/moe._silu on a bf16 value: g * (1 / (1 + exp(-g))), each op rounded
// to bf16 (PyTorch's bf16 ops compute in f32 and round the result)
__device__ __forceinline__ float silu_bf16(float g) {
  const float e = bf16_round(expf(-g));
  const float d = bf16_round(__fadd_rn(1.0f, e));
  const float r = bf16_round(__frcp_rn(d));
  return bf16_round(__fmul_rn(g, r));
}

// 1. grid (S + ceil(Sp / kGapRows)), kDispatchThreads threads. x [S, H]
// (T = bf16 or f32), dest [S k] int32 (the aligned row of token t's j-th
// expert at t k + j), src [Sp] int32 (the routed row in aligned row r, -1
// for a gap); xq [Sp, H] int8, xs [Sp] f32. H % 16 == 0.
template <typename T>
__global__ void __launch_bounds__(kDispatchThreads)
moe_dispatch_quant_kernel(const T* __restrict__ x,
                          const int* __restrict__ dest,
                          const int* __restrict__ src,
                          int8_t* __restrict__ xq, float* __restrict__ xs,
                          int S, int H, int k, int Sp) {
  const int b = blockIdx.x;
  if (b >= S) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r0 = (b - S) * kGapRows;
    for (int r = r0 + warp; r < min(r0 + kGapRows, Sp);
         r += kDispatchThreads / 32) {
      if (__ldg(src + r) >= 0) continue;
      int8_t* o = xq + (size_t)r * H;
      for (int i = 16 * lane; i < H; i += 16 * 32)
        *reinterpret_cast<uint4*>(o + i) = make_uint4(0, 0, 0, 0);
      if (lane == 0) xs[r] = row_scale(0.0f);
    }
    return;
  }
  const T* xr = x + (size_t)b * H;
  const int step = 16 * kDispatchThreads;
  float amax = 0.0f;
  for (int i = 16 * threadIdx.x; i < H; i += step) {
    float v[8], u[8];
    load8(xr + i, v);
    load8(xr + i + 8, u);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      amax = fmaxf(amax, fmaxf(fabsf(v[c]), fabsf(u[c])));
  }
  const float sc = row_scale(block_max(amax)), inv = __frcp_rn(sc);
  for (int i = 16 * threadIdx.x; i < H; i += step) {
    float v[8], u[8];
    load8(xr + i, v);
    load8(xr + i + 8, u);
    const uint4 q = make_uint4(quant4(v, sc, inv), quant4(v + 4, sc, inv),
                               quant4(u, sc, inv), quant4(u + 4, sc, inv));
    for (int j = 0; j < k; ++j)
      *reinterpret_cast<uint4*>(xq + (size_t)__ldg(dest + b * k + j) * H +
                                i) = q;
  }
  if (threadIdx.x < k) xs[__ldg(dest + b * k + threadIdx.x)] = sc;
}

// 2. grid (rows), blockDim.x threads, each holding C chunks of eight act
// values: chunk c of thread t covers columns 8 (t + c blockDim.x) .. + 7.
// h1, h2 [rows, M] bf16; q [rows, M] int8, qs [rows] f32. M % 8 == 0,
// M <= 8 C blockDim.x.
template <int C>
__global__ void __launch_bounds__(1024)
moe_swiglu_quant_kernel(const __nv_bfloat16* __restrict__ h1,
                        const __nv_bfloat16* __restrict__ h2,
                        int8_t* __restrict__ q, float* __restrict__ qs,
                        int M) {
  const size_t row = (size_t)blockIdx.x * M;
  float act[C][8];
  float amax = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = 8 * (threadIdx.x + c * blockDim.x);
    if (i < M) {
      float g[8], u[8];
      load8(h1 + row + i, g);
      load8(h2 + row + i, u);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        act[c][e] = __fmul_rn(silu_bf16(g[e]), u[e]);
        amax = fmaxf(amax, fabsf(act[c][e]));
      }
    }
  }
  const float sc = row_scale(block_max(amax)), inv = __frcp_rn(sc);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = 8 * (threadIdx.x + c * blockDim.x);
    if (i < M)
      *reinterpret_cast<uint2*>(q + row + i) = make_uint2(
          quant4(act[c], sc, inv), quant4(act[c] + 4, sc, inv));
  }
  if (threadIdx.x == 0) qs[blockIdx.x] = sc;
}

// 3. grid (S), blockDim.x threads, eight columns a thread a step. y_al
// [Sp, H] (TI = bf16 or f32), dest [S k] int32, w [S k] f32; out [S, H]
// (TO = bf16 or f32). H % 8 == 0. The k products p_j are summed in the
// order of PyTorch's CUDA sum over a strided dim of k when one thread
// takes a whole output (its ReduceOp::thread_reduce_impl, vt0 = 4): four
// accumulators from 0, a[j % 4] += p_j for j = 0 .. k-1, then ((a0 + a1)
// + a2) + a3. For k = 6: (((p0 + p4) + (p1 + p5)) + p2) + p3.
template <typename TI, typename TO>
__global__ void __launch_bounds__(256)
moe_topk_combine_kernel(const TI* __restrict__ y_al,
                        const int* __restrict__ dest,
                        const float* __restrict__ w, TO* __restrict__ out,
                        int H, int k) {
  const int t = blockIdx.x;
  for (int i = 8 * threadIdx.x; i < H; i += 8 * blockDim.x) {
    float a[4][8] = {};
    for (int j0 = 0; j0 < k; j0 += 4) {
      float v[4][8], wj[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (j0 + jj < k) {
          const int e = t * k + j0 + jj;
          wj[jj] = __ldg(w + e);
          load8(y_al + (size_t)__ldg(dest + e) * H + i, v[jj]);
        }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (j0 + jj < k) {
#pragma unroll
          for (int c = 0; c < 8; ++c)
            a[jj][c] = __fadd_rn(a[jj][c], __fmul_rn(v[jj][c], wj[jj]));
        }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
      a[0][c] = __fadd_rn(__fadd_rn(__fadd_rn(a[0][c], a[1][c]), a[2][c]),
                          a[3][c]);
    store8(out + (size_t)t * H + i, a[0]);
  }
}

// threads a block for rows of n elements taken eight a thread: a warp
// multiple, at most `cap`
int threads_for(int n, int cap) {
  const int t = (n / 8 + 31) / 32 * 32;
  return t < 32 ? 32 : t > cap ? cap : t;
}

template <int C>
int swiglu(const void* h1, const void* h2, void* q, void* qs, int rows,
           int m, int nt, cudaStream_t s) {
  moe_swiglu_quant_kernel<C><<<rows, nt, 0, s>>>(
      static_cast<const __nv_bfloat16*>(h1),
      static_cast<const __nv_bfloat16*>(h2), static_cast<int8_t*>(q),
      static_cast<float*>(qs), m);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int combine(const void* y_al, const void* dest, const void* w, void* out,
            int s, int h, int k, cudaStream_t st) {
  moe_topk_combine_kernel<TI, TO><<<s, threads_for(h, 256), 0, st>>>(
      static_cast<const TI*>(y_al), static_cast<const int*>(dest),
      static_cast<const float*>(w), static_cast<TO*>(out), h, k);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points. The caller checks shapes, dtypes, contiguity and 16-byte
// alignment; each returns the cudaError_t of its one launch.

// x [s, h] (f32 when x_f32, else bf16), dest [s k] int32, src [sp] int32;
// xq [sp, h] int8, xs [sp] f32. h % 16 == 0.
extern "C" int moe_dispatch_quant_launch(const void* x, const void* dest,
                                         const void* src, void* xq, void* xs,
                                         int s, int h, int k, int sp,
                                         int x_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = s + (sp + kGapRows - 1) / kGapRows;
  const int* d = static_cast<const int*>(dest);
  const int* r = static_cast<const int*>(src);
  int8_t* q = static_cast<int8_t*>(xq);
  float* sc = static_cast<float*>(xs);
  if (x_f32)
    moe_dispatch_quant_kernel<float><<<grid, kDispatchThreads, 0, st>>>(
        static_cast<const float*>(x), d, r, q, sc, s, h, k, sp);
  else
    moe_dispatch_quant_kernel<__nv_bfloat16>
        <<<grid, kDispatchThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x), d, r, q, sc, s, h, k, sp);
  return (int)cudaGetLastError();
}

// h1, h2 [rows, m] bf16; q [rows, m] int8, qs [rows] f32. m % 8 == 0,
// m <= 16384: up to 1024 threads a row (a wide row, such as the
// flagship's 11264, then keeps one or two chunks a thread in registers).
extern "C" int moe_swiglu_quant_launch(const void* h1, const void* h2,
                                       void* q, void* qs, int rows, int m,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = threads_for(m, 1024);
  const int chunks = (m / 8 + nt - 1) / nt;
  if (chunks <= 1) return swiglu<1>(h1, h2, q, qs, rows, m, nt, st);
  if (chunks <= 2) return swiglu<2>(h1, h2, q, qs, rows, m, nt, st);
  return (int)cudaErrorInvalidValue;
}

// y_al [sp, h] (f32 when in_f32, else bf16), dest [s k] int32, w [s k]
// f32; out [s, h] (f32 when out_f32, else bf16). h % 8 == 0.
extern "C" int moe_topk_combine_launch(const void* y_al, const void* dest,
                                       const void* w, void* out, int s,
                                       int h, int k, int in_f32, int out_f32,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_f32)
    return out_f32
               ? combine<float, float>(y_al, dest, w, out, s, h, k, st)
               : combine<float, __nv_bfloat16>(y_al, dest, w, out, s, h, k,
                                               st);
  return out_f32
             ? combine<__nv_bfloat16, float>(y_al, dest, w, out, s, h, k, st)
             : combine<__nv_bfloat16, __nv_bfloat16>(y_al, dest, w, out, s,
                                                     h, k, st);
}
