// Causal flash attention with a [B, S] keep mask: forward (K4) and the two
// backward passes (K5 dQ, K6 dK/dV).
//
// Replaces the TPU kernels of medplib_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel (f32), flash_fwd_mma_kernel (bf16)
//                     <- _flash_forward / _flash_kernel   (pallas_call :138)
//   flash_dq_kernel (f32), flash_dq_mma_kernel (bf16)
//                     <- _dq_kernel                        (pallas_call :306)
//   flash_dkv_kernel (f32), flash_dkv_mma_kernel (bf16)
//                     <- _dkv_kernel                       (pallas_call :333)
//
// Layouts are the model's: q / out / dout [B, T, H, D], k / v [B, S, H, D]
// (heads already repeated for GQA), mask [B, S] int32 (> 0 keeps a key),
// lse / delta [B, H, T] f32. D = 128. Queries are the last T positions of
// the key axis (q_offset = S - T); a key column is kept for query row t when
// t + q_offset >= column, column < S and mask[b, column] > 0.
//
// Semantics kept from the Pallas kernels:
// - q is scaled by D^-0.5 in f32 before the dot;
// - masked scores are the finite NEG_INF, so a row with no kept key gets
//   p = exp(0) over the processed key tiles: its output depends on the tile
//   schedule, but is finite;
// - out = acc / max(l, 1e-30) in the input type, lse = m + log(max(l, 1e-30))
//   of the scaled logits;
// - the backward recomputes p = keep ? exp(s - lse) : 0 (zero, not the
//   sentinel), dS = p * (dP - delta), dQ = dS K * scale, dK = dS^T (q scale),
//   dV = P^T dO, with delta = rowsum(dO * O) computed by the caller.
//
// On bf16 all three run on the tensor cores (flash_fwd_mma_kernel,
// flash_dq_mma_kernel, flash_dkv_mma_kernel; their design beside them).
// On f32 (a bf16 mma would round f32 q, k, v) they are the first, simple
// version: one block of 256 threads per (b*h, 64-row tile). K4 and K5: a
// query tile, looping over 64-key tiles up to the causal diagonal; K6: a
// key tile, looping over the query tiles from the diagonal down. The
// scaled Q tile and the K / V / dO tiles are kept in shared memory with a
// row pitch of D + 4 floats, so that the 16-byte reads of 16 different rows
// hit distinct banks. Each thread owns a
// 4 x 4 patch of the 64 x 64 score tile (rows ty + 16 i, columns tx + 16 j)
// and a 4 x 8 patch of the 64 x 128 accumulators (rows ty + 16 i, columns
// 4 tx + {0..3} and 64 + 4 tx + {0..3}). Row max and row sum reduce over the
// 16 lanes of a row with shuffles. Everything is f32 FMA on the CUDA cores;
// no atomics, so results are deterministic. The ragged tail (T = 1087 is no
// multiple of 64) is handled by zero-filled loads and guarded stores.
//
// What bounds it on the H100: at the training shape (B = 8, T = S = 1087,
// H = 32, D = 128, bf16) the causal forward does ~7.7e10 FLOP over ~286 MB
// of q / k / v / out: ~0.085 ms for the bytes at 3.35 TB/s, ~0.078 ms for
// the FLOP on bf16 tensor cores. The backward passes redo the scores and
// add two (dQ) or three (dK, dV) products: ~1.2e11 and ~1.5e11 FLOP, bound
// by operations. On f32 the kernels run f32 CUDA-core FMA (67 TFLOP/s
// peak), far above those floors; on bf16 they run bf16 mma.sync with the
// non-bf16 operand (P or dS) split hi + lo: 6 D (K4), 8 D (K5) and 12 D
// (K6) mma FLOP a kept pair against the 4 D, 6 D and 8 D counted above.
// wgmma and TMA loads are later work.
//
// K4 on bf16 is a template over the q / k and v head sizes: <128, 128>,
// and <192, 128> for DeepSeek-V2's multi-head latent attention in its
// expanded form (q / k = 128 "nope" + 64 rope dims, v = 128; no TPU
// kernel of the JAX package has it, which has no MLA). Rows of 192 bf16
// are 24 chunks of 16 bytes; the swizzle XORs the chunk with the row's
// low 3 bits, so each aligned group of 8 chunks maps onto itself and an
// ldmatrix phase still hits 8 distinct 16-byte bank groups. What bounds
// it at the serving shape (B = 64, T = S = 623-687, 16 heads): the bytes
// of q and k at 192 and v and out at 128 (~0.27 ms at 3.35 TB/s) against
// ~2·192 + 2·128 FLOP a kept pair and head (~0.1 ms on bf16 tensor cores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tile.cuh"

namespace {

constexpr int kD = 128;
constexpr int kBM = 64;                 // query rows per tile
constexpr int kBN = 64;                 // key rows per tile
constexpr int kPitch = kD + 4;          // shared row pitch (elements)
constexpr int kSP = kBN + 4;            // score tile pitch
constexpr int kThreads = 256;
constexpr float kNegInf = -2.3819763e38f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy8(float (&acc)[8], float a, float4 x0,
                                      float4 x1) {
  acc[0] = fmaf(a, x0.x, acc[0]);
  acc[1] = fmaf(a, x0.y, acc[1]);
  acc[2] = fmaf(a, x0.z, acc[2]);
  acc[3] = fmaf(a, x0.w, acc[3]);
  acc[4] = fmaf(a, x1.x, acc[4]);
  acc[5] = fmaf(a, x1.y, acc[5]);
  acc[6] = fmaf(a, x1.z, acc[6]);
  acc[7] = fmaf(a, x1.w, acc[7]);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 64 rows [r0, r0 + 64) of a sequence (row r at g + r * stride, rows >= n
// read as zero) -> shared tile with pitch kPitch, raw copy in the input type.
template <typename T>
__device__ __forceinline__ void load_rows(T* s, const T* g, size_t stride,
                                          int r0, int n) {
  constexpr int kEpc = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int kCpr = kD / kEpc;        // chunks per row
  for (int c = threadIdx.x; c < 64 * kCpr; c += kThreads) {
    const int r = c / kCpr, col = (c % kCpr) * kEpc;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      u = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + r) * stride + col);
    uint2* dst = reinterpret_cast<uint2*>(s + r * kPitch + col);
    dst[0] = make_uint2(u.x, u.y);
    dst[1] = make_uint2(u.z, u.w);
  }
}

// The same for a query tile, widened to f32 and multiplied by `scale`.
template <typename T>
__device__ __forceinline__ void load_q_scaled(float* s, const T* g,
                                              size_t stride, int r0, int n,
                                              float scale) {
  constexpr int kCpr = kD / 4;
  for (int c = threadIdx.x; c < 64 * kCpr; c += kThreads) {
    const int r = c / kCpr, col = (c % kCpr) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) {
      x = ld4(g + (size_t)(r0 + r) * stride + col);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    st4(s + r * kPitch + col, x);
  }
}

// acc[i][jj] += <A row (ty + 16 i), B row (tx + 16 jj)> over D.
template <typename TA, typename TB>
__device__ __forceinline__ void tile_dot(const TA* a, const TB* b, int ty,
                                         int tx, float (&acc)[4][4]) {
#pragma unroll 2
  for (int d = 0; d < kD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + (ty + 16 * i) * kPitch + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(b + (tx + 16 * j) * kPitch + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][:] += sum_r W(row_i, r) * X[r][4 tx + {0..3}, 64 + 4 tx + {0..3}]
// over the 64 rows r of X, with row_i = ty + 16 i and W read from a score
// tile: W(row, r) = w[row][r], or w[r][row] when kTransposedW.
template <typename TX, bool kTransposedW>
__device__ __forceinline__ void tile_axpy(const float* w, const TX* x, int ty,
                                          int tx, float (&acc)[4][8]) {
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    const float4 x0 = ld4(x + r * kPitch + tx * 4);
    const float4 x1 = ld4(x + r * kPitch + 64 + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const float a = kTransposedW ? w[r * kSP + row] : w[row * kSP + r];
      axpy8(acc[i], a, x0, x1);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_row8(T* dst, int tx, const float* v,
                                           float mul) {
  st4(dst + tx * 4, make_float4(v[0] * mul, v[1] * mul, v[2] * mul,
                                v[3] * mul));
  st4(dst + 64 + tx * 4, make_float4(v[4] * mul, v[5] * mul, v[6] * mul,
                                     v[7] * mul));
}

// ---------------------------------------------------------------------------
// K4: forward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int t_len,
                 int s_len, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  T* skv = reinterpret_cast<T*>(smem + kBM * kPitch * sizeof(float));
  float* sp = reinterpret_cast<float*>(smem + kBM * kPitch * sizeof(float) +
                                       kBN * kPitch * sizeof(T));

  // heaviest (longest causal row) tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q_off = s_len - t_len;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t stride = (size_t)heads * kD;
  const T* qg = q + ((size_t)b * t_len * heads + h) * kD;
  const T* kg = k + ((size_t)b * s_len * heads + h) * kD;
  const T* vg = v + ((size_t)b * s_len * heads + h) * kD;
  const int* mg = mask + (size_t)b * s_len;

  load_q_scaled(sq, qg, stride, q0, t_len, scale);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  // key tiles whose first column is <= the tile's last query row
  const int last_row = q0 + q_off + kBM - 1;
  const int n_kt = min((s_len + kBN - 1) / kBN, last_row / kBN + 1);
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kBN;
    __syncthreads();                      // done with the previous V tile
    load_rows(skv, kg, stride, k0, s_len);
    __syncthreads();

    float s[4][4] = {};
    tile_dot(sq, skv, ty, tx, s);

    bool col_ok[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = k0 + tx + 16 * jj;
      col_ok[jj] = col < s_len && mg[col] > 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + q_off + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (!(col_ok[jj] && row >= k0 + tx + 16 * jj)) s[i][jj] = kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        rs += p;
        sp[(ty + 16 * i) * kSP + tx + 16 * jj] = p;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();                      // P written, K tile no longer read
    load_rows(skv, vg, stride, k0, s_len);
    __syncthreads();
    tile_axpy<T, false>(sp, skv, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t_len) continue;
    const float lm = fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * t_len + row) * heads + h) * kD;
    float r[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) r[c] = acc[i][c] / lm;
    store_row8(o, tx, r, 1.f);
    if (tx == 0) lse[(size_t)bh * t_len + row] = m[i] + logf(lm);
  }
}

// ---------------------------------------------------------------------------
// K5: dQ
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ mask,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq,
                int t_len, int s_len, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  unsigned char* p = smem + kBM * kPitch * sizeof(float);
  T* sdo = reinterpret_cast<T*>(p);
  T* sk = sdo + kBM * kPitch;
  T* sv = sk + kBN * kPitch;
  float* sds = reinterpret_cast<float*>(sv + kBN * kPitch);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q_off = s_len - t_len;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t stride = (size_t)heads * kD;
  const size_t qbase = ((size_t)b * t_len * heads + h) * kD;
  const T* kg = k + ((size_t)b * s_len * heads + h) * kD;
  const T* vg = v + ((size_t)b * s_len * heads + h) * kD;
  const int* mg = mask + (size_t)b * s_len;

  load_q_scaled(sq, q + qbase, stride, q0, t_len, scale);
  load_rows(sdo, dout + qbase, stride, q0, t_len);
  float lr[4], dr[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = row < t_len ? lse[(size_t)bh * t_len + row] : 0.f;
    dr[i] = row < t_len ? delta[(size_t)bh * t_len + row] : 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  const int last_row = q0 + q_off + kBM - 1;
  const int n_kt = min((s_len + kBN - 1) / kBN, last_row / kBN + 1);
  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kBN;
    __syncthreads();
    load_rows(sk, kg, stride, k0, s_len);
    load_rows(sv, vg, stride, k0, s_len);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot(sq, sk, ty, tx, s);
    tile_dot(sdo, sv, ty, tx, dp);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = k0 + tx + 16 * jj;
      const bool col_ok = col < s_len && mg[col] > 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool keep = col_ok && q0 + q_off + ty + 16 * i >= col;
        const float pr = keep ? expf(s[i][jj] - lr[i]) : 0.f;
        sds[(ty + 16 * i) * kSP + tx + 16 * jj] = pr * (dp[i][jj] - dr[i]);
      }
    }
    __syncthreads();
    tile_axpy<T, false>(sds, sk, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < t_len)
      store_row8(dq + qbase + (size_t)row * stride, tx, acc[i], scale);
  }
}

// ---------------------------------------------------------------------------
// K6: dK, dV
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ mask,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int t_len, int s_len, int heads,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sds = sq + kBM * kPitch;
  float* sl = sds + kBM * kSP;
  float* sd = sl + kBM;
  T* sk = reinterpret_cast<T*>(sd + kBM);
  T* sv = sk + kBN * kPitch;
  T* sdo = sv + kBN * kPitch;

  const int k0 = blockIdx.x * kBN;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q_off = s_len - t_len;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t stride = (size_t)heads * kD;
  const size_t qbase = ((size_t)b * t_len * heads + h) * kD;
  const size_t kbase = ((size_t)b * s_len * heads + h) * kD;
  const int* mg = mask + (size_t)b * s_len;

  load_rows(sk, k + kbase, stride, k0, s_len);
  load_rows(sv, v + kbase, stride, k0, s_len);
  bool col_ok[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int col = k0 + tx + 16 * jj;
    col_ok[jj] = col < s_len && mg[col] > 0;
  }
  float dka[4][8], dva[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int n_qt = (t_len + kBM - 1) / kBM;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBM;
    // this query tile reaches the key tile only if its last row does
    if (q0 + q_off + kBM - 1 < k0) continue;
    __syncthreads();
    load_q_scaled(sq, q + qbase, stride, q0, t_len, scale);
    load_rows(sdo, dout + qbase, stride, q0, t_len);
    if (tid < kBM) {
      const int row = q0 + tid;
      sl[tid] = row < t_len ? lse[(size_t)bh * t_len + row] : 0.f;
      sd[tid] = row < t_len ? delta[(size_t)bh * t_len + row] : 0.f;
    }
    __syncthreads();

    // scores in [query row, key column] orientation
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot(sq, sk, ty, tx, s);
    tile_dot(sdo, sv, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const bool row_ok = q0 + r < t_len;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bool keep = row_ok && col_ok[jj] &&
                          q0 + q_off + r >= k0 + tx + 16 * jj;
        const float pr = keep ? expf(s[i][jj] - sl[r]) : 0.f;
        sds[r * kSP + tx + 16 * jj] = pr;
        dp[i][jj] = pr * (dp[i][jj] - sd[r]);
      }
    }
    __syncthreads();
    tile_axpy<T, true>(sds, sdo, ty, tx, dva);     // dV += P^T dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        sds[(ty + 16 * i) * kSP + tx + 16 * jj] = dp[i][jj];
    __syncthreads();
    tile_axpy<float, true>(sds, sq, ty, tx, dka);  // dK += dS^T (q scale)
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= s_len) continue;
    store_row8(dk + kbase + (size_t)row * stride, tx, dka[i], 1.f);
    store_row8(dv + kbase + (size_t)row * stride, tx, dva[i], 1.f);
  }
}

// ---------------------------------------------------------------------------
// K6 on bf16: dK, dV on the tensor cores
// ---------------------------------------------------------------------------
//
// One block of 4 warps per (b*h, 64-key tile); warp w owns keys 16 w ..
// 16 w + 15 of the tile and their dK / dV rows (16 x 128 f32 each, in
// registers: 128 accumulators a thread). Query tiles of 64 rows stream
// through a 2-stage cp.async ring (Q, dO, lse, delta), from the first one
// that reaches the key tile (the causal skip). All products are bf16
// mma.sync m16n8k16 with f32 sums, in [key, query] orientation:
//   S^T  = K Q^T     A: the warp's K rows (ldmatrix), B: Q rows as the
//   dP^T = V dO^T       .col operand (ldmatrix), kDkvQS queries a step
//   P^T  = keep ? exp(S^T * scale - lse) : 0      (the scale on the f32
//   dS^T = P^T * (dP^T - delta)                   sum: bf16 q * scale
//   dV  += P^T dO    A: P^T's C fragments            would round)
//   dK  += dS^T Q    B: dO / Q rows by ldmatrix.trans; dK * scale at the end
// The m16n8 C fragments of two neighbouring query n-tiles (rows g, g + 8,
// columns 2t, 2t + 1) are the m16k16 A fragment of those 16 queries, so
// P^T and dS^T feed the second products from registers.
// q, k, v and dO are exact bf16 operands; P and dS are not bf16 values.
// Each is split, hi = bf16(x), lo = bf16(x - hi), and both halves run an
// mma against the same B: the product keeps ~2^-17 of x (one bf16
// rounding would be 2^-9), inside the f32 summation-order noise of the
// reference's f32 products (12 D mma FLOP per kept pair instead of 8 D).
// Tiles are [row][128 d] bf16, 256 bytes a row, 16-byte chunk c of row r
// at c ^ (r & 7): the eight rows of an ldmatrix phase (plain or .trans)
// fall in distinct banks. No atomics: deterministic.

constexpr int kRowB = kD * 2;                        // bytes of a bf16 row
constexpr int kTileB = 64 * kRowB;                   // a 64-row tile
constexpr int kMmaThreads = 128;
constexpr int kDkvStage = 2 * kTileB + 2 * 64 * 4;   // Q, dO, lse, delta
constexpr int kDkvSmem = 2 * kTileB + 2 * kDkvStage;  // + K, V
// queries a sub-step: 16 keeps the kernel at 247 registers; at 32 or 64
// ptxas spills (~20 bytes at 255 registers) for a few % of speed
constexpr int kDkvQS = 16;

// smem byte offset of 16-byte chunk c of row r of a swizzled tile of
// D-wide bf16 rows
template <int D = kD>
__device__ __forceinline__ int swz(int r, int c) {
  return r * (2 * D) + ((c ^ (r & 7)) << 4);
}

// 64 rows [r0, r0 + 64) of a bf16 sequence (row r at g + r * stride) -> a
// swizzled tile by cp.async; rows >= n are zero. The thread copies chunk
// c of rows r, r + 8, ..: one source pointer stepped by 8 rows, so no
// per-copy addresses stay live in registers across the query loop.
// Rows of D != 128 (24 chunks at 192): the thread copies chunks
// threadIdx.x + 128 i of the tile in row-major chunk order.
template <int D = kD>
__device__ __forceinline__ void copy_tile(unsigned char* tile,
                                          const __nv_bfloat16* g,
                                          size_t stride, int r0, int n) {
  constexpr int kCpr = D / 8;  // 16-byte chunks a row
  if constexpr (kCpr == 16) {
    constexpr int kStep = kMmaThreads / 16;
    const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
    const __nv_bfloat16* src = g + (size_t)(r0 + r) * stride + 8 * c;
#pragma unroll
    for (int i = 0; i < 64 / kStep; ++i, src += kStep * stride) {
      const bool ok = r0 + r + i * kStep < n;
      mmatile::cp_async<16>(tile + swz(r + i * kStep, c), ok ? src : g,
                            ok ? 16 : 0);
    }
  } else {
    static_assert(64 * kCpr % kMmaThreads == 0, "whole chunks a thread");
#pragma unroll
    for (int i = 0; i < 64 * kCpr / kMmaThreads; ++i) {
      const int id = threadIdx.x + i * kMmaThreads;
      const int r = id / kCpr, c = id % kCpr;
      const bool ok = r0 + r < n;
      mmatile::cp_async<16>(tile + swz<D>(r, c),
                            ok ? g + (size_t)(r0 + r) * stride + 8 * c : g,
                            ok ? 16 : 0);
    }
  }
}

// The lane's ldmatrix.x4 offset for tile rows r0 .. r0 + 16 (r0 % 8 == 0),
// d chunks 2 s, 2 s + 1 (d 16 s .. 16 s + 16): lanes 0-15 address the rows
// at chunk 2 s, lanes 16-31 at 2 s + 1. Plain: the A fragment of those
// rows, or {b0, b0', b1, b1'} of the n-tiles rows r0.., r0 + 8..; .trans
// (rows = k): {b0, b1} of d n-tile 2 s, then of 2 s + 1.
template <int D = kD>
__device__ __forceinline__ uint32_t frag(int r0, int s) {
  const int lane = threadIdx.x & 31;
  return swz<D>(r0 + (lane & 15), 2 * s + (lane >> 4));
}

// acc[j] = the warp's 16 rows of tile a (at a_r0) . tile rows b_r0 + 8 j
// of tile b, over D: NQ n-tiles of m16n8k16.
template <int NQ, int D = kD>
__device__ __forceinline__ void rows_dot(uint32_t a, int a_r0, uint32_t b,
                                         int b_r0, float (&acc)[NQ][4]) {
#pragma unroll
  for (int j = 0; j < NQ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    uint32_t af[4];
    mmatile::ldmatrix_x4(af, a + frag<D>(a_r0, s));
#pragma unroll
    for (int h = 0; h < NQ / 2; ++h) {
      uint32_t bf[4];
      mmatile::ldmatrix_x4(bf, b + frag<D>(b_r0 + 16 * h, s));
      mmatile::mma_bf16(acc[2 * h], af, bf[0], bf[2]);
      mmatile::mma_bf16(acc[2 * h + 1], af, bf[1], bf[3]);
    }
  }
}

// (x, y) -> bf16x2 hi = (bf16(x), bf16(y)) and lo = the rounded remainders
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc[D / 8 d n-tiles] += X . tile rows b_r0 .. b_r0 + 8 NQ of b
// ([query][d]), X the warp's 16 x 8 NQ values as C fragments, split
// hi + lo.
template <int NQ, int D = kD>
__device__ __forceinline__ void axpy_split(const float (&x)[NQ][4],
                                           uint32_t b, int b_r0,
                                           float (&acc)[D / 8][4]) {
#pragma unroll
  for (int kq = 0; kq < NQ / 2; ++kq) {
    uint32_t hi[4], lo[4];
    split2(x[2 * kq][0], x[2 * kq][1], hi[0], lo[0]);
    split2(x[2 * kq][2], x[2 * kq][3], hi[1], lo[1]);
    split2(x[2 * kq + 1][0], x[2 * kq + 1][1], hi[2], lo[2]);
    split2(x[2 * kq + 1][2], x[2 * kq + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int p = 0; p < D / 16; ++p) {
      uint32_t bf[4];
      mmatile::ldmatrix_x4_trans(bf, b + frag<D>(b_r0 + 16 * kq, p));
      mmatile::mma_bf16(acc[2 * p], hi, bf[0], bf[1]);
      mmatile::mma_bf16(acc[2 * p], lo, bf[0], bf[1]);
      mmatile::mma_bf16(acc[2 * p + 1], hi, bf[2], bf[3]);
      mmatile::mma_bf16(acc[2 * p + 1], lo, bf[2], bf[3]);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads)
flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int t_len, int s_len,
                     int heads, float scale) {
  constexpr int NQ = kDkvQS / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = mmatile::smem_u32(smem);

  const int k0 = blockIdx.x * kBN;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q_off = s_len - t_len;
  const size_t stride = (size_t)heads * kD;
  const size_t qbase = ((size_t)b * t_len * heads + h) * kD;
  const size_t kbase = ((size_t)b * s_len * heads + h) * kD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kw = 16 * warp;  // the warp's rows of the key tile

  copy_tile(smem, k + kbase, stride, k0, s_len);
  copy_tile(smem + kTileB, v + kbase, stride, k0, s_len);
  // query tile qt -> ring stage st: Q, dO, then lse[64], delta[64]
  auto load_q = [&](int st, int qt) {
    unsigned char* base = smem + 2 * kTileB + st * kDkvStage;
    const int q0 = qt * kBM, row = q0 + (threadIdx.x & 63);
    copy_tile(base, q + qbase, stride, q0, t_len);
    copy_tile(base + kTileB, dout + qbase, stride, q0, t_len);
    const bool ok = row < t_len;
    const float* src = (threadIdx.x < 64 ? lse : delta) +
                       (size_t)bh * t_len + row;
    mmatile::cp_async<4>(base + 2 * kTileB + 4 * threadIdx.x,
                         ok ? src : lse, ok ? 4 : 0);
  };

  // the thread's keys, rows g and g + 8 of the warp's: kept unless past S
  // or masked
  int key[2];
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + kw + g + 8 * r;
    key_ok[r] = key[r] < s_len && mask[(size_t)b * s_len + key[r]] > 0;
  }
  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  // the first query tile whose last row reaches the key tile
  const int n_qt = (t_len + kBM - 1) / kBM;
  const int qt0 = max(0, k0 - q_off) / kBM;
  load_q(0, qt0);
  mmatile::cp_async_commit();
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < n_qt) load_q(st ^ 1, qt + 1);
    mmatile::cp_async_commit();
    mmatile::cp_async_wait<1>();
    __syncthreads();  // stage st (and K, V) landed
    const uint32_t sq = s0 + 2 * kTileB + st * kDkvStage, sdo = sq + kTileB;
    const float* rows = reinterpret_cast<const float*>(
        smem + 4 * kTileB + st * kDkvStage);
    const int q0 = qt * kBM;
    // per kDkvQS queries: P^T and dV first, then dP^T, dS^T and dK, so
    // that at most P^T and dP^T are live beside the 128 accumulators (a
    // rolled loop: unrolled, ptxas interleaves the sub-steps and spills)
#pragma unroll 1
    for (int c0 = 0; c0 < kBM; c0 += kDkvQS) {
      float p[NQ][4], ds[NQ][4];
      rows_dot<NQ>(s0, kw, sq, c0, p);  // S^T
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(rows + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + col + (e & 1), r = e >> 1;
          const bool keep = key_ok[r] && qi < t_len && qi + q_off >= key[r];
          p[j][e] =
              keep ? expf(p[j][e] * scale - ((e & 1) ? l.y : l.x)) : 0.f;
        }
      }
      axpy_split<NQ>(p, sdo, c0, dva);             // dV += P^T dO
      rows_dot<NQ>(s0 + kTileB, kw, sdo, c0, ds);  // dP^T
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(
            rows + 64 + c0 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - ((e & 1) ? dl.y : dl.x));
      }
      axpy_split<NQ>(ds, sq, c0, dka);  // dK += dS^T Q
    }
    __syncthreads();  // stage st is refilled by the next prefetch
  }

  // the thread's rows g, g + 8, columns 8 j + 2t, + 1 of each d n-tile j
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= s_len) continue;
    const size_t o = kbase + (size_t)key[r] * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * j) =
          __floats2bfloat162_rn(dka[j][2 * r] * scale,
                                dka[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * j) =
          __floats2bfloat162_rn(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4, K5 on bf16: a query tile on the tensor cores
// ---------------------------------------------------------------------------
//
// One block of 4 warps per (b*h, 64-query tile), heaviest tiles first; warp
// w owns queries 16 w .. 16 w + 15 of the tile and its 16 x 128 f32
// accumulator (64 registers a thread); the thread's rows are g and g + 8.
// The Q tile (K5: and dO) is copied once by cp.async into a swizzled tile;
// the 64-key tiles the block's last row reaches stream through a 2-stage
// cp.async ring of K, V and the tile's 64 mask words (0 past S). The
// building blocks are K6's, in [query, key] orientation:
//   S  = Q K^T * scale      rows_dot: A the warp's Q rows, B K rows; the
//                           scale multiplies the f32 sum, as in K6
//   K4: m_new = max(m, rowmax S) over the quad; alpha = exp(m - m_new);
//       P = exp(S - m_new); l, acc *= alpha; l += P; acc += P V
//   K5: P = keep ? exp(S - lse) : 0; dP = dO V^T (rows_dot);
//       dS = P * (dP - delta); acc += dS K; dq = acc * scale at the end
// P V and dS K take the C fragments of two neighbouring key n-tiles as the
// A fragment and the [key][d] V / K rows by ldmatrix.trans (axpy_split),
// with P and dS split hi + lo as in K6. l is summed per thread over its
// columns and reduced over the quad once at the end. Masked scores are the
// finite kNegInf (K4) or P = 0 (K5). Query rows past T read zeros and are
// not stored. No atomics: deterministic.

constexpr int kKvStage = 2 * kTileB + 64 * 4;        // K, V, mask[64]
constexpr int kDqSmem = 2 * kTileB + 2 * kKvStage;   // Q, dO + the ring
// K4 at q / k heads DK and v heads DV: a K tile, a V tile, the mask words
template <int DK, int DV>
constexpr int kFwdStage = 64 * 2 * (DK + DV) + 64 * 4;
template <int DK, int DV>
constexpr int kFwdSmem = 64 * 2 * DK + 2 * kFwdStage<DK, DV>;  // Q + ring
// key n-tiles a step: a whole 64-key tile (191 / 219 registers, no spill;
// at 32-key sub-steps one of the two spilled)
constexpr int kNK = kBN / 8;

// key tile at k0 -> the ring stage at `stage`: K rows, V rows, then the
// tile's mask words (zero past S, so those columns are never kept)
__device__ __forceinline__ void load_kv(unsigned char* stage,
                                        const __nv_bfloat16* kg,
                                        const __nv_bfloat16* vg,
                                        const int* mg, size_t stride, int k0,
                                        int s_len) {
  copy_tile(stage, kg, stride, k0, s_len);
  copy_tile(stage + kTileB, vg, stride, k0, s_len);
  if (threadIdx.x < 64) {
    const int col = k0 + threadIdx.x;
    const bool ok = col < s_len;
    mmatile::cp_async<4>(stage + 2 * kTileB + 4 * threadIdx.x,
                         ok ? mg + col : mg, ok ? 4 : 0);
  }
}

// K4's key tile at k0 -> the ring stage: K rows (DK wide, row stride
// kstride), V rows (DV, vstride), then the tile's mask words
template <int DK, int DV>
__device__ __forceinline__ void load_kv_fwd(unsigned char* stage,
                                            const __nv_bfloat16* kg,
                                            const __nv_bfloat16* vg,
                                            const int* mg, size_t kstride,
                                            size_t vstride, int k0,
                                            int s_len) {
  copy_tile<DK>(stage, kg, kstride, k0, s_len);
  copy_tile<DV>(stage + 64 * 2 * DK, vg, vstride, k0, s_len);
  if (threadIdx.x < 64) {
    const int col = k0 + threadIdx.x;
    const bool ok = col < s_len;
    mmatile::cp_async<4>(stage + 64 * 2 * (DK + DV) + 4 * threadIdx.x,
                         ok ? mg + col : mg, ok ? 4 : 0);
  }
}

// key tiles whose first column is <= the query tile's last row
__device__ __forceinline__ int key_tiles(int q0, int q_off, int s_len) {
  return min((s_len + kBN - 1) / kBN, (q0 + q_off + kBM - 1) / kBN + 1);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int t_len, int s_len,
                     int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = mmatile::smem_u32(smem);
  constexpr int kQTileB = 64 * 2 * DK, kKTileB = kQTileB;
  constexpr int kStage = kFwdStage<DK, DV>;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q_off = s_len - t_len;
  const size_t stride = (size_t)heads * DK, vstride = (size_t)heads * DV;
  const size_t qbase = ((size_t)b * t_len * heads + h) * DK;
  const size_t kbase = ((size_t)b * s_len * heads + h) * DK;
  const size_t vbase = ((size_t)b * s_len * heads + h) * DV;
  const size_t obase = ((size_t)b * t_len * heads + h) * DV;
  const int* mg = mask + (size_t)b * s_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = 16 * warp;  // the warp's rows of the query tile

  copy_tile<DK>(smem, q + qbase, stride, q0, t_len);
  load_kv_fwd<DK, DV>(smem + kQTileB, k + kbase, v + vbase, mg, stride,
                      vstride, 0, s_len);
  mmatile::cp_async_commit();

  // the thread's rows g, g + 8 at their key positions
  int row[2];
  float m[2], l[2], acc[DV / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + q_off + qw + g + 8 * r;
    m[r] = kNegInf;
    l[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int n_kt = key_tiles(q0, q_off, s_len);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * kBN;
    if (kt + 1 < n_kt)
      load_kv_fwd<DK, DV>(smem + kQTileB + (st ^ 1) * kStage, k + kbase,
                          v + vbase, mg, stride, vstride, k0 + kBN, s_len);
    mmatile::cp_async_commit();
    mmatile::cp_async_wait<1>();
    __syncthreads();  // Q and stage st landed
    const uint32_t sk = s0 + kQTileB + st * kStage, sv = sk + kKTileB;
    const int* keep_col = reinterpret_cast<const int*>(
        smem + kQTileB + st * kStage + 64 * 2 * (DK + DV));
    float s[kNK][4];
    rows_dot<kNK, DK>(s0, qw, sk, 0, s);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
      const int col = 8 * j + 2 * t;
      const int2 mk = *reinterpret_cast<const int2*>(keep_col + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool keep = ((e & 1) ? mk.y : mk.x) > 0 &&
                          row[r] >= k0 + col + (e & 1);
        s[j][e] = keep ? s[j][e] * scale : kNegInf;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    axpy_split<kNK, DV>(s, sv, 0, acc);  // acc += P V
    __syncthreads();  // stage st is refilled by the next prefetch
  }

  // the thread's rows g, g + 8, columns 8 j + 2t, + 1 of each d n-tile j
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + qw + g + 8 * r;
    if (qi >= t_len) continue;
    const float lm = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* o = out + obase + (size_t)qi * vstride + 2 * t;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * r] / lm, acc[j][2 * r + 1] / lm);
    if (t == 0) lse[(size_t)bh * t_len + qi] = m[r] + logf(lm);
  }
}

__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int t_len, int s_len,
                    int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s0 = mmatile::smem_u32(smem);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q_off = s_len - t_len;
  const size_t stride = (size_t)heads * kD;
  const size_t qbase = ((size_t)b * t_len * heads + h) * kD;
  const size_t kbase = ((size_t)b * s_len * heads + h) * kD;
  const int* mg = mask + (size_t)b * s_len;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = 16 * warp;

  unsigned char* ring = smem + 2 * kTileB;
  copy_tile(smem, q + qbase, stride, q0, t_len);
  copy_tile(smem + kTileB, dout + qbase, stride, q0, t_len);
  load_kv(ring, k + kbase, v + kbase, mg, stride, 0, s_len);
  mmatile::cp_async_commit();

  // the thread's rows g, g + 8: key position (-1 past T: nothing kept),
  // lse, delta
  int row[2];
  float lr[2], dr[2], acc[kD / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qw + g + 8 * r;
    const bool ok = qi < t_len;
    row[r] = ok ? qi + q_off : -1;
    lr[r] = ok ? lse[(size_t)bh * t_len + qi] : 0.f;
    dr[r] = ok ? delta[(size_t)bh * t_len + qi] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int n_kt = key_tiles(q0, q_off, s_len);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * kBN;
    if (kt + 1 < n_kt)
      load_kv(ring + (st ^ 1) * kKvStage, k + kbase, v + kbase, mg, stride,
              k0 + kBN, s_len);
    mmatile::cp_async_commit();
    mmatile::cp_async_wait<1>();
    __syncthreads();  // Q, dO and stage st landed
    const uint32_t sk = s0 + 2 * kTileB + st * kKvStage, sv = sk + kTileB;
    const int* keep_col =
        reinterpret_cast<const int*>(ring + st * kKvStage + 2 * kTileB);
    float p[kNK][4], ds[kNK][4];
    rows_dot<kNK>(s0, qw, sk, 0, p);  // S
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
      const int col = 8 * j + 2 * t;
      const int2 mk = *reinterpret_cast<const int2*>(keep_col + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool keep = ((e & 1) ? mk.y : mk.x) > 0 &&
                          row[r] >= k0 + col + (e & 1);
        p[j][e] = keep ? expf(p[j][e] * scale - lr[r]) : 0.f;
      }
    }
    rows_dot<kNK>(s0 + kTileB, qw, sv, 0, ds);  // dP
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dr[e >> 1]);
    axpy_split<kNK>(ds, sk, 0, acc);  // acc += dS K
    __syncthreads();  // stage st is refilled by the next prefetch
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + qw + g + 8 * r;
    if (qi >= t_len) continue;
    __nv_bfloat16* o = dq + qbase + (size_t)qi * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
          acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

template <typename T>
size_t fwd_smem() {
  return kBM * kPitch * sizeof(float) + kBN * kPitch * sizeof(T) +
         kBM * kSP * sizeof(float);
}

template <typename T>
size_t dq_smem() {
  return kBM * kPitch * sizeof(float) + (kBM + 2 * kBN) * kPitch * sizeof(T) +
         kBM * kSP * sizeof(float);
}

template <typename T>
size_t dkv_smem() {
  return (kBM * kPitch + kBM * kSP + 2 * kBM) * sizeof(float) +
         (2 * kBN + kBM) * kPitch * sizeof(T);
}

// K4 on bf16 at q / k heads DK and v heads DV
template <int DK, int DV>
cudaError_t fwd_mma(const void* q, const void* k, const void* v,
                    const void* mask, void* out, void* lse, int batch,
                    int t_len, int s_len, int heads, float scale,
                    cudaStream_t stream) {
  dim3 grid((t_len + kBM - 1) / kBM, batch * heads);
  using T = __nv_bfloat16;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem<DK, DV>);
  if (e != cudaSuccess) return e;
  flash_fwd_mma_kernel<DK, DV><<<grid, kMmaThreads, kFwdSmem<DK, DV>,
                                 stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)mask, (T*)out,
      (float*)lse, t_len, s_len, heads, scale);
  return cudaGetLastError();
}

// K4, K5 and K6: the FMA kernels on f32 (a bf16 mma would round f32 q, k,
// v), the tensor-core kernels on bf16.
template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* mask,
                void* out, void* lse, int batch, int t_len, int s_len,
                int heads, float scale, cudaStream_t stream) {
  dim3 grid((t_len + kBM - 1) / kBM, batch * heads);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return fwd_mma<kD, kD>(q, k, v, mask, out, lse, batch, t_len, s_len,
                           heads, scale, stream);
  } else {
    const size_t smem = fwd_smem<T>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)mask, (T*)out,
        (float*)lse, t_len, s_len, heads, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* mask, const void* dout, const void* lse,
                   const void* delta, void* dq, int batch, int t_len,
                   int s_len, int heads, float scale, cudaStream_t stream) {
  dim3 grid((t_len + kBM - 1) / kBM, batch * heads);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_dq_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDqSmem);
    if (e != cudaSuccess) return e;
    flash_dq_mma_kernel<<<grid, kMmaThreads, kDqSmem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)mask,
        (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq,
        t_len, s_len, heads, scale);
  } else {
    const size_t smem = dq_smem<T>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    flash_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)mask,
        (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq,
        t_len, s_len, heads, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* mask, const void* dout, const void* lse,
                    const void* delta, void* dk, void* dv, int batch,
                    int t_len, int s_len, int heads, float scale,
                    cudaStream_t stream) {
  dim3 grid((s_len + kBN - 1) / kBN, batch * heads);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_dkv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDkvSmem);
    if (e != cudaSuccess) return e;
    flash_dkv_mma_kernel<<<grid, kMmaThreads, kDkvSmem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)mask,
        (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk,
        (T*)dv, t_len, s_len, heads, scale);
  } else {
    const size_t smem = dkv_smem<T>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    flash_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)mask,
        (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk,
        (T*)dv, t_len, s_len, heads, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry points. dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq,
// dk, dv all of that type); D = 128. The caller checks shapes, dtypes,
// contiguity, B * H <= 65535 and T, S >= 1. Each returns the cudaError_t of
// its launch.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* lse,
                                int batch, int t_len, int s_len, int heads,
                                int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)fwd<float>(q, k, v, mask, out, lse, batch, t_len, s_len,
                           heads, scale, st);
  if (dtype == 1)
    return (int)fwd<__nv_bfloat16>(q, k, v, mask, out, lse, batch, t_len,
                                   s_len, heads, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K4 on bf16 at q / k heads dk and v heads dv other than 128 / 128
// (q [B, T, H, dk], k [B, S, H, dk], v [B, S, H, dv], out [B, T, H, dv]);
// (192, 128) only. The caller checks as for flash_fwd_launch.
extern "C" int flash_fwd_dims_launch(const void* q, const void* k,
                                     const void* v, const void* mask,
                                     void* out, void* lse, int batch,
                                     int t_len, int s_len, int heads,
                                     int dk, int dv, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk == 192 && dv == 128)
    return (int)fwd_mma<192, 128>(q, k, v, mask, out, lse, batch, t_len,
                                  s_len, heads, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq, int batch,
                                   int t_len, int s_len, int heads,
                                   int dtype, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd_dq<float>(q, k, v, mask, dout, lse, delta, dq, batch,
                              t_len, s_len, heads, scale, st);
  if (dtype == 1)
    return (int)bwd_dq<__nv_bfloat16>(q, k, v, mask, dout, lse, delta, dq,
                                      batch, t_len, s_len, heads, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv,
                                    int batch, int t_len, int s_len,
                                    int heads, int dtype, float scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd_dkv<float>(q, k, v, mask, dout, lse, delta, dk, dv,
                               batch, t_len, s_len, heads, scale, st);
  if (dtype == 1)
    return (int)bwd_dkv<__nv_bfloat16>(q, k, v, mask, dout, lse, delta, dk,
                                       dv, batch, t_len, s_len, heads, scale,
                                       st);
  return (int)cudaErrorInvalidValue;
}
