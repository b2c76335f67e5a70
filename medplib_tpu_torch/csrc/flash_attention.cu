// Causal flash attention with a [B, S] keep mask: forward (K4) and the two
// backward passes (K5 dQ, K6 dK/dV).
//
// Replaces the TPU kernels of medplib_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel  <- _flash_forward / _flash_kernel   (pallas_call :138)
//   flash_dq_kernel   <- _dq_kernel                        (pallas_call :306)
//   flash_dkv_kernel  <- _dkv_kernel                       (pallas_call :333)
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
// Design (first, simple version). One block of 256 threads per (b*h, 64-row
// tile). K4 and K5: a query tile, looping over 64-key tiles up to the causal
// diagonal; K6: a key tile, looping over the query tiles from the diagonal
// down. The scaled Q tile is kept in shared memory in f32, K / V / dO tiles in
// the input type, with a row pitch of D + 4 elements so that the 8- and
// 16-byte reads of 16 different rows hit distinct banks. Each thread owns a
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
// by operations. This version runs on f32 CUDA-core FMA (67 TFLOP/s peak),
// so it is compute bound far above those floors; mma / wgmma tiles, TMA
// loads and a pipelined K / V ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
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

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* mask,
                void* out, void* lse, int batch, int t_len, int s_len,
                int heads, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((t_len + kBM - 1) / kBM, batch * heads);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)mask, (T*)out,
      (float*)lse, t_len, s_len, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* mask, const void* dout, const void* lse,
                   const void* delta, void* dq, int batch, int t_len,
                   int s_len, int heads, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((t_len + kBM - 1) / kBM, batch * heads);
  flash_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)mask,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dq, t_len,
      s_len, heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* mask, const void* dout, const void* lse,
                    const void* delta, void* dk, void* dv, int batch,
                    int t_len, int s_len, int heads, float scale,
                    cudaStream_t stream) {
  const size_t smem = dkv_smem<T>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((s_len + kBN - 1) / kBN, batch * heads);
  flash_dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)mask,
      (const T*)dout, (const float*)lse, (const float*)delta, (T*)dk,
      (T*)dv, t_len, s_len, heads, scale);
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
