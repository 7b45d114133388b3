// The tile compute shared by the two weight-switch kernels
// (switched_mlp.cu and fused_dispatch.cu) and the one-approximator MLP
// (mcma_mlp.cu, which passes tile_cls == nullptr: every tile is class 0).
//
// One CTA owns `rows_per_cta` consecutive padded row positions (all inside
// one single-class block_t tile, so one approximator c = tile_cls[tile])
// and kCols output columns.  It walks the hidden width in kHid chunks:
//
//   h[:, chunk] = tanh(x_rows . W1[c][:, chunk] + b1[c][chunk])  (f32 sums)
//   h is rounded to the activation type (the cast before the second
//   product in the reference kernel), kept in shared memory, and
//   y[:, cols] += h[:, chunk] . W2[c][chunk, cols]                 (f32 sums)
//
// and ends with y + b2[c][cols], cast and stored.  Every output is summed
// in a fixed order (input features in order, then hidden units in order),
// so the two kernels, which differ only in where a row is loaded from and
// stored to, give bitwise-equal results for every real row.
//
// Pseudo-class tiles carry all-zero weights: tanh(0 + 0) = 0 and
// 0 . 0 + 0 = 0, so their rows come out exactly zero.
//
// This is the simple first version: CUDA cores in f32, no tensor cores,
// no TMA; the hidden chunk is recomputed by every CTA of a row block.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace switch_tile {

constexpr int kThreads = 256;  // threads per CTA
constexpr int kRows = 32;      // padded row positions per CTA (at most)
constexpr int kCols = 128;     // output columns per CTA
constexpr int kHid = 64;       // hidden units per chunk
constexpr int kIn = 32;        // input features per step of the first product
constexpr int kHalf = 32;      // hidden units per step of the second product

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// rows_per_cta divides block_t, so a CTA never straddles two tiles.
// `rows` == nullptr: row p is loaded from x[p] and stored to out[p].
// Otherwise row p is loaded from x[min(rows[p], t_last)] and stored to
// out[rows[p]] (the fused dispatch: padding positions hold the trash id).
// Input columns at or past x_cols read as zero (lane padding).
template <typename T>
__device__ __forceinline__ void switched_tile(
    const T* __restrict__ x, int x_cols, int x_ld,
    const int* __restrict__ rows, int t_last,
    const int* __restrict__ tile_cls,
    const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ w2, const T* __restrict__ b2,
    T* __restrict__ out, int d_in_p, int d_h_p, int d_out_p, int block_t,
    int rows_per_cta) {
  __shared__ float xs[kRows][kIn + 1];
  __shared__ float w1s[kIn][kHid];
  __shared__ float hs[kRows][kHid + 1];
  __shared__ float w2s[kHalf][kCols];
  __shared__ int src_row[kRows];
  __shared__ int dst_row[kRows];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * rows_per_cta;
  const int col0 = blockIdx.y * kCols;
  const int c = tile_cls == nullptr ? 0 : tile_cls[p0 / block_t];
  const T* w1c = w1 + (size_t)c * d_in_p * d_h_p;
  const T* b1c = b1 + (size_t)c * d_h_p;
  const T* w2c = w2 + (size_t)c * d_h_p * d_out_p;
  const T* b2c = b2 + (size_t)c * d_out_p;

  if (tid < kRows) {
    int src = -1, dst = -1;
    if (tid < rows_per_cta) {
      const int p = p0 + tid;
      dst = rows == nullptr ? p : rows[p];
      src = rows == nullptr ? p : min(dst, t_last);
    }
    src_row[tid] = src;
    dst_row[tid] = dst;
  }
  __syncthreads();

  // first product: 2 rows x 4 hidden units per thread
  const int ar = (tid / 16) * 2;
  const int ac = (tid % 16) * 4;
  // second product: 4 rows x 4 output columns per thread
  const int br = (tid / 32) * 4;
  const int bc = (tid % 32) * 4;

  float acc_y[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_y[i][j] = 0.f;

  for (int h0 = 0; h0 < d_h_p; h0 += kHid) {
    float acc_h[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_h[i][j] = 0.f;

    for (int k0 = 0; k0 < d_in_p; k0 += kIn) {
#pragma unroll
      for (int e = 0; e < (kRows * kIn) / kThreads; ++e) {
        const int idx = tid + e * kThreads;
        const int r = idx / kIn, k = idx % kIn;
        const int src = src_row[r];
        const int col = k0 + k;
        xs[r][k] = (src >= 0 && col < x_cols)
                       ? to_f32(x[(size_t)src * x_ld + col])
                       : 0.f;
      }
#pragma unroll
      for (int e = 0; e < (kIn * kHid) / kThreads; ++e) {
        const int idx = tid + e * kThreads;
        const int k = idx / kHid, j = idx % kHid;
        w1s[k][j] = to_f32(w1c[(size_t)(k0 + k) * d_h_p + h0 + j]);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kIn; ++k) {
        const float a0 = xs[ar][k], a1 = xs[ar + 1][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = w1s[k][ac + j];
          acc_h[0][j] = fmaf(a0, b, acc_h[0][j]);
          acc_h[1][j] = fmaf(a1, b, acc_h[1][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = tanhf(acc_h[i][j] + to_f32(b1c[h0 + ac + j]));
        hs[ar + i][ac + j] = to_f32(from_f32<T>(v));
      }
    __syncthreads();

    for (int k1 = 0; k1 < kHid; k1 += kHalf) {
#pragma unroll
      for (int e = 0; e < (kHalf * kCols) / kThreads; ++e) {
        const int idx = tid + e * kThreads;
        const int k = idx / kCols, j = idx % kCols;
        w2s[k][j] = to_f32(w2c[(size_t)(h0 + k1 + k) * d_out_p + col0 + j]);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kHalf; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = hs[br + i][k1 + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = w2s[k][bc + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_y[i][j] = fmaf(a[i], b[j], acc_y[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int dst = dst_row[br + i];
    if (dst < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + bc + j;
      out[(size_t)dst * d_out_p + col] =
          from_f32<T>(acc_y[i][j] + to_f32(b2c[col]));
    }
  }
}

// Largest power of two <= kRows that divides block_t.
inline int rows_per_cta(int block_t) {
  int r = kRows;
  while (block_t % r) r /= 2;
  return r;
}

}  // namespace switch_tile
