// The tile routine shared by the two weight-switch kernels
// (switched_mlp.cu, fused_dispatch.cu) and the one-approximator MLP
// (mcma_mlp.cu, which passes tile_cls == nullptr: every tile is class 0).
// It replaces the body of the Pallas TPU kernels
// src/repro/kernels/switched_mlp.py (_switched_kernel),
// src/repro/kernels/fused_dispatch.py (_fused_kernel) and
// src/repro/kernels/mcma_mlp.py (_mlp_kernel).
//
// Per row block of R padded positions (R = 32, or 16 where block_t is
// not a multiple of 32; a row block never straddles a block_t tile, so it
// has one approximator c = tile_cls[tile]):
//
//   h = tanh(x_rows . W1[c] + b1[c])  (f32 sums), rounded to the type T
//   y = h . W2[c] + b2[c]             (f32 sums), rounded to T and stored
//
// Bound on an H100 at the decode shape (t_pad 640 in 5 tiles of 128,
// d_in_p = d_out_p = 2048, d_h_p = 256, bf16): the bytes, about 8.4 MB of
// weights for the classes a call touches plus the rows, against 1.3
// GFLOP: 4.1 us at 3.35 TB/s, 1.4 us of tensor-core time.
//
// Design.  A row block is one thread-block cluster of kCluster = 8 CTAs
// of 256 threads (at the decode shape 20 clusters, 160 CTAs, two on an SM).
// A cluster rather than two launches through an h buffer in device
// memory: one launch per call, and h never leaves the chip.
//   1. CTA r computes the hidden units [r * d_h_p / 8, (r + 1) * d_h_p / 8)
//      over the whole of d_in_p, adds b1, takes tanhf and rounds to T into
//      its own shared memory: each element of h is computed once per row
//      block, and W1[c] is read once per row block, split over the CTAs.
//   2. cluster.sync(); every CTA copies the whole h (R x d_h_p) out of the
//      eight CTAs' shared memory (distributed shared memory) into its own.
//   3. CTA r computes the output columns [r * d_out_p / 8, (r + 1) *
//      d_out_p / 8), in chunks of up to 64, from that h and its slice of
//      W2[c].
// Both products stream their operands through a ring of kStages = 4
// stages of 16-byte cp.async copies, each stage 256 bytes deep along k
// (128 bf16 or 64 f32), so the next stages' copies overlap this stage's
// product; W2's first stages and the bias slices are in flight while the
// cluster exchanges h.  Each thread's copy offsets and fragment addresses
// are worked out once per phase, not once per stage.  bf16 runs on the
// tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulate), fragments by
// ldmatrix from shared memory, the next k step's fragments loaded before
// this step's products.  f32 runs on the CUDA cores with fmaf (no TF32),
// each thread owning 2 rows x 4 columns, the k of a stage split over up
// to 8 thread groups whose partial sums are added in group order.
// Dynamic shared memory per CTA at the decode shape: 95,808 B (bf16),
// 114,816 B (f32); 0 spill bytes.
//
// Every output is summed inside one CTA in a fixed order, so the switched
// and fused kernels, which differ only in where a row is loaded from and
// stored to, agree bitwise on every real row.  Pseudo-class tiles carry
// all-zero weights: tanh(0 + 0) = 0 and 0 . 0 + 0 = 0, so their rows come
// out exactly zero.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace switch_tile {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;    // CTAs per row block
constexpr int kStages = 4;     // cp.async ring depth
constexpr int kMaxCols = 64;   // output columns per column chunk

template <typename T>
struct Shape {
  static constexpr int kVec = 16 / sizeof(T);    // elements per 16 B copy
  static constexpr int kPad = kVec;              // row padding (16 B)
  static constexpr int kK = 256 / sizeof(T);     // k depth of one stage
};

// Row block: 32 positions, or 16 where block_t is not a multiple of 32.
__host__ __device__ inline int row_block(int block_t) {
  return block_t % 32 == 0 ? 32 : 16;
}

// Output columns per chunk of phase 2: the widest of 64, 48, 32, 16 that
// divides a CTA's ns columns (ns is a multiple of 16).
__host__ __device__ inline int chunk_cols(int ns) {
  for (int w = kMaxCols; w > 16; w -= 16)
    if (ns % w == 0) return w;
  return 16;
}

// f32 k groups of a R x w product (FmaF32): 256 threads over
// (R / 2) x (w / 4) threads a group.
__host__ __device__ inline int k_groups(int r, int w) {
  return kThreads / ((r / 2) * (w / 4));
}

// Shared-memory plan (in elements of T): the stage ring, this CTA's slice
// of h, the whole h, (f32) the k groups' partial sums, and this CTA's
// slices of b1 and b2.  Every row is
// padded by 16 B, which keeps each region 16-B aligned and ldmatrix free
// of bank conflicts.
template <typename T>
struct Plan {
  int hs, ns;            // hidden units / output columns per CTA
  int lda1, slot;        // x stage row stride, elements per ring slot
  int hs_ld, hf_ld;      // row strides of the h slice and the whole h
  int hs_off, hf_off, red_off, bias_off;  // bias: b1 slice, b2 slice
  size_t bytes;

  __host__ __device__ Plan(int r, int d_h_p, int d_out_p) {
    using S = Shape<T>;
    hs = d_h_p / kCluster;
    ns = d_out_p / kCluster;
    const int w2 = chunk_cols(ns);
    lda1 = S::kK + S::kPad;
    const int s1 = r * lda1 + S::kK * (hs + S::kPad);
    const int s2 = S::kK * (w2 + S::kPad);
    slot = s1 > s2 ? s1 : s2;
    hs_ld = hs + S::kPad;
    hf_ld = d_h_p + S::kPad;
    hs_off = kStages * slot;
    hf_off = hs_off + r * hs_ld;
    red_off = hf_off + r * hf_ld;
    int red = 0;
    if (sizeof(T) == 4) {
      const int r1 = (k_groups(r, hs) - 1) * r * hs;
      const int r2 = (k_groups(r, w2) - 1) * r * w2;
      red = r1 > r2 ? r1 : r2;
    }
    bias_off = red_off + red;
    bytes = sizeof(T) * (size_t)(bias_off + hs + ns);
  }
};

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to a shared address; the bytes past src_bytes (0 or 16)
// are filled with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's share of the 16-byte copies of a rows x cols tile (cols a
// multiple of 16 B), the same for every stage of a phase: shared byte
// offsets, global element offsets (row_off(r) + column) and columns.  The
// index arithmetic is done once per phase, not once per stage.
template <typename T>
struct Copies {
  static constexpr int kMax = 4;  // rows * cols <= 4 * 256 * 16 B
  int n;
  uint32_t dst[kMax];
  size_t src[kMax];
  int col[kMax];

  template <typename RowOff>
  __device__ __forceinline__ void plan(int rows, int cols, int ld_dst,
                                       RowOff row_off) {
    constexpr int V = Shape<T>::kVec;
    const int per_row = cols / V;
    n = 0;
#pragma unroll
    for (int u = 0; u < kMax; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < rows * per_row) {
        const int r = i / per_row, c = (i % per_row) * V;
        dst[u] = static_cast<uint32_t>((r * ld_dst + c) * sizeof(T));
        src[u] = row_off(r) + c;
        col[u] = c;
        n = u + 1;
      }
    }
  }

  // every copy, from src_base + src[u] to dst_base + dst[u]
  __device__ __forceinline__ void fetch(uint32_t dst_base,
                                        const T* src_base) const {
#pragma unroll
    for (int u = 0; u < kMax; ++u)
      if (u < n) cp_async16(dst_base + dst[u], src_base + src[u]);
  }

  // the same for rows of x: columns k0 + col[u] at or past x_cols are
  // zeros (read from the row's start, 0 bytes)
  __device__ __forceinline__ void fetch_x(uint32_t dst_base, const T* x,
                                          int k0, int x_cols) const {
#pragma unroll
    for (int u = 0; u < kMax; ++u) {
      if (u < n) {
        const bool in = k0 + col[u] < x_cols;
        const T* row = x + src[u] - col[u];
        cp_async16(dst_base + dst[u], in ? row + k0 + col[u] : row,
                   in ? 16 : 0);
      }
    }
  }
};

// ---------------------------------------------------------------------
// The product of one stage, acc += A[R x kK] . B[kK x w], A and B in
// shared memory, in two flavours with one interface: init() once per
// phase (the thread's fragment offsets), zero(), step(a, b) for the A and
// B tiles of a stage, reduce() at the end of a column chunk, and
// for_each(f) calling f(row, col, value) for every finished output
// element this thread owns.

// bf16: tensor cores.  The R x w output is cut into m16 x n8 tiles, dealt
// to the 8 warps round robin: at most 2 a warp (R <= 32, w <= 64), both
// in the same 16 rows, so one A fragment serves both.
struct MmaBf16 {
  static constexpr int kSteps = Shape<__nv_bfloat16>::kK / 16;
  float acc[2][4];
  int tiles;             // this warp's tiles: 0, 1 or 2
  uint32_t a_off, b_off[2], b_step;
  int row0, col0[2];     // the tiles' first output row and column

  __device__ __forceinline__ void init(int lda, int ldb, int r, int w) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int mt_n = r / 16, all = mt_n * (w / 8);
    tiles = warp >= all ? 0 : warp + kWarps >= all ? 1 : 2;
    const int mt = warp % mt_n;
    row0 = mt * 16;
    a_off = 2 * ((mt * 16 + lane % 16) * lda + (lane / 16) * 8);
    b_step = 2 * 16 * ldb;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int nt = (warp + i * kWarps) / mt_n;
      col0[i] = nt * 8;
      b_off[i] = 2 * ((lane % 16) * ldb + nt * 8);
    }
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  static __device__ __forceinline__ void ldm_a(uint32_t (&f)[4], uint32_t p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
        : "r"(p));
  }
  static __device__ __forceinline__ void ldm_b(uint32_t (&f)[2], uint32_t p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(f[0]), "=r"(f[1])
        : "r"(p));
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&fa)[4],
                                             const uint32_t (&fb)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "r"(fb[0]),
          "r"(fb[1]));
  }

  // the fragments of k step k+1 are loaded before the products of step k
  __device__ __forceinline__ void step(const __nv_bfloat16* a_ptr,
                                       const __nv_bfloat16* b_ptr) {
    if (tiles == 0) return;  // warp-uniform
    const uint32_t a = smem_addr(a_ptr) + a_off, b = smem_addr(b_ptr);
    const uint32_t b0 = b + b_off[0], b1 = b + b_off[1];
    uint32_t fa[2][4], fb[2][2][2];
    ldm_a(fa[0], a);
    ldm_b(fb[0][0], b0);
    if (tiles == 2) ldm_b(fb[0][1], b1);
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int cur = k & 1, nxt = cur ^ 1;
      if (k + 1 < kSteps) {
        ldm_a(fa[nxt], a + 32 * (k + 1));
        ldm_b(fb[nxt][0], b0 + (k + 1) * b_step);
        if (tiles == 2) ldm_b(fb[nxt][1], b1 + (k + 1) * b_step);
      }
      mma(acc[0], fa[cur], fb[cur][0]);
      if (tiles == 2) mma(acc[1], fa[cur], fb[cur][1]);
    }
  }

  __device__ __forceinline__ void reduce(float*) {}

  template <typename F>
  __device__ __forceinline__ void for_each(F f) const {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= tiles) break;
      const int row = row0 + lane / 4, col = col0[i] + (lane % 4) * 2;
      f(row, col, acc[i][0]);
      f(row, col + 1, acc[i][1]);
      f(row + 8, col, acc[i][2]);
      f(row + 8, col + 1, acc[i][3]);
    }
  }
};

// f32: CUDA cores, fmaf.  A thread owns 4 adjacent columns of rows rg and
// rg + R / 2; (R / 2) x (w / 4) threads make a k group, and the G k groups
// (G = 256 / that, 1 to 8) split each stage's kK into G runs of kK / G.
// Each thread sums its run in k order; reduce() then adds the groups'
// partials in group order through shared memory, so the sum order is
// fixed.  A and B are read 16 B at a time, 4 k at once.
struct FmaF32 {
  static constexpr int kK = Shape<float>::kK;
  float acc[2][4];
  int g, groups, kn, rg, cg_, r_half, w_, ldb;
  bool active;
  int a_off[2], b_off;  // elements

  __device__ __forceinline__ void init(int lda, int ldb_, int r, int w) {
    const int per = (r / 2) * (w / 4), wcols = w / 16;
    groups = k_groups(r, w);
    g = threadIdx.x / per;
    active = g < groups;
    // a warp covers 4 column groups x 8 row groups: 1 shared-memory
    // wavefront for each A and each B read
    const int wl = (threadIdx.x % per) / 32, lane = threadIdx.x % 32;
    cg_ = (wl % wcols) * 4 + lane % 4;
    rg = (wl / wcols) * 8 + lane / 4;
    r_half = r / 2;
    w_ = w;
    kn = kK / groups;
    const int k0 = g * kn;
    a_off[0] = rg * lda + k0;
    a_off[1] = (rg + r_half) * lda + k0;
    b_off = k0 * ldb_ + cg_ * 4;
    ldb = ldb_;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void step(const float* a, const float* b) {
    if (!active) return;
    const float* a0 = a + a_off[0];
    const float* a1 = a + a_off[1];
    b += b_off;
#pragma unroll 2
    for (int k = 0; k < kn; k += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
      const float xa[4] = {x0.x, x0.y, x0.z, x0.w};
      const float xb[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 bv = *reinterpret_cast<const float4*>(b + (k + e) * ldb);
        acc[0][0] = fmaf(xa[e], bv.x, acc[0][0]);
        acc[0][1] = fmaf(xa[e], bv.y, acc[0][1]);
        acc[0][2] = fmaf(xa[e], bv.z, acc[0][2]);
        acc[0][3] = fmaf(xa[e], bv.w, acc[0][3]);
        acc[1][0] = fmaf(xb[e], bv.x, acc[1][0]);
        acc[1][1] = fmaf(xb[e], bv.y, acc[1][1]);
        acc[1][2] = fmaf(xb[e], bv.z, acc[1][2]);
        acc[1][3] = fmaf(xb[e], bv.w, acc[1][3]);
      }
    }
  }

  // groups 1.. leave their partials in red ((groups - 1) x R x w floats),
  // group 0 adds them in group order; every thread of the CTA calls this
  __device__ __forceinline__ void reduce(float* red) {
    if (groups == 1) return;
    const int plane = 2 * r_half * w_;
    if (active && g > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[(g - 1) * plane + (rg + i * r_half) * w_ + cg_ * 4 + j] =
              acc[i][j];
    }
    __syncthreads();
    if (g == 0) {
      for (int q = 1; q < groups; ++q)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] += red[(q - 1) * plane + (rg + i * r_half) * w_ +
                             cg_ * 4 + j];
    }
  }

  template <typename F>
  __device__ __forceinline__ void for_each(F f) const {
    if (g != 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) f(rg + i * r_half, cg_ * 4 + j, acc[i][j]);
  }
};

template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  using type = MmaBf16;
};
template <>
struct Mma<float> {
  using type = FmaF32;
};

// ---------------------------------------------------------------------
// `rows` == nullptr: position p loads x[p] and stores out[p].  Otherwise
// p loads x[min(rows[p], t_last)] and stores out[rows[p]] (the fused
// dispatch: padding positions hold the trash id t_last + 1, and a row
// block of padding only is skipped).  Input columns at or past x_cols
// read as zero; x_vec says x's rows can be copied 16 B at a time (row
// stride and base 16-B aligned), else they are loaded element by element.
// Launch: blockIdx.x / kCluster is the row block, a cluster of kCluster
// CTAs along x, kThreads threads, Plan<T>(R, d_h_p, d_out_p).bytes of
// dynamic shared memory.
template <typename T>
__device__ __forceinline__ void switched_tile(
    const T* __restrict__ x, int x_cols, int x_ld, bool x_vec,
    const int* __restrict__ rows, int t_last,
    const int* __restrict__ tile_cls, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2,
    const T* __restrict__ b2, T* __restrict__ out, int d_in_p, int d_h_p,
    int d_out_p, int block_t) {
  using S = Shape<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int src_row[32];
  __shared__ int dst_row[32];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const uint32_t smem0 = smem_addr(smem_raw);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int R = row_block(block_t);
  const Plan<T> plan(R, d_h_p, d_out_p);
  const int p0 = (blockIdx.x / kCluster) * R;
  const int tid = threadIdx.x;

  bool real = false;
  if (tid < R) {
    const int p = p0 + tid;
    const int dst = rows == nullptr ? p : rows[p];
    src_row[tid] = rows == nullptr ? p : min(dst, t_last);
    dst_row[tid] = dst;
    real = dst <= t_last;
  }
  // every CTA of the cluster sees the same rows, so all leave together
  if (!__syncthreads_or(real || rows == nullptr)) return;

  const int c = tile_cls == nullptr ? 0 : tile_cls[p0 / block_t];
  const T* w1c = w1 + (size_t)c * d_in_p * d_h_p + rank * plan.hs;
  const T* b1c = b1 + (size_t)c * d_h_p + rank * plan.hs;
  const int col0 = rank * plan.ns;
  const T* w2c = w2 + (size_t)c * d_h_p * d_out_p + col0;
  const T* b2c = b2 + (size_t)c * d_out_p + col0;
  T* hslice = smem + plan.hs_off;
  T* hfull = smem + plan.hf_off;
  const T* b1s = smem + plan.bias_off;  // this CTA's b1 and b2 slices,
  const T* b2s = b1s + plan.hs;         // copied with stage 0
  float* red = reinterpret_cast<float*>(smem + plan.red_off);
  const uint32_t slot_bytes = plan.slot * sizeof(T);
  const uint32_t b1_bytes = R * plan.lda1 * sizeof(T);
  typename Mma<T>::type mma;

  // ---- phase 1: this CTA's hs hidden units, stage s = k block s
  const int nk1 = d_in_p / S::kK;
  const int ldb1 = plan.hs + S::kPad;
  Copies<T> cx, cw;
  cx.plan(R, S::kK, plan.lda1,
          [&](int r) { return (size_t)src_row[r] * x_ld; });
  cw.plan(S::kK, plan.hs, ldb1, [&](int r) { return (size_t)r * d_h_p; });
  auto load1 = [&](int s) {
    const uint32_t a = smem0 + (s % kStages) * slot_bytes;
    const int k0 = s * S::kK;
    if (x_vec) {
      cx.fetch_x(a, x, k0, x_cols);
    } else {
      T* d = smem + (s % kStages) * plan.slot;
      for (int i = tid; i < R * S::kK; i += kThreads) {
        const int r = i / S::kK, col = k0 + i % S::kK;
        d[r * plan.lda1 + i % S::kK] =
            col < x_cols ? x[(size_t)src_row[r] * x_ld + col]
                         : from_f32<T>(0.f);
      }
    }
    cw.fetch(a + b1_bytes, w1c + (size_t)k0 * d_h_p);
  };
  {  // the bias slices ride with stage 0
    constexpr int V = S::kVec;
    const int n1 = plan.hs / V, n2 = plan.ns / V;
    for (int i = tid; i < n1 + n2; i += kThreads)
      cp_async16(smem0 + plan.bias_off * sizeof(T) + i * 16,
                 i < n1 ? b1c + i * V : b2c + (i - n1) * V);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk1) load1(s);
    cp_async_commit();
  }
  mma.init(plan.lda1, ldb1, R, plan.hs);
  mma.zero();
  for (int s = 0; s < nk1; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < nk1) load1(s + kStages - 1);
    cp_async_commit();
    const T* a = smem + (s % kStages) * plan.slot;
    mma.step(a, a + R * plan.lda1);
  }
  mma.reduce(red);
  mma.for_each([&](int r, int col, float v) {
    hslice[r * plan.hs_ld + col] = from_f32<T>(tanhf(v + to_f32(b1s[col])));
  });
  __syncthreads();  // the ring is free again

  // ---- phase 2: this CTA's ns output columns in chunks of w2 columns,
  // stage s = (chunk s / nk2, k block s % nk2)
  const int nk2 = d_h_p / S::kK;
  const int w2n = chunk_cols(plan.ns);
  const int n2 = plan.ns / w2n * nk2;
  const int ldb2 = w2n + S::kPad;
  cw.plan(S::kK, w2n, ldb2, [&](int r) { return (size_t)r * d_out_p; });
  auto load2 = [&](int s) {
    const int j = s / nk2, k0 = (s % nk2) * S::kK;
    cw.fetch(smem0 + (s % kStages) * slot_bytes,
             w2c + (size_t)k0 * d_out_p + j * w2n);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // W2 streams in during the swap
    if (s < n2) load2(s);
    cp_async_commit();
  }

  // ---- the whole h from the cluster's eight slices, 4 copies in flight
  cluster.sync();
  {
    constexpr int V = S::kVec;
    const int per_row = plan.hs / V, per_rank = R * per_row;
    for (int i0 = 0; i0 < kCluster * per_rank; i0 += 4 * kThreads) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads + tid;
        if (i < kCluster * per_rank) {
          const int q = i / per_rank, r = (i % per_rank) / per_row;
          const int col = (i % per_row) * V;
          v[u] = *reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(hslice, q) + r * plan.hs_ld + col);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads + tid;
        if (i < kCluster * per_rank) {
          const int q = i / per_rank, r = (i % per_rank) / per_row;
          const int col = (i % per_row) * V;
          *reinterpret_cast<uint4*>(hfull + r * plan.hf_ld + q * plan.hs +
                                    col) = v[u];
        }
      }
    }
  }
  cluster.sync();  // every slice read: a CTA may now leave

  mma.init(plan.hf_ld, ldb2, R, w2n);
  for (int s = 0; s < n2; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < n2) load2(s + kStages - 1);
    cp_async_commit();
    const int j = s / nk2, kk = s % nk2;
    if (kk == 0) mma.zero();
    mma.step(hfull + kk * S::kK, smem + (s % kStages) * plan.slot);
    if (kk == nk2 - 1) {
      mma.reduce(red);
      const int c0 = j * w2n;
      mma.for_each([&](int r, int col, float v) {
        out[(size_t)dst_row[r] * d_out_p + col0 + c0 + col] =
            from_f32<T>(v + to_f32(b2s[c0 + col]));
      });
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------
// Host side, shared by the three launchers.

// Launch `kernel` over n_rows padded positions; returns the first CUDA
// error code of the shared-memory attribute or the launch, else 0.
template <typename T, typename... P, typename... A>
int launch(void (*kernel)(P...), int n_rows, int d_h_p, int d_out_p,
           int block_t, void* stream, A... args) {
  const int r = row_block(block_t);
  const Plan<T> plan(r, d_h_p, d_out_p);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(plan.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_rows / r) * kCluster);
  kernel<<<grid, kThreads, plan.bytes, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// out[0..4] = registers per thread, static shared bytes, dynamic shared
// bytes of a launch at (d_h_p, d_out_p, block_t), local (spill) bytes,
// cluster width; returns the CUDA error code.
template <typename T, typename... P>
int resources(void (*kernel)(P...), int d_h_p, int d_out_p, int block_t,
              int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(Plan<T>(row_block(block_t), d_h_p, d_out_p).bytes);
  out[3] = static_cast<int>(a.localSizeBytes);
  out[4] = a.requiredClusterWidth;
  return 0;
}

}  // namespace switch_tile
