// The stabilized sLSTM recurrence over a whole sequence, in one cooperative
// launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/slstm_scan.py
// (slstm_scan, body _slstm_kernel).  Per step t, for every (batch row b,
// head), with the f32 state (h, c, n, m) carried across steps:
//   rec = (h -> rounded to wh's type) . wh[head]        (f32 sums)
//   g   = xg[t, b, head] + rec, gates [z | i | f | o] of hd each
//   z = tanh(gz)   o = sigmoid(go)   log_f = log_sigmoid(gf)
//   i~ = min(gi, 8)   m' = max(log_f + m, i~)
//   c' = exp(log_f + m - m') c + exp(i~ - m') z
//   n' = exp(log_f + m - m') n + exp(i~ - m')
//   h' = o c' / max(n', 1e-6)
// and ys[t, b, head] = h'; the last step's state is stored as the finals.
//
// What bounds it on an H100.  At xlstm-1.3b's prefill (S 256, B 8, H 4,
// hd 512, bf16 wh) the call moves about 92 MB and does about 17 GFLOP, a
// bound of 28 us; but its 256 steps are dependent, and each needs the
// whole h of its head from the step before.  The TPU kernel keeps wh
// (8 MiB) resident in VMEM for the whole sequence; no SM holds 8 MiB, so
// a design that streams wh from L2 every step (one CTA per (batch row,
// head) reads 64 MiB through L2 per step) is bound by that traffic.  Here
// the floor is the latency of one step: an exchange of h between CTAs,
// the product, the gating.
//
// Design.  A persistent grid, launched with cudaLaunchCooperativeKernel so
// that every CTA is resident at once (a grid that cannot be is refused,
// never run):
//   * CTA (head, i) owns `units` hidden units j0 = i * units ... of one
//     head, with all four gate columns of each (columns g * hd + j of
//     wh[head]), for every batch row: the gating stays inside the CTA and
//     a weight is read once per step per SM, not once per batch row.
//   * Its slice of wh[head] (hd x 4 units) is copied into shared memory
//     once, with 16-byte cp.async where aligned, and stays there for all S
//     steps (xlstm-1.3b: 128 CTAs of 16 units, 64 KiB of bf16 each).
//   * A step takes the batch rows kRows (8) at a time, one mma n-tile, so
//     shared memory does not grow with the batch: for each chunk of rows it
//     reads the previous h of its head from ys[t-1] (h0 at t = 0) through
//     L2 (__ldcg), rounds it to wh's type into shared memory, computes its
//     units and writes ys[t].  The state (c, n, m) of a (row, unit) pair
//     is held by the one thread that owns the pair: in its registers when
//     the batch is one chunk, else in the outputs cf, nf, mf (c0, n0, m0
//     at t = 0), loaded while h is staged; a batch of one chunk has its
//     own instantiation of the kernel.  After its last chunk a step meets
//     the other CTAs of its head at one counter barrier (__threadfence
//     before the arrive, an ld.acquire.gpu spin).  One barrier a step is
//     enough: the reads of step t+1 are of ys[t], finished before it.  The
//     last step has none, so decode (S = 1) has no barrier at all.
//   * The next chunk's slice of xg (kRows x 4 units floats) is prefetched
//     with cp.async, into a ring of three slots, while this one computes.
//   * Products: bf16 wh on the tensor cores (mma.sync m16n8k16, f32
//     accumulate): A = the weight slice (M = 4 units gate columns, K = hd,
//     stored k-major and read by ldmatrix.trans), B = h^T (N = the chunk's
//     8 batch rows, zero-padded).  f32 wh on the CUDA cores with fmaf, no
//     TF32.  K is split over warps (bf16) or thread groups (f32), and the
//     partial sums are added in shared memory in a fixed order, so a
//     result is the same from run to run.
//
// Numerics: expf, tanhf and log1pf (no fast math);
// log_sigmoid(x) = min(x, 0) - log1p(exp(-|x|)); an initial m of -1e30
// gives f = exp(-1e30 - i~) = 0 with no inf or NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kIClamp = 8.0f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMTiles = 8;  // bf16: 4 * units / 16 m-tiles, units <= 32
constexpr int kRows = 8;       // batch rows per chunk: one mma n-tile
// (row, unit) pairs of a chunk per thread: kRows * units <= kRows * 64
constexpr int kPairs = kRows * 64 / kThreads;
// xg ring slots: item it + 1 is prefetched at the start of item it into
// the slot of item it - 2, whose gating ended before item it - 1's h was
// staged, so the ring needs no barrier of its own
constexpr int kSlots = 3;
constexpr int kMaxDevices = 64;

// Shared-memory layout of one CTA; kernels/slstm_scan.py::smem_bytes
// mirrors `bytes`.  It does not depend on the batch.  wsm [kp][ldw] T: row
// k holds the 4 * units columns as [gate][unit]; hsm [kRows][ldh] T: h of
// the chunk's batch rows, rounded; red [parts][kRows][m] f32: partial
// products; xs [kSlots][kRows][m] f32: xg ring.
struct Layout {
  int m, kp, ldw, ldh, parts;
  size_t h_off, red_off, x_off, bytes;
  __host__ __device__ Layout(bool bf16, int hd, int units) {
    m = 4 * units;
    kp = bf16 ? (hd + 15) / 16 * 16 : (hd + 3) / 4 * 4;
    ldw = bf16 ? m + 8 : m;    // + 16 B: ldmatrix rows in distinct banks
    ldh = bf16 ? kp + 8 : kp;
    parts = bf16 ? kWarps : kThreads / m;
    const size_t esz = bf16 ? 2 : 4;
    h_off = static_cast<size_t>(kp) * ldw * esz;
    red_off = h_off + static_cast<size_t>(kRows) * ldh * esz;
    x_off = red_off + static_cast<size_t>(parts) * kRows * m * 4;
    bytes = x_off + static_cast<size_t>(kSlots) * kRows * m * 4;
  }
};

struct Args {
  const float* xg;
  const void* wh;
  const float* h0;
  const float* c0;
  const float* n0;
  const float* m0;
  float* ys;
  float* hf;
  float* cf;
  float* nf;
  float* mf;
  unsigned* ctr;  // one arrival counter per head, zero at launch
  int s_len, batch, heads, hd, units, vec;
};

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

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The CTAs of one head meet here: every thread's stores of this step are
// published before thread 0 arrives, and no thread goes on before all
// `target` arrivals are seen.  A barrier still open after 2^28 polls (far
// beyond any real wait) traps, so a fault shows as a launch error, not a
// hung card.
__device__ __forceinline__ void head_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    unsigned v;
    for (unsigned polls = 0;; ++polls) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(ctr)
                   : "memory");
      if (v >= target) break;
      if (polls == (1u << 28)) __trap();
    }
  }
  __syncthreads();
}

// The recurrent product on the tensor cores, for the chunk's kRows batch
// rows (one n-tile): warp w takes the k steps w, w + 8, ... of every m-tile
// and writes its partial sums to red[w][b][c].
__device__ __forceinline__ void products(const Layout& L,
                                         const __nv_bfloat16* wsm,
                                         const __nv_bfloat16* hsm,
                                         float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = L.m / 16, ks = L.kp / 16;
  // ldmatrix row addresses: A as x4.trans from the k-major slice (matrices
  // m +0/+8 by k +0/+8), B as x2 from h's [b][k] rows (k +0/+8)
  const uint32_t a_lane =
      smem_addr(wsm) +
      2 * ((((lane >> 4) << 3) + (lane & 7)) * L.ldw + ((lane >> 3) & 1) * 8);
  const uint32_t b_lane =
      smem_addr(hsm) + 2 * ((lane & 7) * L.ldh + ((lane >> 3) & 1) * 8);
  float acc[kMaxMTiles][4];
#pragma unroll
  for (int i = 0; i < kMaxMTiles; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kk = warp; kk < ks; kk += kWarps) {
    uint32_t fb[2];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(fb[0]), "=r"(fb[1])
        : "r"(b_lane + 2 * (kk * 16)));
    const uint32_t a_k = a_lane + 2 * (kk * 16 * L.ldw);
#pragma unroll
    for (int mi = 0; mi < kMaxMTiles; ++mi) {
      if (mi < mt) {
        uint32_t fa[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(fa[0]), "=r"(fa[1]), "=r"(fa[2]), "=r"(fa[3])
            : "r"(a_k + 2 * (mi * 16)));
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[mi][0]), "+f"(acc[mi][1]), "+f"(acc[mi][2]),
              "+f"(acc[mi][3])
            : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "r"(fb[0]),
              "r"(fb[1]));
      }
    }
  }
  float* r = red + static_cast<size_t>(warp) * kRows * L.m;
  const int row = lane >> 2, col = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < kMaxMTiles; ++mi) {
    if (mi < mt) {
      const int c = mi * 16 + row;
      r[col * L.m + c] = acc[mi][0];
      r[(col + 1) * L.m + c] = acc[mi][1];
      r[col * L.m + c + 8] = acc[mi][2];
      r[(col + 1) * L.m + c + 8] = acc[mi][3];
    }
  }
}

// The recurrent product on the CUDA cores: thread (group q, column c) sums
// k over group q's range in order, for each of the chunk's kRows batch
// rows, into red[q][b][c].
__device__ __forceinline__ void products(const Layout& L, const float* wsm,
                                         const float* hsm, float* red) {
  const int c = threadIdx.x % L.m, q = threadIdx.x / L.m;
  if (q >= L.parts) return;
  const int kc = ((L.kp + L.parts - 1) / L.parts + 3) / 4 * 4;
  const int k_lo = min(q * kc, L.kp), k_hi = min(k_lo + kc, L.kp);
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  for (int k = k_lo; k < k_hi; k += 4) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = wsm[(k + i) * L.m + c];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 h = *reinterpret_cast<const float4*>(hsm + i * L.ldh + k);
      acc[i] = fmaf(h.x, w[0], acc[i]);
      acc[i] = fmaf(h.y, w[1], acc[i]);
      acc[i] = fmaf(h.z, w[2], acc[i]);
      acc[i] = fmaf(h.w, w[3], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    red[(static_cast<size_t>(q) * kRows + i) * L.m + c] = acc[i];
}

// xg (S, B, H, 4 hd) f32; wh (H, hd, 4 hd) T; states (B, H, hd) f32;
// ys (S, B, H, hd) f32.  Grid: H * ceil(hd / units) CTAs, CTA (head, i) =
// head * ceil(hd / units) + i.  Work item it = t * chunks + ch is chunk ch
// (batch rows ch * kRows ...) of step t.  kOneChunk: batch <= kRows, so
// the chunk arithmetic folds away.
template <typename T, bool kOneChunk>
__global__ void __launch_bounds__(kThreads, 1) slstm_scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = sizeof(T) == 2;
  const Layout L(kBf16, a.hd, a.units);
  T* wsm = reinterpret_cast<T*>(smem);
  T* hsm = reinterpret_cast<T*>(smem + L.h_off);
  float* red = reinterpret_cast<float*>(smem + L.red_off);
  float* xs = reinterpret_cast<float*>(smem + L.x_off);

  const int tid = threadIdx.x, u = a.units, m = L.m, batch = a.batch;
  const int hd = a.hd, hd4 = 4 * hd;
  const int cph = (hd + u - 1) / u;
  const int head = blockIdx.x / cph, j0 = (blockIdx.x % cph) * u;
  const int chunks = kOneChunk ? 1 : (batch + kRows - 1) / kRows;
  const int items = a.s_len * chunks;
  const size_t row = static_cast<size_t>(a.heads) * hd;  // batch row stride
  const size_t y_step = batch * row;
  const size_t xg_row = static_cast<size_t>(a.heads) * hd4;

  // this CTA's slice of wh[head] into shared memory, once; columns past hd
  // and rows k >= hd are zero
  const T* w_src = static_cast<const T*>(a.wh) + static_cast<size_t>(head) *
                                                     hd * hd4;
  if (a.vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = m / E;
    for (int i = tid; i < L.kp * per_row; i += kThreads) {
      const int k = i / per_row, c = (i % per_row) * E;
      const int g = c / u, j = j0 + c % u;
      const bool in = k < hd && j < hd;
      cp_async16(smem_addr(wsm + k * L.ldw + c),
                 in ? w_src + static_cast<size_t>(k) * hd4 + g * hd + j
                    : w_src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < L.kp * m; i += kThreads) {
      const int k = i / m, c = i % m, g = c / u, j = j0 + c % u;
      wsm[k * L.ldw + c] =
          k < hd && j < hd ? w_src[static_cast<size_t>(k) * hd4 + g * hd + j]
                           : from_f32<T>(0.f);
    }
  }
  for (int i = tid; i < kRows * L.ldh; i += kThreads) hsm[i] = from_f32<T>(0.f);

  // xg of work item it, [b][gate][unit], into ring slot it % kSlots
  auto prefetch = [&](int it) {
    const int t = it / chunks, b0 = (it % chunks) * kRows;
    const int nb = min(kRows, batch - b0);
    const float* src = a.xg + (static_cast<size_t>(t) * batch + b0) * xg_row +
                       static_cast<size_t>(head) * hd4;
    float* dst = xs + (it % kSlots) * kRows * m;
    for (int i = tid; i < nb * m; i += kThreads) {
      const int b = i / m, c = i % m, g = c / u, j = j0 + c % u;
      const bool in = j < hd;
      cp_async4(smem_addr(dst + i), in ? src + b * xg_row + g * hd + j : src,
                in ? 4 : 0);
    }
  };
  prefetch(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const bool h_vec = hd % 4 == 0;
  // with one chunk (batch <= kRows) the state stays in registers from step
  // to step, and goes to cf, nf, mf only after the last
  constexpr bool carry = kOneChunk;
  float sc[kPairs], sn[kPairs], sm[kPairs];
  for (int it = 0; it < items; ++it) {
    const int t = it / chunks, ch = it % chunks, b0 = ch * kRows;
    const int nb = min(kRows, batch - b0), pairs = u * nb;
    const bool last = t + 1 == a.s_len;
    if (it + 1 < items) prefetch(it + 1);
    cp_async_commit();

    // the state of the pairs this thread owns: tid + r * kThreads
    const float* c_src = t == 0 ? a.c0 : a.cf;
    const float* n_src = t == 0 ? a.n0 : a.nf;
    const float* m_src = t == 0 ? a.m0 : a.mf;
#pragma unroll
    for (int r = 0; r < kPairs; ++r) {
      const int p = tid + r * kThreads, j = j0 + p % u;
      if ((t == 0 || !carry) && p < pairs && j < hd) {
        const size_t o =
            (b0 + p / u) * row + static_cast<size_t>(head) * hd + j;
        sc[r] = c_src[o];
        sn[r] = n_src[o];
        sm[r] = m_src[o];
      }
    }

    // h of the step before, the chunk's batch rows of this head, rounded
    const float* h_src = (t == 0 ? a.h0 : a.ys + (t - 1) * y_step) +
                         b0 * row + static_cast<size_t>(head) * hd;
    if (t > 0 && h_vec) {
      const int per_row = hd / 4, n4 = nb * per_row;
      for (int q0 = tid; q0 < n4; q0 += 4 * kThreads) {
        float4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + i * kThreads;
          if (q < n4)
            v[i] = __ldcg(reinterpret_cast<const float4*>(
                h_src + (q / per_row) * row + (q % per_row) * 4));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + i * kThreads;
          if (q < n4)
            store4(hsm + (q / per_row) * L.ldh + (q % per_row) * 4, v[i]);
        }
      }
    } else {
      for (int q = tid; q < nb * hd; q += kThreads)
        hsm[(q / hd) * L.ldh + q % hd] =
            from_f32<T>(__ldcg(h_src + (q / hd) * row + q % hd));
    }
    __syncthreads();

    products(L, wsm, hsm, red);
    cp_async_wait<1>();  // this item's xg has landed
    __syncthreads();

    const float* x_t = xs + (it % kSlots) * kRows * m;
    float* y = a.ys + t * y_step + static_cast<size_t>(head) * hd;
#pragma unroll
    for (int r = 0; r < kPairs; ++r) {
      const int p = tid + r * kThreads, bl = p / u, jl = p % u, j = j0 + jl;
      if (p >= pairs || j >= hd) continue;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float acc = 0.f;
        for (int q = 0; q < L.parts; ++q)
          acc += red[(q * kRows + bl) * m + g * u + jl];
        gate[g] = x_t[bl * m + g * u + jl] + acc;
      }
      const float z = tanhf(gate[0]);
      const float i_pre = fminf(gate[1], kIClamp);
      const float log_f = log_sigmoid(gate[2]);
      const float o = 1.f / (1.f + expf(-gate[3]));
      const float m_new = fmaxf(log_f + sm[r], i_pre);
      const float i_s = expf(i_pre - m_new);
      const float f_s = expf(log_f + sm[r] - m_new);
      const float c = f_s * sc[r] + i_s * z;
      const float n = f_s * sn[r] + i_s;
      const float h = o * c / fmaxf(n, 1e-6f);
      y[(b0 + bl) * row + j] = h;
      sc[r] = c;
      sn[r] = n;
      sm[r] = m_new;
      if (!carry || last) {
        const size_t o_st =
            (b0 + bl) * row + static_cast<size_t>(head) * hd + j;
        a.cf[o_st] = c;
        a.nf[o_st] = n;
        a.mf[o_st] = m_new;
        if (last) a.hf[o_st] = h;
      }
    }
    if (!last && ch + 1 == chunks)
      head_barrier(a.ctr + head, static_cast<unsigned>(t + 1) * cph);
  }
}

// Lets the kernel take `bytes` of dynamic shared memory; the attribute is
// raised once per device, not on every launch.
template <typename T, bool kOneChunk>
int allow_smem(size_t bytes) {
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool cached = dev < kMaxDevices;
  if (cached && bytes <= allowed[dev]) return 0;
  e = cudaFuncSetAttribute(slstm_scan_kernel<T, kOneChunk>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && cached) allowed[dev] = bytes;
  return static_cast<int>(e);
}

// A grid that cannot be resident at once is refused by the cooperative
// launch itself (cudaErrorCooperativeLaunchTooLarge).
template <typename T, bool kOneChunk>
int launch(Args a, void* stream) {
  const Layout L(sizeof(T) == 2, a.hd, a.units);
  a.vec = (a.hd * sizeof(T)) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.wh) % 16 == 0;
  const int err = allow_smem<T, kOneChunk>(L.bytes);
  if (err) return err;
  const int grid = a.heads * ((a.hd + a.units - 1) / a.units);
  void* params[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(slstm_scan_kernel<T, kOneChunk>),
      dim3(grid), dim3(kThreads), params, L.bytes,
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

template <typename T>
int launch(const void* xg, const void* wh, const void* h0, const void* c0,
           const void* n0, const void* m0, void* ys, void* hf, void* cf,
           void* nf, void* mf, void* ctr, int s_len, int batch, int heads,
           int hd, int units, void* stream) {
  Args a{static_cast<const float*>(xg), wh,
         static_cast<const float*>(h0), static_cast<const float*>(c0),
         static_cast<const float*>(n0), static_cast<const float*>(m0),
         static_cast<float*>(ys), static_cast<float*>(hf),
         static_cast<float*>(cf), static_cast<float*>(nf),
         static_cast<float*>(mf), static_cast<unsigned*>(ctr),
         s_len, batch, heads, hd, units, 0};
  return batch <= kRows ? launch<T, true>(a, stream)
                        : launch<T, false>(a, stream);
}

template <typename T, bool kOneChunk>
int resources(int hd, int units, int* out) {
  const Layout L(sizeof(T) == 2, hd, units);
  const int err = allow_smem<T, kOneChunk>(L.bytes);
  if (err) return err;
  cudaFuncAttributes fa;
  cudaError_t e =
      cudaFuncGetAttributes(&fa, slstm_scan_kernel<T, kOneChunk>);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, slstm_scan_kernel<T, kOneChunk>, kThreads, L.bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.sharedSizeBytes);
  out[2] = static_cast<int>(L.bytes);
  out[3] = static_cast<int>(fa.localSizeBytes);
  out[4] = per_sm;
  return 0;
}

}  // namespace

extern "C" int slstm_scan_f32(const void* xg, const void* wh, const void* h0,
                              const void* c0, const void* n0, const void* m0,
                              void* ys, void* hf, void* cf, void* nf, void* mf,
                              void* ctr, int s_len, int batch, int heads,
                              int hd, int units, void* stream) {
  return launch<float>(xg, wh, h0, c0, n0, m0, ys, hf, cf, nf, mf, ctr, s_len,
                       batch, heads, hd, units, stream);
}

extern "C" int slstm_scan_bf16(const void* xg, const void* wh, const void* h0,
                               const void* c0, const void* n0, const void* m0,
                               void* ys, void* hf, void* cf, void* nf,
                               void* mf, void* ctr, int s_len, int batch,
                               int heads, int hd, int units, void* stream) {
  return launch<__nv_bfloat16>(xg, wh, h0, c0, n0, m0, ys, hf, cf, nf, mf,
                               ctr, s_len, batch, heads, hd, units, stream);
}

// out[0..4]: registers per thread, static and dynamic shared bytes, local
// (spill) bytes, CTAs that fit on one SM, of the kernel that a launch at
// (batch, hd, units) takes for wh's dtype `bf16` (0: f32, 1: bf16).
extern "C" int slstm_scan_resources(int bf16, int batch, int hd, int units,
                                    int* out) {
  const bool one = batch <= kRows;
  if (bf16)
    return one ? resources<__nv_bfloat16, true>(hd, units, out)
               : resources<__nv_bfloat16, false>(hd, units, out);
  return one ? resources<float, true>(hd, units, out)
             : resources<float, false>(hd, units, out);
}
