// The stabilized sLSTM recurrence over a whole sequence, in one launch.
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
// Design: one CTA per (batch row, head).  The recurrence is block-diagonal
// per head and the batch rows are independent, so CTAs never talk to each
// other and the whole time loop runs inside the launch with the state in
// shared memory, as the TPU kernel keeps it in VMEM.  Thread j owns hidden
// unit j (looping when hd exceeds the block) and sums h . wh[head][:, g*hd
// + j] for the four gates g; row i of wh is then read coalesced across the
// threads.  A __syncthreads() between steps publishes the new h.
//
// Bound on an H100 at xlstm-1.3b's prefill (S 256, B 8, H 4, hd 512, bf16
// wh): about 92 MB of xg, ys, wh and state, about 17 GFLOP, so the bytes
// bound it (27 us).  This first version is bound by the sequential steps
// instead: each CTA streams its head's 2 MiB of wh from L2 every step (wh,
// 8 MiB, stays in the 50 MB L2), with 32 CTAs on 132 SMs and no tensor
// cores.  Making it fast (wh resident in shared memory across many CTAs, a
// cooperative grid barrier per step, mma) is later work; see PERF.md.
//
// Numerics: expf, tanhf and log1pf (no fast math);
// log_sigmoid(x) = min(x, 0) - log1p(exp(-|x|)); an initial m of -1e30
// gives f = exp(-1e30 - i~) = 0 with no inf or NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kIClamp = 8.0f;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// xg (S, B, H, 4 hd) f32; wh (H, hd, 4 hd) T; states (B, H, hd) f32;
// ys (S, B, H, hd) f32.  Grid: B * H CTAs, CTA r = b * H + head.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    slstm_scan_kernel(const float* __restrict__ xg, const T* __restrict__ wh,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0, float* __restrict__ ys,
                      float* __restrict__ hf, float* __restrict__ cf,
                      float* __restrict__ nf, float* __restrict__ mf,
                      int s_len, int batch, int heads, int hd) {
  extern __shared__ float smem[];
  float* hr = smem;       // h rounded to wh's type: the product's operand
  float* hs = hr + hd;    // h in f32
  float* cs = hs + hd;
  float* ns = cs + hd;
  float* ms = ns + hd;

  const int row = blockIdx.x;
  const int head = row % heads;
  const int hd4 = 4 * hd;
  const T* w = wh + (size_t)head * hd * hd4;
  const size_t st = (size_t)row * hd;
  const size_t xg_step = (size_t)batch * heads * hd4;
  const size_t y_step = (size_t)batch * heads * hd;

  for (int j = threadIdx.x; j < hd; j += blockDim.x) {
    const float h = h0[st + j];
    hs[j] = h;
    hr[j] = round_to<T>(h);
    cs[j] = c0[st + j];
    ns[j] = n0[st + j];
    ms[j] = m0[st + j];
  }
  __syncthreads();

  for (int t = 0; t < s_len; ++t) {
    const float* g_in = xg + t * xg_step + (size_t)row * hd4;
    float* y = ys + t * y_step + st;
    for (int j = threadIdx.x; j < hd; j += blockDim.x) {
      float rz = 0.f, ri = 0.f, rf = 0.f, ro = 0.f;
      const T* wj = w + j;
#pragma unroll 4
      for (int i = 0; i < hd; ++i) {
        const float hv = hr[i];
        const T* wi = wj + (size_t)i * hd4;
        rz = fmaf(hv, to_f32(wi[0]), rz);
        ri = fmaf(hv, to_f32(wi[hd]), ri);
        rf = fmaf(hv, to_f32(wi[2 * hd]), rf);
        ro = fmaf(hv, to_f32(wi[3 * hd]), ro);
      }
      const float z = tanhf(g_in[j] + rz);
      const float i_pre = fminf(g_in[hd + j] + ri, kIClamp);
      const float log_f = log_sigmoid(g_in[2 * hd + j] + rf);
      const float o = 1.f / (1.f + expf(-(g_in[3 * hd + j] + ro)));
      const float m_prev = ms[j];
      const float m_new = fmaxf(log_f + m_prev, i_pre);
      const float i_s = expf(i_pre - m_new);
      const float f_s = expf(log_f + m_prev - m_new);
      const float c = f_s * cs[j] + i_s * z;
      const float n = f_s * ns[j] + i_s;
      const float h = o * c / fmaxf(n, 1e-6f);
      cs[j] = c;
      ns[j] = n;
      ms[j] = m_new;
      hs[j] = h;
      y[j] = h;
    }
    __syncthreads();  // every thread has read hr for this step
    for (int j = threadIdx.x; j < hd; j += blockDim.x) hr[j] = round_to<T>(hs[j]);
    __syncthreads();  // the new h is visible to every thread
  }

  for (int j = threadIdx.x; j < hd; j += blockDim.x) {
    hf[st + j] = hs[j];
    cf[st + j] = cs[j];
    nf[st + j] = ns[j];
    mf[st + j] = ms[j];
  }
}

template <typename T>
int launch(const void* xg, const void* wh, const void* h0, const void* c0,
           const void* n0, const void* m0, void* ys, void* hf, void* cf,
           void* nf, void* mf, int s_len, int batch, int heads, int hd,
           void* stream) {
  int threads = (hd + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = 5 * (size_t)hd * sizeof(float);
  slstm_scan_kernel<T><<<batch * heads, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xg), static_cast<const T*>(wh),
      static_cast<const float*>(h0), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<float*>(ys), static_cast<float*>(hf),
      static_cast<float*>(cf), static_cast<float*>(nf),
      static_cast<float*>(mf), s_len, batch, heads, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int slstm_scan_f32(const void* xg, const void* wh, const void* h0,
                              const void* c0, const void* n0, const void* m0,
                              void* ys, void* hf, void* cf, void* nf, void* mf,
                              int s_len, int batch, int heads, int hd,
                              void* stream) {
  return launch<float>(xg, wh, h0, c0, n0, m0, ys, hf, cf, nf, mf, s_len,
                       batch, heads, hd, stream);
}

extern "C" int slstm_scan_bf16(const void* xg, const void* wh, const void* h0,
                               const void* c0, const void* n0, const void* m0,
                               void* ys, void* hf, void* cf, void* nf,
                               void* mf, int s_len, int batch, int heads,
                               int hd, void* stream) {
  return launch<__nv_bfloat16>(xg, wh, h0, c0, n0, m0, ys, hf, cf, nf, mf,
                               s_len, batch, heads, hd, stream);
}
