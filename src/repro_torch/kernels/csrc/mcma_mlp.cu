// Fused 2-layer tanh MLP for one approximator (the paper's NPU
// approximator, and the ApproxFFN's per-class MLP).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mcma_mlp.py
// (mlp_forward, body _mlp_kernel).  For x (T, d_in_p):
//   y = (tanh(x . W1 + b1) -> cast to x's type) . W2 + b2
// with f32 sums, stored in x's type.  The tile compute is the weight-switch
// routine of switch_tile.cuh with a single class (tile_cls == nullptr), so
// this kernel sums every output in the same order as the switched kernels.
//
// Bound on an H100 at the full-width ApproxFFN shape (T = 2048, d_in_p =
// d_out_p = 2048, d_h_p = 256): about 4.3 GFLOP against 19 MB (bf16) of
// rows, weights and output, so the bytes bound it in bf16 (5.6 us against
// 4.3 us of tensor-core time) and the f32 CUDA-core rate in f32 (64 us).
// This first version runs on CUDA cores
// and recomputes each row block's hidden chunk for each block of 128 output
// columns (the TPU kernel keeps h in VMEM once per row tile), so it is far
// from that bound; see PERF.md.
#include "switch_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(switch_tile::kThreads)
    mlp_forward_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                       const T* __restrict__ b1, const T* __restrict__ w2,
                       const T* __restrict__ b2, T* __restrict__ out,
                       int d_in_p, int d_h_p, int d_out_p, int block_t,
                       int rows_per_cta) {
  switch_tile::switched_tile<T>(x, d_in_p, d_in_p, nullptr, 0, nullptr, w1, b1,
                                w2, b2, out, d_in_p, d_h_p, d_out_p, block_t,
                                rows_per_cta);
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, int t, int d_in_p, int d_h_p,
           int d_out_p, int block_t, void* stream) {
  const int rpc = switch_tile::rows_per_cta(block_t);
  const dim3 grid(t / rpc, d_out_p / switch_tile::kCols);
  mlp_forward_kernel<T><<<grid, switch_tile::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), d_in_p, d_h_p, d_out_p,
      block_t, rpc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mlp_forward_f32(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out,
                               int t, int d_in_p, int d_h_p, int d_out_p,
                               int block_t, void* stream) {
  return launch<float>(x, w1, b1, w2, b2, out, t, d_in_p, d_h_p, d_out_p,
                       block_t, stream);
}

extern "C" int mlp_forward_bf16(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                int t, int d_in_p, int d_h_p, int d_out_p,
                                int block_t, void* stream) {
  return launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, t, d_in_p, d_h_p,
                               d_out_p, block_t, stream);
}
