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
// The routine's design (one cluster of 8 CTAs per 32-row block, h computed
// once per row block and exchanged through distributed shared memory, a
// 4-stage cp.async ring, bf16 on the tensor cores by mma.sync, 95,808 B of
// shared memory per CTA in bf16) is the switched kernels'; only the grid,
// T / 32 clusters, is this kernel's.  Each cluster reads the whole of W1
// and W2 (through L2) for its 32 rows.
#include "switch_tile.cuh"

namespace {

template <typename T>
__global__ void __cluster_dims__(switch_tile::kCluster, 1, 1)
    __launch_bounds__(switch_tile::kThreads, 2)
        mlp_forward_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                           const T* __restrict__ b1, const T* __restrict__ w2,
                           const T* __restrict__ b2, T* __restrict__ out,
                           bool x_vec, int d_in_p, int d_h_p, int d_out_p,
                           int block_t) {
  switch_tile::switched_tile<T>(x, d_in_p, d_in_p, x_vec, nullptr, 0, nullptr,
                                w1, b1, w2, b2, out, d_in_p, d_h_p, d_out_p,
                                block_t);
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, int t, int d_in_p, int d_h_p,
           int d_out_p, int block_t, void* stream) {
  return switch_tile::launch<T>(
      mlp_forward_kernel<T>, t, d_h_p, d_out_p, block_t, stream,
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out),
      reinterpret_cast<uintptr_t>(x) % 16 == 0, d_in_p, d_h_p, d_out_p,
      block_t);
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

// out[0..4]: registers, static and dynamic shared bytes, local bytes,
// cluster width of the kernel for dtype `bf16` (0: f32, 1: bf16).
extern "C" int mlp_forward_resources(int bf16, int d_h_p, int d_out_p,
                                     int block_t, int* out) {
  return bf16 ? switch_tile::resources<__nv_bfloat16>(
                    mlp_forward_kernel<__nv_bfloat16>, d_h_p, d_out_p, block_t,
                    out)
              : switch_tile::resources<float>(mlp_forward_kernel<float>, d_h_p,
                                              d_out_p, block_t, out);
}
