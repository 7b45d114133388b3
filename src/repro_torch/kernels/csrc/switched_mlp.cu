// Weight-switch grouped MLP over class-sorted rows.
//
// Replaces the Pallas TPU kernel src/repro/kernels/switched_mlp.py
// (switched_mlp, body _switched_kernel).  For each block_t-row tile i of
// x (t_pad, d_in_p) with c = tile_cls[i]:
//   y = (tanh(x . W1[c] + b1[c]) -> cast to x's type) . W2[c] + b2[c]
// with f32 sums, stored in x's type.
//
// Bound on an H100 at the decode path's shape (t_pad = 640, d_in_p =
// d_out_p = 2048, d_h_p = 256, bf16): the bytes, about 8.4 MB of weights
// for the (at most) four classes a tick touches plus 5.2 MB of rows in and
// out, against 1.3 GFLOP (4.1 us at 3.35 TB/s).  The tile compute lives in
// switch_tile.cuh, shared with the fused kernel: one cluster of 8 CTAs per
// 32-row block, h computed once per row block and exchanged through
// distributed shared memory, a 4-stage cp.async ring, bf16 products on the
// tensor cores (mma.sync), 95,808 B of shared memory per CTA in bf16.
#include "switch_tile.cuh"

namespace {

template <typename T>
__global__ void __cluster_dims__(switch_tile::kCluster, 1, 1)
    __launch_bounds__(switch_tile::kThreads, 2)
        switched_mlp_kernel(const T* __restrict__ x,
                            const int* __restrict__ tile_cls,
                            const T* __restrict__ w1, const T* __restrict__ b1,
                            const T* __restrict__ w2, const T* __restrict__ b2,
                            T* __restrict__ out, bool x_vec, int d_in_p,
                            int d_h_p, int d_out_p, int block_t) {
  switch_tile::switched_tile<T>(x, d_in_p, d_in_p, x_vec, nullptr, 0,
                                tile_cls, w1, b1, w2, b2, out, d_in_p, d_h_p,
                                d_out_p, block_t);
}

template <typename T>
int launch(const void* x, const void* tile_cls, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int t_pad, int d_in_p,
           int d_h_p, int d_out_p, int block_t, void* stream) {
  return switch_tile::launch<T>(
      switched_mlp_kernel<T>, t_pad, d_h_p, d_out_p, block_t, stream,
      static_cast<const T*>(x), static_cast<const int*>(tile_cls),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<T*>(out), reinterpret_cast<uintptr_t>(x) % 16 == 0, d_in_p,
      d_h_p, d_out_p, block_t);
}

}  // namespace

extern "C" int switched_mlp_f32(const void* x, const void* tile_cls,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, void* out, int t_pad,
                                int d_in_p, int d_h_p, int d_out_p,
                                int block_t, void* stream) {
  return launch<float>(x, tile_cls, w1, b1, w2, b2, out, t_pad, d_in_p, d_h_p,
                       d_out_p, block_t, stream);
}

extern "C" int switched_mlp_bf16(const void* x, const void* tile_cls,
                                 const void* w1, const void* b1, const void* w2,
                                 const void* b2, void* out, int t_pad,
                                 int d_in_p, int d_h_p, int d_out_p,
                                 int block_t, void* stream) {
  return launch<__nv_bfloat16>(x, tile_cls, w1, b1, w2, b2, out, t_pad, d_in_p,
                               d_h_p, d_out_p, block_t, stream);
}

// out[0..4]: registers, static and dynamic shared bytes, local bytes,
// cluster width of the kernel for dtype `bf16` (0: f32, 1: bf16).
extern "C" int switched_mlp_resources(int bf16, int d_h_p, int d_out_p,
                                      int block_t, int* out) {
  return bf16 ? switch_tile::resources<__nv_bfloat16>(
                    switched_mlp_kernel<__nv_bfloat16>, d_h_p, d_out_p,
                    block_t, out)
              : switch_tile::resources<float>(switched_mlp_kernel<float>,
                                              d_h_p, d_out_p, block_t, out);
}
