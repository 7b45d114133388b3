// Fused dispatch: the weight-switch grouped MLP over UNSORTED rows, with
// the class-sort gather and scatter folded into the row load and store.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_dispatch.py
// (switched_mlp_fused, bodies _fused_kernel and fused_row_index's use).
// rows (t_pad,) maps each padded position to its original row of x (T,
// d_in), or to the trash id T for padding.  A position loads row
// min(rows[p], T - 1), lanes d_in..d_in_p read as zero, and the result is
// stored at row rows[p] of the (T + 1, d_out_p) output, whose last row is
// the trash row.  Real rows are each written exactly once; a row block of
// padding only is skipped, and padding rows of a mixed block may race on
// the trash row, which the caller slices off.
//
// Bound on an H100 at the decode path's shape: the weight bytes (about
// 8.4 MB in bf16; 4.1 us at 3.35 TB/s for the switched kernel's byte count,
// 2.5 us here, since the activations cross device memory once, as the 8
// rows of x and of the output).  The tile compute is switch_tile.cuh,
// shared with switched_mlp.cu, so the two kernels agree bitwise on every
// real row: one cluster of 8 CTAs per 32-row block, h computed once per
// row block and exchanged through distributed shared memory, a 4-stage
// cp.async ring, bf16 products on the tensor cores (mma.sync), 95,808 B
// of shared memory per CTA in bf16.  x's rows are copied 16 B at a time
// where d_in * sizeof(T) is a multiple of 16, else element by element.
#include "switch_tile.cuh"

namespace {

template <typename T>
__global__ void __cluster_dims__(switch_tile::kCluster, 1, 1)
    __launch_bounds__(switch_tile::kThreads, 2)
        switched_mlp_fused_kernel(
            const T* __restrict__ x, const int* __restrict__ rows,
            const int* __restrict__ tile_cls, const T* __restrict__ w1,
            const T* __restrict__ b1, const T* __restrict__ w2,
            const T* __restrict__ b2, T* __restrict__ out, int t, int d_in,
            bool x_vec, int d_in_p, int d_h_p, int d_out_p, int block_t) {
  switch_tile::switched_tile<T>(x, d_in, d_in, x_vec, rows, t - 1, tile_cls,
                                w1, b1, w2, b2, out, d_in_p, d_h_p, d_out_p,
                                block_t);
}

template <typename T>
int launch(const void* x, const void* rows, const void* tile_cls,
           const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int t, int d_in, int t_pad, int d_in_p, int d_h_p,
           int d_out_p, int block_t, void* stream) {
  const bool x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     d_in % switch_tile::Shape<T>::kVec == 0;
  return switch_tile::launch<T>(
      switched_mlp_fused_kernel<T>, t_pad, d_h_p, d_out_p, block_t, stream,
      static_cast<const T*>(x), static_cast<const int*>(rows),
      static_cast<const int*>(tile_cls), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), t, d_in, x_vec, d_in_p,
      d_h_p, d_out_p, block_t);
}

}  // namespace

extern "C" int switched_mlp_fused_f32(const void* x, const void* rows,
                                      const void* tile_cls, const void* w1,
                                      const void* b1, const void* w2,
                                      const void* b2, void* out, int t,
                                      int d_in, int t_pad, int d_in_p,
                                      int d_h_p, int d_out_p, int block_t,
                                      void* stream) {
  return launch<float>(x, rows, tile_cls, w1, b1, w2, b2, out, t, d_in, t_pad,
                       d_in_p, d_h_p, d_out_p, block_t, stream);
}

extern "C" int switched_mlp_fused_bf16(const void* x, const void* rows,
                                       const void* tile_cls, const void* w1,
                                       const void* b1, const void* w2,
                                       const void* b2, void* out, int t,
                                       int d_in, int t_pad, int d_in_p,
                                       int d_h_p, int d_out_p, int block_t,
                                       void* stream) {
  return launch<__nv_bfloat16>(x, rows, tile_cls, w1, b1, w2, b2, out, t, d_in,
                               t_pad, d_in_p, d_h_p, d_out_p, block_t, stream);
}

// out[0..4]: registers, static and dynamic shared bytes, local bytes,
// cluster width of the kernel for dtype `bf16` (0: f32, 1: bf16).
extern "C" int switched_mlp_fused_resources(int bf16, int d_h_p, int d_out_p,
                                            int block_t, int* out) {
  return bf16 ? switch_tile::resources<__nv_bfloat16>(
                    switched_mlp_fused_kernel<__nv_bfloat16>, d_h_p, d_out_p,
                    block_t, out)
              : switch_tile::resources<float>(switched_mlp_fused_kernel<float>,
                                              d_h_p, d_out_p, block_t, out);
}
