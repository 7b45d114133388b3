// Fused dispatch: the weight-switch grouped MLP over UNSORTED rows, with
// the class-sort gather and scatter folded into the row load and store.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_dispatch.py
// (switched_mlp_fused, bodies _fused_kernel and fused_row_index's use).
// rows (t_pad,) maps each padded position to its original row of x (T,
// d_in), or to the trash id T for padding.  A position loads row
// min(rows[p], T - 1), lanes d_in..d_in_p read as zero, and the result is
// stored at row rows[p] of the (T + 1, d_out_p) output, whose last row is
// the trash row.  Real rows are each written exactly once; padding rows
// may race on the trash row, which the caller slices off.
//
// The tile compute is switch_tile.cuh, shared with switched_mlp.cu, so
// the two kernels agree bitwise on every real row.  Bound on an H100 at
// the decode path's shape: the weight bytes (about 8.4 MB in bf16); the
// activations cross device memory once, as rows of x and of the output.
#include "switch_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(switch_tile::kThreads)
    switched_mlp_fused_kernel(const T* __restrict__ x, const int* __restrict__ rows,
                              const int* __restrict__ tile_cls,
                              const T* __restrict__ w1, const T* __restrict__ b1,
                              const T* __restrict__ w2, const T* __restrict__ b2,
                              T* __restrict__ out, int t, int d_in, int d_in_p,
                              int d_h_p, int d_out_p, int block_t,
                              int rows_per_cta) {
  switch_tile::switched_tile<T>(x, d_in, d_in, rows, t - 1, tile_cls, w1, b1, w2,
                                b2, out, d_in_p, d_h_p, d_out_p, block_t,
                                rows_per_cta);
}

template <typename T>
int launch(const void* x, const void* rows, const void* tile_cls,
           const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int t, int d_in, int t_pad, int d_in_p, int d_h_p,
           int d_out_p, int block_t, void* stream) {
  const int rpc = switch_tile::rows_per_cta(block_t);
  const dim3 grid(t_pad / rpc, d_out_p / switch_tile::kCols);
  switched_mlp_fused_kernel<T><<<grid, switch_tile::kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(rows),
      static_cast<const int*>(tile_cls), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), t, d_in, d_in_p, d_h_p,
      d_out_p, block_t, rpc);
  return static_cast<int>(cudaGetLastError());
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
