// Weight-switch grouped MLP over class-sorted rows.
//
// Replaces the Pallas TPU kernel src/repro/kernels/switched_mlp.py
// (switched_mlp, body _switched_kernel).  For each block_t-row tile i of
// x (t_pad, d_in_p) with c = tile_cls[i]:
//   y = (tanh(x . W1[c] + b1[c]) -> cast to x's type) . W2[c] + b2[c]
// with f32 sums, stored in x's type.  The tile compute lives in
// switch_tile.cuh and is shared with the fused kernel.
//
// Bound on an H100 at the decode path's shape (t_pad = 640, d_in_p =
// d_out_p = 2048, d_h_p = 256, bf16): the bytes, about 8.4 MB of weights
// for the (at most) four classes a tick touches plus the activations,
// against about 1.3 GFLOP.  This first version runs on CUDA cores and
// recomputes each tile's hidden chunk per block of output columns, so it
// is far from that bound; see PERF.md.
#include "switch_tile.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(switch_tile::kThreads)
    switched_mlp_kernel(const T* __restrict__ x, const int* __restrict__ tile_cls,
                        const T* __restrict__ w1, const T* __restrict__ b1,
                        const T* __restrict__ w2, const T* __restrict__ b2,
                        T* __restrict__ out, int d_in_p, int d_h_p, int d_out_p,
                        int block_t, int rows_per_cta) {
  switch_tile::switched_tile<T>(x, d_in_p, d_in_p, nullptr, 0, tile_cls, w1, b1,
                                w2, b2, out, d_in_p, d_h_p, d_out_p, block_t,
                                rows_per_cta);
}

template <typename T>
int launch(const void* x, const void* tile_cls, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int t_pad, int d_in_p,
           int d_h_p, int d_out_p, int block_t, void* stream) {
  const int rpc = switch_tile::rows_per_cta(block_t);
  const dim3 grid(t_pad / rpc, d_out_p / switch_tile::kCols);
  switched_mlp_kernel<T><<<grid, switch_tile::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(tile_cls),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<T*>(out), d_in_p, d_h_p, d_out_p, block_t, rpc);
  return static_cast<int>(cudaGetLastError());
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
