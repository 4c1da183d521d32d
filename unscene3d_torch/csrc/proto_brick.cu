// Kernel 8: the prototype of the dense brick shift-GEMM conv.
//
// Replaces benchmarks/proto_brick_pallas.py:conv_kernel (Pallas). For each
// brick b of G (nb, 1008, C):
//
//   out[b, 111 : 895] = sum_{k<27} G[b, 111 + d_k : 895 + d_k] @ w[k],
//   d_k = 100 dx + 10 dy + dz,
//
// f32 accumulation, output in G's type, rows [0, 111) and [895, 1008)
// written as zeros. No epilogue and NO occupancy mask, which sets it apart
// from kernel 7 (brick_conv.cu): empty interior cells hold the nonzero sums
// of their occupied neighbours. nb is any count (the TPU's padding to a
// multiple of 8 bricks was for its compiler).
//
// Bound on the H100: the dense slabs' bytes against the products of every
// cell, occupied or not. Its own entry points over brick_tile.cuh's slab
// tiles (one 256-thread block per brick, row tile and Cout tile; bf16 WMMA
// or f32 FMA with f32 accumulation; the ragged last row tile masked), called
// without a mask and without an epilogue. Fixed summation order, no atomics.
#include "brick_tile.cuh"

namespace {

using namespace us3d;

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads)
proto_brick_kernel(const T* __restrict__ g, const T* __restrict__ w,
                   T* __restrict__ out, int row_tiles, int cin, int cout) {
  brick_tile_fma<T, TN>(g, w, nullptr, nullptr, nullptr, nullptr, out,
                        row_tiles, 0, cin, cout, 0);
}

template <typename T>   // T = __nv_bfloat16
__global__ void __launch_bounds__(kThreads)
proto_brick_tc_kernel(const T* __restrict__ g, const T* __restrict__ w,
                      T* __restrict__ out, int row_tiles, int cin,
                      int cout) {
  brick_tile_tc<T>(g, w, nullptr, nullptr, nullptr, nullptr, out, row_tiles,
                   0, cin, cout, 0);
}

template <typename T, int TN>
void launch_fma(const void* g, const void* w, void* out, int nb, int cin,
                int cout, cudaStream_t st) {
  int row_tiles;
  dim3 grid = brick_grid_fma<TN>(nb, cout, &row_tiles);
  proto_brick_kernel<T, TN><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(w),
      static_cast<T*>(out), row_tiles, cin, cout);
}

}  // namespace

// g (nb, 1008, Cin), w (27, Cin, Cout), out (nb, 1008, Cout).
extern "C" int proto_brick_conv(const void* g, const void* w, void* out,
                                int nb, int cin, int cout, int is_bf16,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    int row_tiles;
    dim3 grid = brick_grid_tc(nb, cout, &row_tiles);
    proto_brick_tc_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(w),
        static_cast<T*>(out), row_tiles, cin, cout);
  } else if (cout % 64 == 0) {
    launch_fma<float, 64>(g, w, out, nb, cin, cout, st);
  } else {
    launch_fma<float, 32>(g, w, out, nb, cin, cout, st);
  }
  return static_cast<int>(cudaGetLastError());
}
