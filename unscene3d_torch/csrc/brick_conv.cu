// Kernel 7: k3 conv over dense halo'd 8^3 bricks (shift-GEMM).
//
// Replaces unscene3d_tpu/ops/brick_engine.py:brick_conv3 (Pallas kernel
// `_conv_kernel`). A level's voxels are packed into bricks of 10^3 cells
// (flat cell id x * 100 + y * 10 + z, padded to 1008 rows); every k3 offset
// is then a shift by d_k = 100 dx + 10 dy + dz in the flat cell axis, and
// the window rows [111, 895) cover every interior cell:
//
//   out[b, 111 + r] = occ[b, 111 + r]
//                     * epi( sum_{k<27} g[b, 111 + d_k + r] @ w[k] )
//
// for r in [0, 784), f32 accumulation, epi = *scale + offset, + residual,
// ReLU; occ = (asm_idx != n_pad - 1) is the cell's occupancy. Rows [0, 111)
// and [895, 1008) of every brick are written as zeros (halo cells are
// refreshed by halo_exchange before the next conv reads them).
//
// Bound on the H100: the dense slabs' bytes (a brick of a 2 cm indoor scene
// holds few occupied cells, but every cell is read and multiplied). No
// index table and no gather: the A tile of offset k is the contiguous row
// range [111 + d_k + r0, ...) of the brick's (1008, Cin) slab, so loads are
// coalesced. One 256-thread block per (brick, tile of the 784 window rows,
// tile of Cout); the tile bodies are brick_tile.cuh's (shared with kernel 8,
// proto_brick.cu), their products kernel 1's (gather_gemm.cuh: f32 FMA with
// a 4x4 register tile, bf16 WMMA with f32 accumulation), the last row tile
// is ragged (784 = 6 * 128 + 16 = 12 * 64 + 16) and masked. Fixed summation
// order, no atomics: two runs are bitwise equal.
#include "brick_tile.cuh"

namespace {

using namespace us3d;

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads)
brick_conv_kernel(const T* __restrict__ g, const T* __restrict__ w,
                  const int* __restrict__ asm_idx,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift,
                  const T* __restrict__ residual, T* __restrict__ out,
                  int row_tiles, int sentinel, int cin, int cout, int relu) {
  brick_tile_fma<T, TN>(g, w, asm_idx, scale, shift, residual, out, row_tiles,
                        sentinel, cin, cout, relu);
}

template <typename T>   // T = __nv_bfloat16 (a template: one copy per .so)
__global__ void __launch_bounds__(kThreads)
brick_conv_tc_kernel(const T* __restrict__ g, const T* __restrict__ w,
                     const int* __restrict__ asm_idx,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     const T* __restrict__ residual, T* __restrict__ out,
                     int row_tiles, int sentinel, int cin, int cout,
                     int relu) {
  brick_tile_tc<T>(g, w, asm_idx, scale, shift, residual, out, row_tiles,
                   sentinel, cin, cout, relu);
}

template <typename T, int TN>
void launch_fma(const void* g, const void* w, const int* asm_idx,
                const float* scale, const float* shift, const void* residual,
                void* out, int nb, int sentinel, int cin, int cout, int relu,
                cudaStream_t st) {
  int row_tiles;
  dim3 grid = brick_grid_fma<TN>(nb, cout, &row_tiles);
  brick_conv_kernel<T, TN><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), asm_idx, scale,
      shift, static_cast<const T*>(residual), static_cast<T*>(out),
      row_tiles, sentinel, cin, cout, relu);
}

}  // namespace

// g (nb, 1008, Cin), w (27, Cin, Cout), asm_idx (nb, 1008) int32 with
// `sentinel` (the level's last, always-padding row) in empty cells, scale /
// shift (Cout,) f32 or NULL, residual (nb, 1008, Cout) or NULL, out (nb,
// 1008, Cout).
extern "C" int brick_conv3(const void* g, const void* w, const void* asm_idx,
                           const void* scale, const void* shift,
                           const void* residual, void* out, int nb,
                           int sentinel, int cin, int cout, int relu,
                           int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ap = static_cast<const int*>(asm_idx);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  if (is_bf16) {
    using T = __nv_bfloat16;
    int row_tiles;
    dim3 grid = brick_grid_tc(nb, cout, &row_tiles);
    brick_conv_tc_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(g), static_cast<const T*>(w), ap, sp, hp,
        static_cast<const T*>(residual), static_cast<T*>(out), row_tiles,
        sentinel, cin, cout, relu);
  } else if (cout % 64 == 0) {
    launch_fma<float, 64>(g, w, ap, sp, hp, residual, out, nb, sentinel, cin,
                          cout, relu, st);
  } else {
    launch_fma<float, 32>(g, w, ap, sp, hp, residual, out, nb, sentinel, cin,
                          cout, relu, st);
  }
  return static_cast<int>(cudaGetLastError());
}
