// Kernel 7: k3 conv over dense halo'd 8^3 bricks (shift-GEMM).
//
// Replaces unscene3d_tpu/ops/brick_engine.py:brick_conv3 (Pallas kernel
// `_conv_kernel`). A level's voxels are packed into bricks of 10^3 cells
// (flat cell id x * 100 + y * 10 + z, padded to 1008 rows); every k3 offset
// is then a shift by d_k = 100 dx + 10 dy + dz in the flat cell axis, and
// the window rows [111, 895) cover every interior cell:
//
//   out[b, 111 + r] = occ[b, 111 + r]
//                     ? epi( sum_{k<27} g[b, 111 + d_k + r] @ w[k] ) : 0
//
// for r in [0, 784), f32 accumulation, epi = *scale + offset, + residual,
// ReLU; occ = (asm_idx != n_pad - 1) is the cell's occupancy, and an empty
// cell is an exact zero whatever its neighbours hold. Rows [0, 111)
// and [895, 1008) of every brick are written as zeros (halo cells are
// refreshed by halo_exchange before the next conv reads them).
//
// Bound on the H100: the bytes of the dense output slab, of g at the occupied
// cells in reach and of the residual at the occupied cells, against the
// products of the occupied (cell, neighbour) pairs (a brick of a 2 cm indoor
// scene holds few occupied cells).
// No index table and no gather: every offset's A operand is a shifted row
// range of the brick's (1008, Cin) slab. The tile body is brick_tile.cuh's
// (shared with kernel 8, proto_brick.cu): one block per (brick, 112-row
// window tile, column tile of up to 128), the tile's 334-row union staged
// once per Cin chunk with 16-byte cp.async and read at 27 shifts, the next
// three offsets' weights loading while three multiply, bf16 WMMA or f32 FMA
// with f32 accumulation. A tile with no occupied cell writes its zeros and
// multiplies nothing; a warp skips its 16-row strips that hold no occupied
// cell. Fixed summation order, no atomics: two runs are bitwise equal.
#include "brick_tile.cuh"

namespace {

using namespace us3d;

template <class Tile>
__global__ void __launch_bounds__(Tile::kThreads)
brick_conv_kernel(const typename Tile::T* __restrict__ g,
                  const typename Tile::T* __restrict__ w,
                  const int* __restrict__ asm_idx,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift,
                  const typename Tile::T* __restrict__ residual,
                  typename Tile::T* __restrict__ out, int sentinel, int cin,
                  int cout, int relu) {
  brick_tile<Tile>(g, w, asm_idx, scale, shift, residual, out, sentinel, cin,
                   cout, relu);
}

template <class Tile>
int launch(const void* g, const void* w, const int* asm_idx,
           const float* scale, const float* shift, const void* residual,
           void* out, int nb, int sentinel, int cin, int cout, int relu,
           cudaStream_t st) {
  using T = typename Tile::T;
  static const cudaError_t attr = cudaFuncSetAttribute(
      brick_conv_kernel<Tile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  brick_conv_kernel<Tile><<<brick_grid<Tile>(nb, cout), Tile::kThreads,
                            Tile::kSmemBytes, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), asm_idx, scale,
      shift, static_cast<const T*>(residual), static_cast<T*>(out), sentinel,
      cin, cout, relu);
  return static_cast<int>(cudaGetLastError());
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
  return with_brick_tile(is_bf16, cout, [&](auto tile) {
    return launch<decltype(tile)>(
        g, w, static_cast<const int*>(asm_idx),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        residual, out, nb, sentinel, cin, cout, relu,
        static_cast<cudaStream_t>(stream));
  });
}
