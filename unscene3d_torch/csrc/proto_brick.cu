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
// tiles (one block per brick, 112-row window tile and column tile of up to
// 128; the tile's row union staged once per Cin chunk and read at 27
// shifts; bf16 WMMA or f32 FMA with f32 accumulation), called without a
// mask, so every row tile is multiplied, and without an epilogue. Fixed
// summation order, no atomics.
#include "brick_tile.cuh"

namespace {

using namespace us3d;

template <class Tile>
__global__ void __launch_bounds__(Tile::kThreads)
proto_brick_kernel(const typename Tile::T* __restrict__ g,
                   const typename Tile::T* __restrict__ w,
                   typename Tile::T* __restrict__ out, int cin, int cout) {
  brick_tile<Tile>(g, w, nullptr, nullptr, nullptr, nullptr, out, 0, cin,
                   cout, 0);
}

template <class Tile>
int launch(const void* g, const void* w, void* out, int nb, int cin,
           int cout, cudaStream_t st) {
  using T = typename Tile::T;
  static const cudaError_t attr = cudaFuncSetAttribute(
      proto_brick_kernel<Tile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  proto_brick_kernel<Tile><<<brick_grid<Tile>(nb, cout), Tile::kThreads,
                             Tile::kSmemBytes, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(w),
      static_cast<T*>(out), cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (nb, 1008, Cin), w (27, Cin, Cout), out (nb, 1008, Cout).
extern "C" int proto_brick_conv(const void* g, const void* w, void* out,
                                int nb, int cin, int cout, int is_bf16,
                                void* stream) {
  return with_brick_tile(is_bf16, cout, [&](auto tile) {
    return launch<decltype(tile)>(g, w, out, nb, cin, cout,
                                  static_cast<cudaStream_t>(stream));
  });
}
