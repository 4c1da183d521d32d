// Slab tiles of the dense brick shift-GEMM conv, shared by kernel 7
// (brick_conv.cu) and kernel 8 (proto_brick.cu).
//
// A brick is a (1008, C) slab of 10^3 halo'd cells (flat cell id x * 100 +
// y * 10 + z, padded to 1008 rows); k3 offset k is a shift by d_k = 100 dx +
// 10 dy + dz of the flat cell axis, and window rows [111, 895) cover every
// interior cell. One block computes, for one brick and one tile of the 784
// window rows,
//
//   out[b, 111 + r] = m[b, 111 + r]
//                     * epi( sum_{k<27} g[b, 111 + d_k + r] @ w[k] )
//
// over one tile of Cout, with m the occupancy mask (asm_idx != sentinel) or
// 1 when asm_idx is NULL, and writes rows [0, 111) and [895, 1008) of its
// Cout tile as zeros when it is the brick's first or last row tile. No
// index table and no gather: the A tile of offset k is a contiguous row
// range of the slab, so loads are coalesced. The products are kernel 1's
// (gather_gemm.cuh: f32 FMA with a 4x4 register tile, bf16 WMMA with f32
// accumulation); the last row tile is ragged (784 = 6 * 128 + 16 = 12 * 64
// + 16) and masks its loads and stores. Fixed summation order, no atomics.
#pragma once

#include "gather_gemm.cuh"

namespace us3d {

constexpr int kCells = 1008;   // rows per brick
constexpr int kWinLo = 111;    // first window row
constexpr int kWinN = 784;     // window rows

__device__ __forceinline__ int k3_delta(int k) {
  return (k / 9 - 1) * 100 + ((k / 3) % 3 - 1) * 10 + (k % 3 - 1);
}

// The block of the first row tile zeroes rows [0, 111) of its Cout tile, the
// block of the last one rows [895, 1008).
template <typename T>
__device__ __forceinline__ void zero_halo_rows(T* __restrict__ out,
                                               size_t base, int row_tile,
                                               int row_tiles, int col0,
                                               int tn, int cout) {
  const T zero = from_f32<T>(0.f);
  for (int side = 0; side < 2; ++side) {
    if (row_tile != (side == 0 ? 0 : row_tiles - 1)) continue;
    const int lo = side == 0 ? 0 : kWinLo + kWinN;
    const int rows = side == 0 ? kWinLo : kCells - kWinLo - kWinN;
    for (int e = threadIdx.x; e < rows * tn; e += kThreads) {
      const int co = col0 + e % tn;
      if (co < cout) out[(base + lo + e / tn) * cout + co] = zero;
    }
  }
}

// f32 path: one block per (brick, 4096 / TN window rows, TN channels).
template <typename T, int TN>
__device__ __forceinline__ void brick_tile_fma(
    const T* __restrict__ g, const T* __restrict__ w,
    const int* __restrict__ asm_idx, const float* __restrict__ scale,
    const float* __restrict__ shift, const T* __restrict__ residual,
    T* __restrict__ out, int row_tiles, int sentinel, int cin, int cout,
    int relu) {
  constexpr int TM = 4096 / TN;
  constexpr int TX = TN / 4;
  constexpr int TY = kThreads / TX;
  __shared__ float As[kTK][TM + 1];
  __shared__ float Bs[kTK][TN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row_tile = blockIdx.x % row_tiles;
  const size_t base = (size_t)(blockIdx.x / row_tiles) * kCells;
  const int r0 = row_tile * TM;
  const int col0 = blockIdx.y * TN;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k = 0; k < 27; ++k) {
    const size_t src0 = base + kWinLo + k3_delta(k) + r0;
    for (int c0 = 0; c0 < cin; c0 += kTK) {
      for (int e = tid; e < TM * kTK; e += kThreads) {
        const int r = e / kTK;
        const int kk = e % kTK;
        const int c = c0 + kk;
        As[kk][r] = (r0 + r < kWinN && c < cin)
                        ? to_f32(g[(src0 + r) * cin + c]) : 0.f;
      }
      stage_weights_f32<TN>(Bs, w, k, c0, col0, cin, cout);
      __syncthreads();
      fma_chunk<TM, TN>(As, Bs, acc, tx, ty);
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int wr = r0 + ty + TY * r;
    if (wr >= kWinN) continue;
    const size_t cell = base + kWinLo + wr;
    const float vm =
        (asm_idx == nullptr || asm_idx[cell] != sentinel) ? 1.f : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int co = col0 + tx + TX * c;
      if (co >= cout) continue;
      epilogue_store(acc[r][c], vm, cell * cout + co, co, scale, shift,
                     residual, out, relu);
    }
  }
  zero_halo_rows(out, base, row_tile, row_tiles, col0, TN, cout);
}

// bf16 path: one block per (brick, 128 window rows, 64 channels).
template <typename T>   // T = __nv_bfloat16
__device__ __forceinline__ void brick_tile_tc(
    const T* __restrict__ g, const T* __restrict__ w,
    const int* __restrict__ asm_idx, const float* __restrict__ scale,
    const float* __restrict__ shift, const T* __restrict__ residual,
    T* __restrict__ out, int row_tiles, int sentinel, int cin, int cout,
    int relu) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 only");
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kTcBytes];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + kTcABytes);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = (warp / 2) * 32;
  const int wc = (warp % 2) * 32;
  const int row_tile = blockIdx.x % row_tiles;
  const size_t base = (size_t)(blockIdx.x / row_tiles) * kCells;
  const int r0 = row_tile * kTcM;
  const int col0 = blockIdx.y * kTcN;
  const T zero = __float2bfloat16(0.f);

  AccFragment acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k = 0; k < 27; ++k) {
    const size_t src0 = base + kWinLo + k3_delta(k) + r0;
    for (int c0 = 0; c0 < cin; c0 += kTcK) {
      for (int e = tid; e < kTcM * kTcK; e += kThreads) {
        const int r = e / kTcK;
        const int kk = e % kTcK;
        const int c = c0 + kk;
        As[r * kTcLdA + kk] = (r0 + r < kWinN && c < cin)
                                  ? g[(src0 + r) * cin + c] : zero;
      }
      stage_weights_tc(Bs, w, k, c0, col0, cin, cout);
      __syncthreads();
      wmma_chunk(As, Bs, acc, wr, wc);
      __syncthreads();
    }
  }

  store_acc_tile(Cs, acc, wr, wc);
  for (int e = tid; e < kTcM * kTcN; e += kThreads) {
    const int r = e / kTcN;
    const int co = col0 + e % kTcN;
    if (r0 + r >= kWinN || co >= cout) continue;
    const size_t cell = base + kWinLo + r0 + r;
    epilogue_store(
        Cs[r * kTcLdC + e % kTcN],
        (asm_idx == nullptr || asm_idx[cell] != sentinel) ? 1.f : 0.f,
        cell * cout + co, co, scale, shift, residual, out, relu);
  }
  zero_halo_rows(out, base, row_tile, row_tiles, col0, kTcN, cout);
}

// Grid of the f32 path / the bf16 path over nb bricks.
template <int TN>
inline dim3 brick_grid_fma(int nb, int cout, int* row_tiles) {
  constexpr int TM = 4096 / TN;
  *row_tiles = (kWinN + TM - 1) / TM;
  return dim3(nb * *row_tiles, (cout + TN - 1) / TN);
}
inline dim3 brick_grid_tc(int nb, int cout, int* row_tiles) {
  *row_tiles = (kWinN + kTcM - 1) / kTcM;
  return dim3(nb * *row_tiles, (cout + kTcN - 1) / kTcN);
}

}  // namespace us3d
