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
// tile of Cout); the products are kernel 1's (gather_gemm.cuh: f32 FMA with
// a 4x4 register tile, bf16 WMMA with f32 accumulation), the last row tile
// is ragged (784 = 6 * 128 + 16 = 12 * 64 + 16) and masked. Fixed summation
// order, no atomics: two runs are bitwise equal.
#include "gather_gemm.cuh"

namespace {

using namespace us3d;

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

template <typename T, int TN>
__global__ void __launch_bounds__(kThreads)
brick_conv_kernel(const T* __restrict__ g, const T* __restrict__ w,
                  const int* __restrict__ asm_idx,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift,
                  const T* __restrict__ residual, T* __restrict__ out,
                  int row_tiles, int sentinel, int cin, int cout, int relu) {
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
    const float vm = asm_idx[cell] != sentinel ? 1.f : 0.f;
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

template <typename T>   // T = __nv_bfloat16 (a template: one copy per .so)
__global__ void __launch_bounds__(kThreads)
brick_conv_tc_kernel(const T* __restrict__ g, const T* __restrict__ w,
                     const int* __restrict__ asm_idx,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     const T* __restrict__ residual, T* __restrict__ out,
                     int row_tiles, int sentinel, int cin, int cout,
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
    epilogue_store(Cs[r * kTcLdC + e % kTcN],
                   asm_idx[cell] != sentinel ? 1.f : 0.f, cell * cout + co,
                   co, scale, shift, residual, out, relu);
  }
  zero_halo_rows(out, base, row_tile, row_tiles, col0, kTcN, cout);
}

template <typename T, int TN>
void launch_fma(const void* g, const void* w, const int* asm_idx,
                const float* scale, const float* shift, const void* residual,
                void* out, int nb, int sentinel, int cin, int cout, int relu,
                cudaStream_t st) {
  constexpr int TM = 4096 / TN;
  const int row_tiles = (kWinN + TM - 1) / TM;
  dim3 grid(nb * row_tiles, (cout + TN - 1) / TN);
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
    const int row_tiles = (kWinN + kTcM - 1) / kTcM;
    dim3 grid(nb * row_tiles, (cout + kTcN - 1) / kTcN);
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
