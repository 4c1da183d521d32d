// Kernel 6: k3 submanifold sparse conv over compacted valid pairs.
//
// Replaces unscene3d_tpu/ops/csr_conv.py:csr_conv3_fwd (Pallas kernel
// `_kernel`, :150, pallas_call :295). The same function as kernel 1
// (conv3.cu), from pair tables instead of the (27, N) neighbour map:
//
//   out[i] = valid[i] * epi( x[i] @ w[13]
//                            + sum_{k != 13, (j, i) in pairs_k} x[j] @ w[k] )
//
// The pairs (pair_in = j, pair_out = i) hold only the neighbours that exist,
// sorted by (offset, out row); tile_start[ki * tiles + t] is where the pairs
// of offset ki and out rows [64 t, 64 t + 64) begin, and the next entry is
// where they end (the array is flat). x's padding rows are read only by the
// centre offset of padding rows, whose outputs the mask clears.
//
// Both dtypes (csr_conv_ring_kernel): bound on the H100 by the gather of
// the paired rows, 0.043 ms by bytes at level 0 of the bench scene in bf16
// (about 7.6 pairs per valid row, of 26 offsets), by f32 operations on the
// CUDA cores in f32, so the body is kernel 1's: a 256-thread block owns 128
// out rows x all of Cout up to 128 and runs the shared ring main loop
// (gather_gemm.cuh:ring_main_loop, with kernel 1's tile of the dtype:
// 16-byte cp.async rows into a ring of stages, one barrier per live
// (offset, Cin chunk) step, warps skipping a step whose 32 rows have no
// pair). Only
// the prologue is its own: it reads each off-centre offset's pair range in
// the block (two 64-row tile_start entries), writes each pair's in row at
// its out row of the block's (27, 128) row table (every other entry stays
// "none", staged as a zero row) and marks the pair's 32-row group live at
// the first pair of each group; the centre is the identity for the rows
// below n. It never reads the neighbour map, and an empty range leaves the
// offset dead at no further cost. On Hopper compaction buys only that
// cheaper prologue: kernel 1 already skips missing rows and offsets, and
// multiplying packed pairs would cost a scatter of the products through
// shared memory, with its own barriers. The TPU kernel's one-hot row select,
// per-offset buckets with dummy tails and two-block read windows were for
// static shapes under Mosaic and have no counterpart. On valid rows the
// result is bitwise kernel 1's on the same level, in both dtypes.
//
// The offsets go in order 0..26, the centre in its turn, and each row at
// most once per offset: a fixed summation order, no atomics, two runs
// bitwise equal.
#include "gather_gemm.cuh"

namespace {

using namespace us3d;

constexpr int kTile = 64;   // out rows per tile_start entry

constexpr int kNone = -1;   // a row table entry with no pair

// Kernel 1's ring tile (Tile: RingTile in bf16, FmaRingTile in f32) and
// main loop behind a prologue that reads the pair tables (see the top).
template <typename Tile>
__device__ __forceinline__ void csr_conv_ring_block(
    const typename Tile::T* __restrict__ x,
    const typename Tile::T* __restrict__ w, const int* __restrict__ pair_in,
    const int* __restrict__ pair_out, const int* __restrict__ tile_start,
    const uint8_t* __restrict__ valid, const float* __restrict__ scale,
    const float* __restrict__ shift,
    const typename Tile::T* __restrict__ residual,
    typename Tile::T* __restrict__ out, int n, int tiles, int cin, int cout,
    int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int sidx[27 * kRingM];          // (27, 128) x rows
  __shared__ int group_live[27 * kRingGroups];
  __shared__ int range[2 * 26];   // [lo, hi) of each off-centre offset
  __shared__ int live_k[27];
  __shared__ int live_g[27];
  __shared__ int n_live_s;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRingM;
  const int col0 = blockIdx.y * Tile::kNC;
  const int rows = n - row0 < kRingM ? n - row0 : kRingM;

  for (int e = tid; e < 27 * kRingM; e += kThreads) {
    const int r = e % kRingM;
    sidx[e] = e / kRingM == 13 && r < rows ? row0 + r : kNone;
  }
  if (tid < 27 * kRingGroups)   // (offset, group) = (tid / 4, tid % 4)
    group_live[tid] =
        tid / kRingGroups == 13 && 32 * (tid % kRingGroups) < rows;
  if (tid < 2 * 26) {   // the block's two 64-row tile_start entries
    const int t0 = row0 / kTile;
    const int t1 = t0 + kRingM / kTile < tiles ? t0 + kRingM / kTile : tiles;
    range[tid] = tile_start[(size_t)(tid / 2) * tiles + (tid % 2 ? t1 : t0)];
  }
  __syncthreads();
  // slot j of offset ki: its pair lo + j, if any; in bf16 unrolled, so
  // that every thread's loads are in flight together, in f32 rolled: the
  // FMA tile's main loop then keeps within 128 registers with no spill
  constexpr int kRounds = 26 * kRingM / kThreads;
  static_assert(26 * kRingM % kThreads == 0, "whole rounds");
  constexpr int kUnroll = std::is_same<typename Tile::T, float>::value
                              ? 1 : kRounds;
#pragma unroll (kUnroll)
  for (int i = 0; i < kRounds; ++i) {
    const int e = tid + i * kThreads;
    const int ki = e / kRingM;
    const int lo = range[2 * ki];
    const int p = lo + e % kRingM;
    if (p >= range[2 * ki + 1]) continue;
    const int k = ki + (ki >= 13 ? 1 : 0);
    const int r = pair_out[p] - row0;
    sidx[k * kRingM + r] = pair_in[p];
    // out rows ascend within the range: the group's first pair marks it
    if (p == lo || (pair_out[p - 1] - row0) / 32 != r / 32)
      group_live[k * kRingGroups + r / 32] = 1;
  }
  __syncthreads();
  if (tid == 0) ring_live_lists(group_live, 27, live_k, live_g, &n_live_s);
  __syncthreads();
  ring_main_loop<Tile>(smem, x, w, sidx, live_k, live_g, n_live_s, valid,
                       scale, shift, residual, out, n, kNone, cin, cout, relu,
                       row0, col0, nullptr);
}

// The kernel entry of each dtype, with kernel 1's launch bounds
// (gather_gemm.cuh): ptxas's own choice in bf16, two blocks on an SM in
// f32.
#define US3D_CSR_CONV_ARGS                                                  \
  const typename Tile::T *__restrict__ x,                                   \
      const typename Tile::T *__restrict__ w,                               \
      const int *__restrict__ pair_in, const int *__restrict__ pair_out,    \
      const int *__restrict__ tile_start, const uint8_t *__restrict__ valid, \
      const float *__restrict__ scale, const float *__restrict__ shift,     \
      const typename Tile::T *__restrict__ residual,                        \
      typename Tile::T *__restrict__ out, int n, int tiles, int cin,        \
      int cout, int relu
template <typename Tile>
__global__ void __launch_bounds__(kThreads)
csr_conv_ring_kernel(US3D_CSR_CONV_ARGS) {
  csr_conv_ring_block<Tile>(x, w, pair_in, pair_out, tile_start, valid, scale,
                            shift, residual, out, n, tiles, cin, cout, relu);
}
template <typename Tile>
__global__ void __launch_bounds__(kThreads, 2)
csr_conv_fma_ring_kernel(US3D_CSR_CONV_ARGS) {
  csr_conv_ring_block<Tile>(x, w, pair_in, pair_out, tile_start, valid, scale,
                            shift, residual, out, n, tiles, cin, cout, relu);
}
#undef US3D_CSR_CONV_ARGS

template <typename Tile>
int launch_csr_ring(const void* x, const void* w, const int* pair_in,
                    const int* pair_out, const int* tile_start,
                    const uint8_t* valid, const float* scale,
                    const float* shift, const void* residual, void* out, int n,
                    int tiles, int cin, int cout, int relu,
                    cudaStream_t stream) {
  using T = typename Tile::T;
  constexpr int kBytes = Tile::kSmemBytes;
  auto* kernel = [] {
    if constexpr (std::is_same<T, float>::value)
      return csr_conv_fma_ring_kernel<Tile>;
    else
      return csr_conv_ring_kernel<Tile>;
  }();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((n + kRingM - 1) / kRingM, (cout + Tile::kNC - 1) / Tile::kNC);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), pair_in, pair_out,
      tile_start, valid, scale, shift, static_cast<const T*>(residual),
      static_cast<T*>(out), n, tiles, cin, cout, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, Cin), w (27, Cin, Cout), pair_in / pair_out (P,) int32, tile_start
// (26 * ceil(N / 64) + 1,) int32, valid (N,) bool, scale / shift (Cout,) f32
// or NULL, residual (N, Cout) or NULL, out (N, Cout).
extern "C" int csr_conv3_fwd(const void* x, const void* w,
                             const void* pair_in, const void* pair_out,
                             const void* tile_start, const void* valid,
                             const void* scale, const void* shift,
                             const void* residual, void* out, int n, int cin,
                             int cout, int relu, int is_bf16, void* stream) {
  auto launch = [&](auto tile) {
    return launch_csr_ring<decltype(tile)>(
        x, w, static_cast<const int*>(pair_in),
        static_cast<const int*>(pair_out), static_cast<const int*>(tile_start),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(scale),
        static_cast<const float*>(shift), residual, out, n,
        (n + kTile - 1) / kTile, cin, cout, relu,
        static_cast<cudaStream_t>(stream));
  };
  if (is_bf16) return ring_by_cout<RingTile>(cout, launch);
  return ring_by_cout<FmaRingTile>(fma_ring_width(n, cout), launch);
}
