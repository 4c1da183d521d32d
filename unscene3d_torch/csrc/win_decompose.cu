// Kernel 9: the k3 conv read through the TPU kernel's window tables, in five
// variants that take kernel 1's ring body apart.
//
// Replaces benchmarks/proto_win_decompose.py:make_kernel (Pallas `_kernel`,
// :30, pallas_call :163). x (n_pad, Cin) bf16, w (27, Cin, Cout) bf16, r0
// (n_super,) int32, starts (n_tiles, 3) int32, lidx (n_pad, 26) int16; tile
// T = 256 rows, G tiles per supertile, sub-window width W. For row i of tile
// t = i / T in supertile s = t / G, with base(k) = r0[s] + starts[t, k / 9]
// and ki the column of off-centre offset k in lidx, f32 accumulation, bf16
// output:
//
//   full       x[i] @ w[13] + sum_k [0 <= lidx[i, ki] < W]
//                                   x[base(k) + lidx[i, ki]] @ w[k]
//   no_onehot  the same with lidx[i, 0] for every k
//   no_select  x[i] @ w[13] + sum_k x[base(k) + (i - t T)] @ w[k]
//   no_gemm    x[i] @ w[13] + sum_k sel_k[:Cout], sel_k the row `full` reads
//   dma_only   x[i] @ w[13]
//
// Spilled pairs (lidx = -1) contribute nothing: `full` is kernel 1 minus the
// level's spilled pairs. Only `full` is a conv; the others exist to be timed
// against it.
//
// The TPU kernel copies one union window per supertile into VMEM (double
// buffered) and selects rows with one-hot matmuls; neither carries over. On
// Hopper the select is an indexed read, so the body is kernel 1's ring
// (gather_gemm.cuh:ring_main_loop with RingTile<NC>: a 256-thread block owns
// 128 rows x all of Cout up to 128, rows by 16-byte cp.async into a ring of
// 3 stages, one barrier per live (offset, Cin chunk) step, warps skipping a
// step whose 32 rows read nothing) behind a prologue of its own that fills
// the block's (27, 128) row table from the window tables. A block lies
// inside one 256-row table tile, so r0 and starts are block-uniform, and
// its 128 x 26 lidx entries are one contiguous, coalesced run of int16s;
// the centre is the identity. Every row below n_pad is written (the mask is
// all ones, the wrapper's `ones`), and rows are read wherever the tables
// point, padding rows included. On every valid row without a spilled pair
// `full` is bitwise kernel 1 (conv3.cu, no epilogue) on the same x, w and
// level: the same loop in the same offset and chunk order, where a staged
// zero row or a skipped group adds exact zeros. What each variant removes
// from kernel 1's body:
//   no_select  the scattered read: row r of every offset reads base(k) +
//              its own place in the tile, contiguous rows, no lookup;
//   no_onehot  the per-offset lookup: one lidx column serves all 26;
//   no_gemm    the off-centre products: only the centre goes through the
//              ring, and the rows `full` reads are summed (their first Cout
//              channels) into the f32 tile between the accumulator spill
//              and the store out (RowSums, several 16-byte loads in flight
//              a lane);
//   dma_only   everything but the centre product.
// Bound on the H100 unchanged, as for kernel 1: the scattered row read.
// Fixed summation order (no_gemm: s = 0, s += row k for the off-centre k
// in order, then tile + s), no atomics: two runs are bitwise equal.
#include "row_gather.cuh"

namespace {

using namespace us3d;
using T = __nv_bfloat16;

constexpr int kWinTile = 256;   // rows per tile of the window tables
constexpr int kNone = -1;       // a row table entry that reads nothing
constexpr int kFull = 0, kNoOnehot = 1, kNoSelect = 2, kNoGemm = 3,
              kDmaOnly = 4;
static_assert(kWinTile % kRingM == 0, "a block lies inside one table tile");

// no_gemm's hook: Cs[r, n] += s, s = 0, s += x[sidx[k, r], col0 + n] for
// the off-centre offsets k in order (n < NC, col0 + n < Cout), in f32. A
// lane owns 8 channels of a row (16 lanes cover a 128-wide row) and starts
// kBatch row loads before it adds them; a row that reads nothing adds a
// zero pack. Scalar loads where Cin, Cout or x's base is not 16-byte
// aligned.
template <typename Tile>
struct RowSums {
  const T* x;
  const int* sidx;
  int cin, cout, col0;

  __device__ __forceinline__ void operator()(float* Cs) const {
    constexpr int kPacks = Tile::kNC / 8;   // 8 channels (16 bytes) a pack
    constexpr int kBatch = 13;              // loads in flight: 26 = 2 x 13
    const bool vec = cin % 8 == 0 && cout % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
    RowPack<T, 8> zero;
#pragma unroll
    for (int q = 0; q < 8; ++q) zero.e[q] = from_f32<T>(0.f);
#pragma unroll 1
    for (int e = threadIdx.x; e < kRingM * kPacks; e += kThreads) {
      const int r = e / kPacks;
      const int co = col0 + 8 * (e % kPacks);
      if (co >= cout) continue;
      float s[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) s[q] = 0.f;
      if (vec) {
#pragma unroll 1
        for (int b = 0; b < 26; b += kBatch) {
          RowPack<T, 8> v[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int k = b + j + (b + j >= 13 ? 1 : 0);
            const int src = sidx[k * kRingM + r];
            v[j] = src != kNone
                       ? load_pack<T, 8>(x + (size_t)src * cin + co)
                       : zero;
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) add_pack(s, v[j]);
        }
      } else {
        for (int ki = 0; ki < 26; ++ki) {
          const int src = sidx[(ki + (ki >= 13 ? 1 : 0)) * kRingM + r];
          if (src == kNone) continue;
          const T* p = x + (size_t)src * cin + co;
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (co + q < cout) s[q] += to_f32(p[q]);
        }
      }
      float* c = Cs + r * Tile::kLdC + co - col0;
#pragma unroll
      for (int q = 0; q < 8; ++q) c[q] += s[q];
    }
    __syncthreads();
  }
};

// The ring's epilogue arguments (scale, shift, residual, relu) and its
// sentinel `none` come in at run time, as they do to kernel 1's entry: the
// launch passes null, 0 and kNone. With them constant, ptxas spilled 4-8
// bytes at NC 64 and 128; with only the epilogue's at run time it took 164
// registers at NC 128 (one block on an SM).
template <int V, typename Tile>
__global__ void __launch_bounds__(kThreads)
win_decompose_ring_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          const int* __restrict__ r0,
                          const int* __restrict__ starts,
                          const int16_t* __restrict__ lidx,
                          const uint8_t* __restrict__ ones,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift,
                          const T* __restrict__ residual, int relu,
                          T* __restrict__ out, int n_pad, int group,
                          int w_sub, int cin, int cout, int none) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int sidx[27 * kRingM];          // (27, 128) x rows
  __shared__ int group_live[27 * kRingGroups];
  __shared__ int live_k[27];
  __shared__ int live_g[27];
  __shared__ int n_live_s;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRingM;
  const int col0 = blockIdx.y * Tile::kNC;
  const int rows = n_pad - row0 < kRingM ? n_pad - row0 : kRingM;
  const int tile = row0 / kWinTile;
  const int local0 = row0 - tile * kWinTile;
  const int win0 = r0[tile / group];   // the supertile's window start

  if (tid < kRingM) sidx[13 * kRingM + tid] = tid < rows ? row0 + tid : kNone;
  // entry e of the block's lidx run: row e / 26, column ki = e % 26
  constexpr int kRounds = 26 * kRingM / kThreads;
  static_assert(26 * kRingM % kThreads == 0, "whole rounds");
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / 26;
    const int ki = e % 26;
    const int k = ki + (ki >= 13 ? 1 : 0);
    int src = kNone;
    if (V != kDmaOnly && r < rows) {
      const int base = win0 + starts[tile * 3 + k / 9];
      if (V == kNoSelect) {
        src = base + local0 + r;
      } else {
        const int li =
            lidx[(size_t)row0 * 26 + (V == kNoOnehot ? 26 * r : e)];
        if (li >= 0 && li < w_sub) src = base + li;
      }
    }
    sidx[k * kRingM + r] = src;
  }
  __syncthreads();
  if (tid < 27 * kRingGroups) {   // (offset, group) = (tid / 4, tid % 4)
    int any = 0;
    // no_gemm and dma_only multiply the centre alone
    if (tid / kRingGroups == 13 || (V != kNoGemm && V != kDmaOnly))
      for (int j = 0; j < 32; ++j)   // rotated start: no bank conflict
        any |= sidx[32 * tid + (j + tid) % 32] != kNone;
    group_live[tid] = any;
  }
  __syncthreads();
  if (tid == 0) ring_live_lists(group_live, 27, live_k, live_g, &n_live_s);
  __syncthreads();
  if constexpr (V == kNoGemm)
    ring_main_loop<Tile>(smem, x, w, sidx, live_k, live_g, n_live_s, ones,
                         scale, shift, residual, out, n_pad, none, cin, cout,
                         relu, row0, col0, nullptr,
                         RowSums<Tile>{x, sidx, cin, cout, col0});
  else
    ring_main_loop<Tile>(smem, x, w, sidx, live_k, live_g, n_live_s, ones,
                         scale, shift, residual, out, n_pad, none, cin, cout,
                         relu, row0, col0, nullptr);
}

template <int V, typename Tile>
int launch_variant(const void* x, const void* w, const void* r0,
                   const void* starts, const void* lidx, const void* ones,
                   void* out, int n_pad, int group, int w_sub, int cin,
                   int cout, cudaStream_t st) {
  constexpr int kBytes = Tile::kSmemBytes;
  auto* kernel = win_decompose_ring_kernel<V, Tile>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((n_pad + kRingM - 1) / kRingM, (cout + Tile::kNC - 1) / Tile::kNC);
  kernel<<<grid, kThreads, kBytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(r0), static_cast<const int*>(starts),
      static_cast<const int16_t*>(lidx), static_cast<const uint8_t*>(ones),
      nullptr, nullptr, nullptr, 0, static_cast<T*>(out), n_pad, group, w_sub,
      cin, cout, kNone);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 full, 1 no_onehot, 2 no_select, 3 no_gemm (needs Cin >= Cout),
// 4 dma_only; anything else returns cudaErrorInvalidValue (1). ones: (n_pad,)
// uint8 all 1, the ring's row mask (kernel 9 masks no row).
extern "C" int win_decompose(const void* x, const void* w, const void* r0,
                             const void* starts, const void* lidx,
                             const void* ones, void* out, int n_pad,
                             int group, int w_sub, int cin, int cout,
                             int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto v) {
    return ring_by_cout<RingTile>(cout, [&](auto tile) {
      return launch_variant<decltype(v)::value, decltype(tile)>(
          x, w, r0, starts, lidx, ones, out, n_pad, group, w_sub, cin, cout,
          st);
    });
  };
  switch (variant) {
    case kFull: return launch(std::integral_constant<int, kFull>{});
    case kNoOnehot: return launch(std::integral_constant<int, kNoOnehot>{});
    case kNoSelect: return launch(std::integral_constant<int, kNoSelect>{});
    case kNoGemm: return launch(std::integral_constant<int, kNoGemm>{});
    case kDmaOnly: return launch(std::integral_constant<int, kDmaOnly>{});
    default: return 1;
  }
}
