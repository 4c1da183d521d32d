// Kernel 9: the k3 conv read through the TPU kernel's window tables, in five
// variants that take the conv apart.
//
// Replaces benchmarks/proto_win_decompose.py:make_kernel (Pallas `_kernel`).
// x (n_pad, Cin) bf16, w (27, Cin, Cout) bf16, r0 (n_super,) int32, starts
// (n_tiles, 3) int32, lidx (n_pad, 26) int16; tile T = 256 rows, G tiles per
// supertile, sub-window width W. For row i of tile t = i / T in supertile
// s = t / G, with base(k) = r0[s] + starts[t, k / 9] and ki the column of
// off-centre offset k in lidx, f32 accumulation, bf16 output:
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
// against it: no_select drops the scattered read (contiguous rows, no
// lookup), no_onehot the per-offset lookup, no_gemm the products, dma_only
// everything but the centre.
//
// The TPU kernel copies one union window per supertile into VMEM (double
// buffered) and selects rows with one-hot matmuls; neither carries over. On
// Hopper the select is an indexed read: one 256-thread block per 128 rows x
// 64 output channels resolves each offset's rows through the tables and
// then runs kernel 1's loop (gather_gemm.cuh: rows and the weight slice
// staged in shared memory, bf16 WMMA with f32 accumulation), skipping an
// offset that no row of the block has. Bound on the H100, as for kernel 1:
// the scattered row read, which is what the variants measure. no_gemm keeps
// its row sums in registers (32 per thread) beside the centre product.
// Fixed summation order, no atomics: two runs are bitwise equal.
#include "gather_gemm.cuh"

namespace {

using namespace us3d;
using T = __nv_bfloat16;

constexpr int kWinTile = 256;   // rows per tile of the window tables
constexpr int kFull = 0, kNoOnehot = 1, kNoSelect = 2, kNoGemm = 3,
              kDmaOnly = 4;
constexpr int kPerThread = kTcM * kTcN / kThreads;   // outputs per thread
static_assert(kWinTile % kTcM == 0, "a block lies inside one table tile");

template <int V>
__global__ void __launch_bounds__(kThreads)
win_decompose_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int* __restrict__ r0,
                     const int* __restrict__ starts,
                     const int16_t* __restrict__ lidx, T* __restrict__ out,
                     int n_pad, int group, int w_sub, int cin, int cout) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kTcBytes];
  __shared__ int rows[kTcM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + kTcABytes);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = (warp / 2) * 32;
  const int wc = (warp % 2) * 32;
  const int row0 = blockIdx.x * kTcM;
  const int col0 = blockIdx.y * kTcN;
  const int tile = row0 / kWinTile;
  const int win0 = r0[tile / group];       // the supertile's window start
  const int local0 = row0 - tile * kWinTile;
  const T zero = __float2bfloat16(0.f);

  AccFragment acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  float extra[kPerThread];   // no_gemm: the selected rows, summed in f32
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) extra[j] = 0.f;

  for (int k = 0; k < 27; ++k) {
    const bool centre = k == 13;
    if (V == kDmaOnly && !centre) continue;
    const int base = centre ? 0 : win0 + starts[tile * 3 + k / 9];
    const int ki = k < 13 ? k : k - 1;
    int any = 0;
    for (int r = tid; r < kTcM; r += kThreads) {
      const int i = row0 + r;
      int src = -1;
      if (i < n_pad) {
        if (centre) {
          src = i;
        } else if (V == kNoSelect) {
          src = base + local0 + r;
        } else {
          const int li = lidx[(size_t)i * 26 + (V == kNoOnehot ? 0 : ki)];
          if (li >= 0 && li < w_sub) src = base + li;
        }
      }
      rows[r] = src;
      any |= (src >= 0);
    }
    // block-uniform: skip the offset when no row of the block has it
    if (!__syncthreads_or(any)) continue;
    if (V == kNoGemm && !centre) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int e = tid + j * kThreads;
        const int src = rows[e / kTcN];
        const int co = col0 + e % kTcN;
        if (src >= 0 && co < cout)
          extra[j] += __bfloat162float(x[(size_t)src * cin + co]);
      }
      __syncthreads();   // the next offset rewrites rows
      continue;
    }
    for (int c0 = 0; c0 < cin; c0 += kTcK) {
      for (int e = tid; e < kTcM * kTcK; e += kThreads) {
        const int r = e / kTcK;
        const int kk = e % kTcK;
        const int src = rows[r];
        const int c = c0 + kk;
        As[r * kTcLdA + kk] = (src >= 0 && c < cin)
                                  ? x[(size_t)src * cin + c] : zero;
      }
      stage_weights_tc(Bs, w, k, c0, col0, cin, cout);
      __syncthreads();
      wmma_chunk(As, Bs, acc, wr, wc);
      __syncthreads();
    }
  }

  store_acc_tile(Cs, acc, wr, wc);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = tid + j * kThreads;
    const int r = e / kTcN;
    const int n = e % kTcN;
    const int i = row0 + r;
    const int co = col0 + n;
    if (i >= n_pad || co >= cout) continue;
    out[(size_t)i * cout + co] =
        __float2bfloat16(Cs[r * kTcLdC + n] + extra[j]);
  }
}

template <int V>
void launch_variant(const void* x, const void* w, const void* r0,
                    const void* starts, const void* lidx, void* out,
                    int n_pad, int group, int w_sub, int cin, int cout,
                    cudaStream_t st) {
  dim3 grid((n_pad + kTcM - 1) / kTcM, (cout + kTcN - 1) / kTcN);
  win_decompose_kernel<V><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(r0), static_cast<const int*>(starts),
      static_cast<const int16_t*>(lidx), static_cast<T*>(out), n_pad, group,
      w_sub, cin, cout);
}

}  // namespace

// variant: 0 full, 1 no_onehot, 2 no_select, 3 no_gemm (needs Cin >= Cout),
// 4 dma_only; anything else returns cudaErrorInvalidValue (1).
extern "C" int win_decompose(const void* x, const void* w, const void* r0,
                             const void* starts, const void* lidx, void* out,
                             int n_pad, int group, int w_sub, int cin,
                             int cout, int variant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kFull:
      launch_variant<kFull>(x, w, r0, starts, lidx, out, n_pad, group, w_sub,
                            cin, cout, st);
      break;
    case kNoOnehot:
      launch_variant<kNoOnehot>(x, w, r0, starts, lidx, out, n_pad, group,
                                w_sub, cin, cout, st);
      break;
    case kNoSelect:
      launch_variant<kNoSelect>(x, w, r0, starts, lidx, out, n_pad, group,
                                w_sub, cin, cout, st);
      break;
    case kNoGemm:
      launch_variant<kNoGemm>(x, w, r0, starts, lidx, out, n_pad, group,
                              w_sub, cin, cout, st);
      break;
    case kDmaOnly:
      launch_variant<kDmaOnly>(x, w, r0, starts, lidx, out, n_pad, group,
                               w_sub, cin, cout, st);
      break;
    default:
      return 1;
  }
  return static_cast<int>(cudaGetLastError());
}
