// Kernels 4 and 5: backward of the k3 submanifold sparse conv.
//
// Replaces unscene3d_tpu/ops/window_conv.py:window_conv3_bwd_fused (Pallas
// `_bwd_fused_kernel`, kernel 4: dx and dW in one pass) and
// window_conv3_dw (Pallas `_dw_kernel`, kernel 5: the dW of the 26
// off-centre offsets). With gm the output gradient masked to valid rows:
//
//   dx[i]  = valid[i] * sum_k gm[nbr[k, i]] @ W[26 - k]^T   (conv3_bwd_dx)
//   dW[k]  = sum_i x[nbr[k, i]]^T (x) gm[i]                 (conv3_dw)
//
// Entries of nbr equal to N-1 (the always-padding row) are missing
// neighbours and are skipped. The k3 offset set is symmetric (offset 26-k is
// -offset k), so every pair sits in nbr both ways: dx is the forward
// gather-GEMM of gm with flip-transposed weights over the same map, and no
// spill table exists to add back. dW covers all 27 offsets, the centre (13,
// the identity gather) included, where the TPU left the centre to XLA.
//
// The TPU fused the halves so that one gm window and one one-hot select fed
// both; on Hopper they tile differently (dx by rows, dW by (offset, Cin,
// Cout)) and run as two kernels.
//
// dx: the shared gather-GEMM body of kernel 1 (gather_gemm.cuh), launched
// under this file's own entry point.
//
// dW: a GEMM whose reduction runs over the pairs (x row nbr[k, i], gm row i)
// of one offset: (Cin x pairs) @ (pairs x Cout). What bounds it on the H100
// is the row staging: only ~30% of the rows of an off-centre offset have the
// neighbour at level 0, and each pair moves a Cin-wide and a Cout-wide row.
// A 256-thread block owns one offset k, one fixed row range (dw_splits in
// ops/conv3.py, a function of the shapes), one Cin tile of up to 128 and
// all of Cout up to 128 (wider takes 128-wide tiles), so each pair's rows are
// read once per block. The block compacts its range in segments of 1024 rows
// inside the kernel, with no host table and no host sync: every thread reads
// four entries of nbr[k], a warp ballot and a block prefix append the
// present (x row, gm row) pairs, in row order, to a ring of pairs in shared
// memory. The products run on full 32-pair chunks of that list (the last
// one zero-padded); a chunk's rows arrive as they are, x rows as Xs[pair][c]
// and gm rows as Gs[pair][d], by 16-byte cp.async (scalar loads where a
// width or base is not 16-byte aligned: the stem's Cin 3), double-buffered
// with one barrier per chunk. bf16: dW_tile += Xs^T @ Gs on the tensor cores
// (WMMA, Xs read as a column-major matrix_a, f32 accumulation); f32: FMA on
// the CUDA cores, a (TC/16) x (TD/16) register tile per thread, no TF32.
// Each block writes its partial tile into a per-range slice of an f32
// scratch; a second pass sums the slices in range order. The sums' order
// follows the shapes and the neighbour map alone, no atomics: two runs are
// bitwise equal.
#include "gather_gemm.cuh"

namespace {

using namespace us3d;

constexpr int kPairs = 32;                    // pairs per chunk
constexpr int kRounds = 4;                    // nbr entries per thread
constexpr int kSegRows = kRounds * kThreads;  // rows compacted at a time
constexpr int kWarps = kThreads / 32;
// pair ring slots: a segment's pairs plus the unfinished chunk before them
constexpr int kRing = 2048;
static_assert(kRing >= kSegRows + kPairs && (kRing & (kRing - 1)) == 0,
              "pair ring");

// Append the present pairs of nbr_k over rows [r0, r1) (at most kSegRows)
// to the ring at `tail`, in row order; returns the new tail. Block-uniform;
// ends on a barrier, after which the new pairs are visible.
__device__ __forceinline__ int compact_segment(const int* __restrict__ nbr_k,
                                               int r0, int r1, int sentinel,
                                               int tail, int* psrc,
                                               int* prow, int* wcount) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  int src[kRounds];
  int below[kRounds];   // present lanes before this one in its warp
#pragma unroll
  for (int q = 0; q < kRounds; ++q) {
    const int i = r0 + q * kThreads + tid;
    src[q] = i < r1 ? nbr_k[i] : sentinel;
    const unsigned votes = __ballot_sync(0xffffffffu, src[q] != sentinel);
    if (lane == 0) wcount[q * kWarps + warp] = __popc(votes);
    below[q] = __popc(votes & ((1u << lane) - 1u));
  }
  __syncthreads();
  int base = tail;
#pragma unroll
  for (int q = 0; q < kRounds; ++q)
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp && src[q] != sentinel) {
        const int slot = (base + below[q]) & (kRing - 1);
        psrc[slot] = src[q];
        prow[slot] = r0 + q * kThreads + tid;
      }
      base += wcount[q * kWarps + w];
    }
  __syncthreads();
  return base;
}

// Stage the W-wide slice [col0, col0 + W) of the rows rows[p] (pairs p0 + p
// below `tail`; zero rows past it) into S (leading dimension LD), zero past
// `width`. `vec`: 16-byte asynchronous copies.
template <typename T, int W, int LD>
__device__ __forceinline__ void stage_pair_rows(T* S,
                                                const T* __restrict__ src,
                                                const int* rows, int p0,
                                                int tail, int col0, int width,
                                                bool vec) {
  constexpr int kV = 16 / sizeof(T);
  if (vec) {
    for (int e = threadIdx.x; e < kPairs * (W / kV); e += kThreads) {
      const int p = e / (W / kV);
      const int c = kV * (e % (W / kV));
      const bool in = p0 + p < tail;
      const int r = in ? rows[(p0 + p) & (kRing - 1)] : 0;
      copy16(S + p * LD + c, src + (size_t)r * width + col0 + c,
             in && col0 + c < width);
    }
  } else {
    for (int e = threadIdx.x; e < kPairs * W; e += kThreads) {
      const int p = e / W;
      const int c = e % W;
      const bool in = p0 + p < tail && col0 + c < width;
      S[p * LD + c] =
          in ? src[(size_t)rows[(p0 + p) & (kRing - 1)] * width + col0 + c]
             : from_f32<T>(0.f);
    }
  }
}

// bf16 on the tensor cores: a TCI x TCO tile of WMMA accumulators, warps WI
// over Cin x WO over Cout, each FI x FO fragments (warps past WI x WO, at
// 32-wide Cin tiles, only stage).
template <int TCI, int TCO>
struct DwTc {
  using T = __nv_bfloat16;
  static constexpr int kTCI = TCI, kTCO = TCO;
  static constexpr int kWI = TCI / 16 >= 4 ? 4 : TCI / 16;
  static constexpr int kWO =
      (TCO / 16) % (kWarps / kWI) == 0 ? kWarps / kWI : 2;
  static constexpr int kFI = TCI / 16 / kWI;
  static constexpr int kFO = TCO / 16 / kWO;
  static constexpr int kLdX = TCI + 8;   // 32-byte aligned fragment rows
  static constexpr int kLdG = TCO + 8;
  static constexpr int kLdC = TCO + 4;
  static constexpr int kXBytes = kPairs * kLdX * 2;
  static constexpr int kBufBytes = kXBytes + kPairs * kLdG * 2;
  static constexpr int kCBytes = TCI * kLdC * 4;
  static constexpr int kSmemBytes =
      2 * kBufBytes > kCBytes ? 2 * kBufBytes : kCBytes;
  static_assert(kFI * kWI * 16 == TCI && kFO * kWO * 16 == TCO,
                "whole fragments per warp");
  static_assert(kXBytes % 32 == 0 && kBufBytes % 128 == 0, "aligned");

  struct Acc {
    AccFragment f[kFI][kFO];
  };

  static __device__ __forceinline__ bool active() {
    return threadIdx.x / 32 < kWI * kWO;
  }
  static __device__ __forceinline__ int ci0() {
    return (threadIdx.x / 32 / kWO) * kFI * 16;
  }
  static __device__ __forceinline__ int co0() {
    return (threadIdx.x / 32 % kWO) * kFO * 16;
  }

  static __device__ __forceinline__ void init(Acc& acc) {
#pragma unroll
    for (int i = 0; i < kFI; ++i)
#pragma unroll
      for (int j = 0; j < kFO; ++j)
        nvcuda::wmma::fill_fragment(acc.f[i][j], 0.f);
  }

  static __device__ __forceinline__ void step(Acc& acc, const T* Xs,
                                              const T* Gs) {
    using namespace nvcuda;
    if (!active()) return;
    // the 8-fragment tile (128 x 128) rolls this loop, so that it keeps
    // its values in 128 registers (two blocks on an SM) without a spill
#pragma unroll (kFI * kFO >= 8 ? 1 : kPairs / 16)
    for (int ks = 0; ks < kPairs; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a[kFI];
#pragma unroll
      for (int i = 0; i < kFI; ++i)
        wmma::load_matrix_sync(a[i], Xs + ks * kLdX + ci0() + 16 * i, kLdX);
#pragma unroll
      for (int j = 0; j < kFO; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(b, Gs + ks * kLdG + co0() + 16 * j, kLdG);
#pragma unroll
        for (int i = 0; i < kFI; ++i)
          wmma::mma_sync(acc.f[i][j], a[i], b, acc.f[i][j]);
      }
    }
  }

  // After the main loop's last barrier: fragments -> the f32 tile over the
  // chunk buffers -> out (rows c0.., columns d0.., clipped).
  static __device__ __forceinline__ void store(Acc& acc, unsigned char* smem,
                                               float* __restrict__ out,
                                               int c0, int d0, int cin,
                                               int cout) {
    float* Cs = reinterpret_cast<float*>(smem);
    if (active())
#pragma unroll
      for (int i = 0; i < kFI; ++i)
#pragma unroll
        for (int j = 0; j < kFO; ++j)
          nvcuda::wmma::store_matrix_sync(
              Cs + (ci0() + 16 * i) * kLdC + co0() + 16 * j, acc.f[i][j],
              kLdC, nvcuda::wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < TCI * TCO; e += kThreads) {
      const int c = e / TCO;
      const int d = e % TCO;
      if (c0 + c < cin && d0 + d < cout)
        out[(size_t)(c0 + c) * cout + d0 + d] = Cs[c * kLdC + d];
    }
  }
};

// f32 on the CUDA cores: a TC x TD tile, 16 x 16 threads, thread (tx, ty)
// owning Cin rows ty + 16 i and Cout columns tx + 16 j.
template <int TC, int TD>
struct DwFma {
  using T = float;
  static constexpr int kTCI = TC, kTCO = TD;
  static constexpr int kRC = TC / 16, kRD = TD / 16;
  static constexpr int kLdX = TC + 4;   // 16-byte rows
  static constexpr int kLdG = TD + 4;
  static constexpr int kXBytes = kPairs * kLdX * 4;
  static constexpr int kBufBytes = kXBytes + kPairs * kLdG * 4;
  static constexpr int kSmemBytes = 2 * kBufBytes;
  static_assert(kXBytes % 16 == 0 && kBufBytes % 128 == 0, "aligned");

  struct Acc {
    float v[kRC][kRD];
  };

  static __device__ __forceinline__ void init(Acc& acc) {
#pragma unroll
    for (int i = 0; i < kRC; ++i)
#pragma unroll
      for (int j = 0; j < kRD; ++j) acc.v[i][j] = 0.f;
  }

  static __device__ __forceinline__ void step(Acc& acc, const T* Xs,
                                              const T* Gs) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll 4
    for (int p = 0; p < kPairs; ++p) {
      float a[kRC], b[kRD];
#pragma unroll
      for (int i = 0; i < kRC; ++i) a[i] = Xs[p * kLdX + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kRD; ++j) b[j] = Gs[p * kLdG + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRC; ++i)
#pragma unroll
        for (int j = 0; j < kRD; ++j)
          acc.v[i][j] = fmaf(a[i], b[j], acc.v[i][j]);
    }
  }

  static __device__ __forceinline__ void store(Acc& acc, unsigned char*,
                                               float* __restrict__ out,
                                               int c0, int d0, int cin,
                                               int cout) {
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < kRC; ++i) {
      const int c = c0 + ty + 16 * i;
      if (c >= cin) continue;
#pragma unroll
      for (int j = 0; j < kRD; ++j) {
        const int d = d0 + tx + 16 * j;
        if (d < cout) out[(size_t)c * cout + d] = acc.v[i][j];
      }
    }
  }
};

// One block per (Cout tile, Cin tile, offset x row range): blockIdx.z = k *
// splits + s. Tile::kSmemBytes of dynamic shared memory.
template <class Tile>
__global__ void __launch_bounds__(kThreads)
dw_pairs_kernel(const typename Tile::T* __restrict__ x,
                const typename Tile::T* __restrict__ gm,
                const int* __restrict__ nbr, float* __restrict__ part, int n,
                int cin, int cout, int rows_per_split, int splits) {
  using T = typename Tile::T;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int psrc[kRing];   // x row of each pair
  __shared__ int prow[kRing];   // its gm row
  __shared__ int wcount[kRounds * kWarps];

  const int d0 = blockIdx.x * Tile::kTCO;
  const int c0 = blockIdx.y * Tile::kTCI;
  const int k = blockIdx.z / splits;
  const int s = blockIdx.z % splits;
  const int r_begin = s * rows_per_split;
  const int r_end = n < r_begin + rows_per_split ? n : r_begin + rows_per_split;
  const int* nbr_k = nbr + (size_t)k * n;
  constexpr int kV = 16 / sizeof(T);
  const bool vec_x = cin % kV == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_g =
      cout % kV == 0 && reinterpret_cast<uintptr_t>(gm) % 16 == 0;
  auto xs = [&](int j) {
    return reinterpret_cast<T*>(smem + (j & 1) * Tile::kBufBytes);
  };
  auto gs = [&](int j) {
    return reinterpret_cast<T*>(smem + (j & 1) * Tile::kBufBytes +
                                Tile::kXBytes);
  };

  typename Tile::Acc acc;
  Tile::init(acc);
  int tail = 0;        // pairs appended so far (block-uniform)
  int next = r_begin;  // first row not yet compacted
  // step j stages chunk j + 1 and multiplies chunk j (one cp.async group a
  // step, committed also when empty)
  for (int j = -1;; ++j) {
    while (tail < kPairs * (j + 2) && next < r_end) {   // chunk j + 1's pairs
      const int r1 = next + kSegRows < r_end ? next + kSegRows : r_end;
      tail = compact_segment(nbr_k, next, r1, n - 1, tail, psrc, prow,
                             wcount);
      next = r1;
    }
    if (j >= 0) {
      __pipeline_wait_prior(0);
      __syncthreads();   // chunk j landed; chunk j - 1's buffers are free
    }
    const int p1 = kPairs * (j + 1);
    if (p1 < tail) {
      stage_pair_rows<T, Tile::kTCI, Tile::kLdX>(xs(j + 1), x, psrc, p1,
                                                 tail, c0, cin, vec_x);
      stage_pair_rows<T, Tile::kTCO, Tile::kLdG>(gs(j + 1), gm, prow, p1,
                                                 tail, d0, cout, vec_g);
    }
    __pipeline_commit();
    if (j >= 0) Tile::step(acc, xs(j), gs(j));
    if (p1 >= tail) break;   // chunk j + 1 is empty: j was the last
  }
  __pipeline_wait_prior(0);
  __syncthreads();   // every product read; the buffers are free
  Tile::store(acc, smem, part + ((size_t)s * 27 + k) * cin * cout, c0, d0,
              cin, cout);
}

// Second pass: dw[e] = sum over row ranges of part[s, e], in range order.
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ dw, size_t m,
                                 int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * m + e];
  dw[e] = acc;
}

template <class Tile>
int launch_dw(const void* x, const void* gm, const void* nbr, float* part,
              int n, int cin, int cout, int rows_per_split, int splits,
              cudaStream_t st) {
  using T = typename Tile::T;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dw_pairs_kernel<Tile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((cout + Tile::kTCO - 1) / Tile::kTCO,
            (cin + Tile::kTCI - 1) / Tile::kTCI, 27 * splits);
  dw_pairs_kernel<Tile><<<grid, kThreads, Tile::kSmemBytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gm),
      static_cast<const int*>(nbr), part, n, cin, cout, rows_per_split,
      splits);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 tile of Cin tile TCI for the Cout: 32, 64, 96 or 128 wide.
template <int TCI>
int launch_dw_tc(const void* x, const void* gm, const void* nbr, float* part,
                 int n, int cin, int cout, int rows_per_split, int splits,
                 cudaStream_t st) {
  if (cout <= 32)
    return launch_dw<DwTc<TCI, 32>>(x, gm, nbr, part, n, cin, cout,
                                    rows_per_split, splits, st);
  if (cout <= 64)
    return launch_dw<DwTc<TCI, 64>>(x, gm, nbr, part, n, cin, cout,
                                    rows_per_split, splits, st);
  if (cout <= 96)
    return launch_dw<DwTc<TCI, 96>>(x, gm, nbr, part, n, cin, cout,
                                    rows_per_split, splits, st);
  return launch_dw<DwTc<TCI, 128>>(x, gm, nbr, part, n, cin, cout,
                                   rows_per_split, splits, st);
}

}  // namespace

extern "C" int conv3_bwd_dx(const void* gm, const void* wflip,
                            const void* nbr, const void* order,
                            const void* keys, const void* valid, void* dx,
                            int n, int cin, int cout, int is_bf16,
                            void* stream) {
  // gm (N, Cout) gathered through wflip (27, Cout, Cin) into dx (N, Cin),
  // over the rows in kernel 1's order (conv3.cu)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return us3d::launch_gather_gemm<__nv_bfloat16>(
        gm, wflip, nbr, order, keys, valid, nullptr, nullptr, nullptr, dx,
        27, n, n - 1, cout, cin, 0, st);
  return us3d::launch_gather_gemm<float>(gm, wflip, nbr, order, keys, valid,
                                         nullptr, nullptr, nullptr, dx, 27,
                                         n, n - 1, cout, cin, 0, st);
}

// part: (splits, 27, Cin, Cout) f32 scratch, unused (may be NULL) when
// splits == 1; dw: (27, Cin, Cout) f32.
extern "C" int conv3_dw(const void* x, const void* gm, const void* nbr,
                        void* part, void* dw, int n, int cin, int cout,
                        int splits, int rows_per_split, int is_bf16,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(splits > 1 ? part : dw);
  int code;
  if (is_bf16) {
    if (cin <= 32)
      code = launch_dw_tc<32>(x, gm, nbr, out, n, cin, cout, rows_per_split,
                              splits, st);
    else if (cin <= 64)
      code = launch_dw_tc<64>(x, gm, nbr, out, n, cin, cout, rows_per_split,
                              splits, st);
    else
      code = launch_dw_tc<128>(x, gm, nbr, out, n, cin, cout, rows_per_split,
                               splits, st);
  } else if (cin <= 32 && cout <= 32) {
    code = launch_dw<DwFma<32, 32>>(x, gm, nbr, out, n, cin, cout,
                                    rows_per_split, splits, st);
  } else if (cin <= 32) {
    code = launch_dw<DwFma<32, 64>>(x, gm, nbr, out, n, cin, cout,
                                    rows_per_split, splits, st);
  } else if (cout <= 32) {
    code = launch_dw<DwFma<64, 32>>(x, gm, nbr, out, n, cin, cout,
                                    rows_per_split, splits, st);
  } else {
    code = launch_dw<DwFma<64, 64>>(x, gm, nbr, out, n, cin, cout,
                                    rows_per_split, splits, st);
  }
  if (code != 0 || splits == 1) return code;
  const size_t m = (size_t)27 * cin * cout;
  dw_reduce_kernel<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), m, splits);
  return static_cast<int>(cudaGetLastError());
}
