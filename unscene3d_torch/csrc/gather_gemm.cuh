// Shared gather-GEMM body of kernel 1 (conv3.cu), the dx of kernel 4
// (conv3_bwd.cu) and the weighted case of kernel 2 (k_apply.cu):
//
//   out[i, :] = valid[i] * epi( sum_{k<K} x[idx[k, i], :] @ w[k] )
//
// with f32 accumulation. idx is (K, n_out) int32; an entry equal to
// `sentinel` (the input level's last, always-padding row) is a missing
// neighbour and is skipped, never read. epi is the fused epilogue of
// unscene3d_tpu/ops/window_conv.py:531-539: *scale + shift (bias folded into
// shift by the wrapper), + residual, ReLU, then the validity mask.
//
// Bound on the H100: in bf16 the gather. Each output row reads ~8.7 valid
// neighbour rows x Cin x itemsize at level 0 of the bench scene (of 27
// offsets), from anywhere in the level, while the FLOPs per gathered byte
// are small (2 x Cout / itemsize); what the card spends is the staging of
// those rows into shared memory and the fragment loads, not HBM bytes or
// MMAs. In f32 the FMAs on the CUDA cores (67 TFLOP/s) bound it: the body
// keeps them fed from registers, with few shared loads per FMA.
//
// One body for both dtypes (gather_gemm_ring_block, entered through
// gather_gemm_ring_kernel in bf16 and gather_gemm_fma_ring_kernel in f32,
// which differ in their launch bounds only): one 256-thread block owns 128
// output rows x all of Cout up to 128 (wider Cout takes 128-wide
// column tiles), so each gathered row feeds every output column of its
// block once. The block stages the tile's K x 128 neighbour indices once,
// with the list of live offsets (those some row of the tile has) and, per
// live offset, which of the four 32-row groups have it; the pipeline walks
// only the live (offset, Cin chunk) steps. Kernel 1 and 4's dx walk the
// level's rows in a row order (ops/conv3.py:row_order, the stable sort of
// each row's 27-bit neighbour mask), so that a 32-row group holds rows
// with the same offsets: a group computes a step for all 32 rows when any
// one has the neighbour, and at the train batch's level 0 that was 4.7x
// the pairs' products in the levels' own row order (PERF.md §6). The
// block reads its rows from the order, their masks beside them, and
// writes each output row where the order says. A step's rows arrive by 16-byte
// cp.async (__pipeline_memcpy_async), a missing row as an explicit zero
// store, with the weight slice beside them, into a ring of 3 stages (2 for
// the f32 tile at NC 128) with one barrier per step, so the next steps'
// copies fly while this one multiplies; a warp owns 32 rows x half of the
// columns and skips a step where its rows have no neighbour. Rows or
// weights whose width or base is not 16-byte aligned (the stem's Cin 3)
// take scalar loads in the same kernel. The accumulators go through
// shared memory (over the ring) to the epilogue, so stores stay coalesced
// along channels. The tile policy is the dtype's:
//  - bf16 (RingTile): WMMA 16x16x16 with f32 accumulation, 32-channel
//    chunks; 128 registers at NC 96 and 128, two blocks on an SM (rolled
//    staging and epilogue loops).
//  - f32 (FmaRingTile): fmaf on the CUDA cores, no TF32; each lane holds an
//    8-row register tile and reads A and B as 64- and 128-bit shared
//    loads. 32-channel chunks. Shared memory per block: kStages stages of
//    128 x 36 + 32 x NC floats, or the 128 x (NC + 4) f32 epilogue tile if
//    larger, plus the row table and live lists (kernel 1 14.6 KB with its
//    rows, kernel 6 14.3): NC 128 with 2 stages 68.0 KB, NC 96
//    with 3 stages 90.0, NC 64 78.0, NC 32 66.0; so two blocks fit in an SM's 228 KB, and the f32
//    entries' __launch_bounds__ hold the 128 registers that two blocks
//    leave a thread. On a level of few 128-row tiles the f32 column tile
//    narrows (fma_ring_width), so that the grid fills the SMs.
//
// Every output element is one chain of fmaf (f32) or of MMA accumulations
// (bf16) in a fixed order: offsets in order, then the Cin chunks in order,
// then the channels in order. No atomics; two runs are bitwise equal. A
// skipped missing row, dead offset or padded channel drops a term
// fmaf(0, w, acc) == acc, so the f32 result does not depend on the tiling.
// Kernel 6 (csr_conv.cu) runs the same main loop (ring_main_loop) in both
// dtypes behind a prologue of its own that fills the row table from pair
// tables. Kernel 9 (win_decompose.cu, bf16), which replaces the TPU
// prototype benchmarks/proto_win_decompose.py:_kernel, runs it behind a
// prologue that fills the row table from that kernel's window tables; its
// bound is kernel 1's, unchanged, and its variants take this body apart:
// no_select removes the scattered read (contiguous rows), no_onehot the
// per-offset lookup (one table column), no_gemm the off-centre products
// (their rows are summed instead, through the loop's hook), dma_only all
// but the centre product. Kernels 7 and 8 (brick_tile.cuh) share the
// epilogue, the accumulator fragment and the 16-byte staging helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace us3d {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = 256;  // threads per block

// The fused epilogue on one f32 accumulator, shared by kernels 1, 2, 4, 6,
// 7 and 8: *scale + shift, + residual, ReLU, then the mask vm (0 or 1); `off`
// is the element's offset in residual and out, `co` its output channel.
template <typename T>
__device__ __forceinline__ void epilogue_store(
    float acc, float vm, size_t off, int co, const float* __restrict__ scale,
    const float* __restrict__ shift, const T* __restrict__ residual,
    T* __restrict__ out, int relu) {
  float y = acc;
  if (scale != nullptr) y = y * scale[co] + shift[co];
  if (residual != nullptr) y += to_f32(residual[off]);
  if (relu) y = fmaxf(y, 0.f);
  out[off] = from_f32<T>(y * vm);
}

using AccFragment =
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// Copy 16 bytes global -> shared when `in` holds, else store 16 zero bytes.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool in) {
  if (in)
    __pipeline_memcpy_async(dst, src, 16);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// Stage w[k, c0 : c0 + K, col0 : col0 + NC] into B (leading dimension LD);
// zero past Cin and Cout. `vec`: 16-byte asynchronous copies (Cout a
// multiple of 16 / sizeof(T), base aligned), else scalar loads.
template <typename T, int K, int NC, int LD, int NT>
__device__ __forceinline__ void stage_weights(T* B, const T* __restrict__ w,
                                              int k, int c0, int col0,
                                              int cin, int cout, bool vec) {
  constexpr int kV = 16 / sizeof(T);
  if (vec) {
    for (int e = threadIdx.x; e < K * (NC / kV); e += NT) {
      const int kk = e / (NC / kV);
      const int n = (e % (NC / kV)) * kV;
      const int c = c0 + kk;
      const int co = col0 + n;
      copy16(B + kk * LD + n, w + ((size_t)k * cin + c) * cout + co,
             c < cin && co < cout);
    }
  } else {
    for (int e = threadIdx.x; e < K * NC; e += NT) {
      const int kk = e / NC;
      const int n = e % NC;
      const int c = c0 + kk;
      const int co = col0 + n;
      B[kk * LD + n] = (c < cin && co < cout)
                           ? w[((size_t)k * cin + c) * cout + co]
                           : from_f32<T>(0.f);
    }
  }
}

// ---- the ring tiles: 128 rows x NC columns per block (see the top). A
// tile policy says how a step's A (rows x Cin chunk) and B (chunk x NC)
// stages are laid out and multiplied; ring_main_loop below is shared.
constexpr int kRingM = 128;            // output rows per block
constexpr int kRingMaxK = 27;          // offsets a table may have
constexpr int kRingGroups = 4;         // 32-row groups: warps over rows
constexpr int kRingWC = 2;             // warps over columns
static_assert(kRingGroups * kRingWC * 32 == kThreads, "8 warps");

// bf16 on the tensor cores: WMMA 16x16x16, f32 accumulation; a warp owns
// 32 rows x NC / 2 columns as 2 x kFC fragments.
template <int NC>
struct RingTile {
  using T = __nv_bfloat16;
  static constexpr int kNC = NC;
  static constexpr int kStages = 3;             // steps in flight
  static constexpr int kK = 32;                 // Cin chunk per step
  static constexpr int kLdA = kK + 8;           // 32-byte aligned rows
  static constexpr int kFC = NC / 16 / kRingWC; // fragment columns per warp
  static constexpr int kLdB = NC + 8;
  static constexpr int kLdC = NC + 4;
  static constexpr int kABytes = kRingM * kLdA * 2;
  static constexpr int kStageBytes = kABytes + kK * kLdB * 2;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kCBytes = kRingM * kLdC * 4;
  static constexpr int kSmemBytes =
      kRingBytes > kCBytes ? kRingBytes : kCBytes;
  static_assert(kFC * 16 * kRingWC == NC, "whole fragments per warp");
  static_assert(kABytes % 128 == 0 && kStageBytes % 128 == 0,
                "aligned stages");
  using Acc = AccFragment[2][kFC];

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kFC; ++j)
        nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  }

  // One step: the warp's 32 rows from wr x NC / 2 columns from wc, acc +=
  // A @ B over the whole chunk (kn, the chunk's channels below Cin, is not
  // needed: the staged zeros past Cin add nothing).
  static __device__ __forceinline__ void step(Acc& acc, const T* A,
                                              const T* B, int wr, int wc,
                                              int /*kn*/) {
    using namespace nvcuda;
#pragma unroll
    for (int ks = 0; ks < kK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], A + (wr + 16 * i) * kLdA + ks, kLdA);
#pragma unroll
      for (int j = 0; j < kFC; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + ks * kLdB + wc + 16 * j, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
  }

  // The warp's accumulators into the block's f32 tile Cs (leading
  // dimension kLdC).
  static __device__ __forceinline__ void store(float* Cs, Acc& acc, int wr,
                                               int wc) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kFC; ++j)
        nvcuda::wmma::store_matrix_sync(
            Cs + (wr + 16 * i) * kLdC + wc + 16 * j, acc[i][j], kLdC,
            nvcuda::wmma::mem_row_major);
  }
};

// f32 on the CUDA cores (no TF32): lane l of a warp owns the 8 rows wr +
// l / 8 + 4 i (i < 8) x the NC / 16 columns of its half from wc at 4 (l %
// 8) + 32 j + q (q < 4, j < NC / 64), then, where NC / 16 % 4 == 2, at 32
// (NC / 64) + 2 (l % 8) + q (q < 2): an 8 x 8 register tile at NC 128, 8 x
// 6 at 96, 8 x 4 at 64, 8 x 2 at 32. Per kAV channels it reads, for each of
// its rows, one float4 (NC <= 64) or float2 of A along Cin (the warp's four
// row addresses fall in distinct banks: kLdA % 32 is 4), and per channel B
// as float4s (and a float2) along Cout that 8 lanes read side by side. The
// shared loads deliver 32 words a clock to the SM's 128 FMA lanes: a lane
// needs NC / 16 x 8 / (NC / 16 + 8) >= 4 FMAs per loaded word, which the
// 8 x 8 tile meets and the narrower ones do not. A float2 of A where the
// tile has 6 or 8 columns, and two stages at NC 128, keep the FMA tile
// within 128 registers with no spill.
template <int NC>
struct FmaRingTile {
  using T = float;
  static constexpr int kNC = NC;
  static constexpr int kStages = NC > 96 ? 2 : 3;   // steps in flight
  static constexpr int kK = 32;                     // Cin chunk per step
  static constexpr int kAV = NC > 64 ? 2 : 4;       // channels per A load
  static constexpr int kLdA = kK + 4;
  static constexpr int kLdB = NC;
  static constexpr int kLdC = NC + 4;
  static constexpr int kCols = NC / 16;             // columns per lane
  static constexpr int kC4 = kCols / 4;             // float4 column groups
  static constexpr int kC2 = kCols % 4 / 2;         // then one float2
  static constexpr int kABytes = kRingM * kLdA * 4;
  static constexpr int kStageBytes = kABytes + kK * kLdB * 4;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kCBytes = kRingM * kLdC * 4;
  static constexpr int kSmemBytes =
      kRingBytes > kCBytes ? kRingBytes : kCBytes;
  static_assert(4 * kC4 + 2 * kC2 == kCols && NC % 32 == 0, "lane columns");
  static_assert(kABytes % 128 == 0 && kStageBytes % 128 == 0,
                "aligned stages");
  using Acc = float[8][kCols];

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // One step: acc += A @ B over the chunk's first kn channels (the rest
  // are zero), in channel order: every output is one fmaf chain.
  static __device__ __forceinline__ void step(Acc& acc, const T* A,
                                              const T* B, int wr, int wc,
                                              int kn) {
    const int lane = threadIdx.x % 32;
    const float* a0 = A + (wr + lane / 8) * kLdA;
    const float* b0 = B + wc;
    const int tc = lane % 8;
#pragma unroll 1
    for (int kk = 0; kk < kn; kk += kAV) {
      float a[8][kAV];   // the lane's 8 rows x kAV channels
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* p = a0 + 4 * i * kLdA + kk;
        if constexpr (kAV == 4) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          a[i][0] = v.x;
          a[i][1] = v.y;
          a[i][2] = v.z;
          a[i][3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(p);
          a[i][0] = v.x;
          a[i][1] = v.y;
        }
      }
#pragma unroll
      for (int q = 0; q < kAV; ++q) {
        const float* brow = b0 + (kk + q) * kLdB;
        float b[kCols];
#pragma unroll
        for (int j = 0; j < kC4; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(brow + 32 * j + 4 * tc);
          b[4 * j] = v.x;
          b[4 * j + 1] = v.y;
          b[4 * j + 2] = v.z;
          b[4 * j + 3] = v.w;
        }
        if constexpr (kC2 == 1) {
          const float2 v =
              *reinterpret_cast<const float2*>(brow + 32 * kC4 + 2 * tc);
          b[4 * kC4] = v.x;
          b[4 * kC4 + 1] = v.y;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[i][c] = fmaf(a[i][q], b[c], acc[i][c]);
      }
    }
  }

  static __device__ __forceinline__ void store(float* Cs, Acc& acc, int wr,
                                               int wc) {
    const int lane = threadIdx.x % 32;
    const int tc = lane % 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = Cs + (wr + lane / 8 + 4 * i) * kLdC + wc;
#pragma unroll
      for (int j = 0; j < kC4; ++j)
        *reinterpret_cast<float4*>(row + 32 * j + 4 * tc) =
            make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2],
                        acc[i][4 * j + 3]);
      if constexpr (kC2 == 1)
        *reinterpret_cast<float2*>(row + 32 * kC4 + 2 * tc) =
            make_float2(acc[i][4 * kC4], acc[i][4 * kC4 + 1]);
    }
  }
};

// Stage x[rows[r], c0 : c0 + K] for the tile's 128 rows into A (leading
// dimension LD; zero for a missing row and past Cin); rows of a 32-row
// group outside `groups` are left as they are (their warps skip the step).
// `vec`: 16-byte copies.
template <typename T, int K, int LD>
__device__ __forceinline__ void stage_rows(T* A, const T* __restrict__ x,
                                           const int* rows, int groups,
                                           int c0, int cin, int sentinel,
                                           bool vec) {
  constexpr int kV = 16 / sizeof(T);
  if (vec) {
#pragma unroll 1   // rolled: 128 registers, two blocks on an SM
    for (int e = threadIdx.x; e < kRingM * (K / kV); e += kThreads) {
      const int r = e / (K / kV);
      const int c = kV * (e % (K / kV));
      if (!(groups >> (r / 32) & 1)) continue;
      const int src = rows[r];
      copy16(A + r * LD + c, x + (size_t)src * cin + c0 + c,
             src != sentinel && c0 + c < cin);
    }
  } else {
    for (int e = threadIdx.x; e < kRingM * K; e += kThreads) {
      const int r = e / K;
      const int c = e % K;
      if (!(groups >> (r / 32) & 1)) continue;
      const int src = rows[r];
      A[r * LD + c] = (src != sentinel && c0 + c < cin)
                          ? x[(size_t)src * cin + c0 + c]
                          : from_f32<T>(0.f);
    }
  }
}

// Block-uniform, by one thread: from the per-(offset, 32-row group) flags
// group_live[kRingGroups * k + j] of K offsets, the live offsets in order
// (live_k), their live groups as bits (live_g) and their count (*n_live).
__device__ __forceinline__ void ring_live_lists(const int* group_live, int K,
                                                int* live_k, int* live_g,
                                                int* n_live) {
  int n = 0;
  for (int k = 0; k < K; ++k) {
    int g = 0;
    for (int j = 0; j < kRingGroups; ++j)
      g |= group_live[kRingGroups * k + j] << j;
    if (g) {
      live_k[n] = k;
      live_g[n] = g;
      ++n;
    }
  }
  *n_live = n;
}

// The default hook of ring_main_loop: nothing between the accumulator
// spill and the store out.
struct RingNoHook {
  __device__ __forceinline__ void operator()(float* /*Cs*/) const {}
};

// The ring main loop of kernels 1 (2's weighted case and 4's dx), 6 and 9,
// in both dtypes (Tile: RingTile or FmaRingTile), after the block's
// prologue: sidx is the block's table of x rows, row r of offset k at
// sidx[k * 128 + r] (`sentinel`: none, staged as a zero row), live_k /
// live_g its n_live live offsets in order with their live 32-row groups.
// Walks the live (offset, Cin chunk) steps through the tile's ring of
// stages, spills the accumulators into the f32 tile Cs (leading dimension
// Tile::kLdC, over the ring), calls hook(Cs) (which, if it writes Cs, ends
// on a barrier), then writes the block's 128 rows x NC columns from (row0,
// col0) through the epilogue: tile row r is output row rows[r] (shared
// memory) where the launch walks a row order, else row0 + r (rows null).
template <typename Tile, typename Hook = RingNoHook>
__device__ __forceinline__ void ring_main_loop(
    unsigned char* smem, const typename Tile::T* __restrict__ x,
    const typename Tile::T* __restrict__ w, const int* sidx,
    const int* live_k, const int* live_g, int n_live,
    const uint8_t* __restrict__ valid, const float* __restrict__ scale,
    const float* __restrict__ shift,
    const typename Tile::T* __restrict__ residual,
    typename Tile::T* __restrict__ out, int n_out, int sentinel, int cin,
    int cout, int relu, int row0, int col0, const int* rows,
    const Hook& hook = Hook()) {
  using T = typename Tile::T;
  constexpr int NC = Tile::kNC;
  constexpr int kK = Tile::kK;
  constexpr int kStages = Tile::kStages;
  constexpr int kV = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int group = warp / kRingWC;              // the warp's 32 rows
  const int wr = 32 * group;
  const int wc = (warp % kRingWC) * (NC / kRingWC);

  const int chunks = (cin + kK - 1) / kK;
  const int steps = n_live * chunks;
  const bool vec_a =
      cin % kV == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w =
      cout % kV == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto abuf = [&](int s) {
    return reinterpret_cast<T*>(smem + (s % kStages) * Tile::kStageBytes);
  };
  auto bbuf = [&](int s) {
    return reinterpret_cast<T*>(smem + (s % kStages) * Tile::kStageBytes +
                                Tile::kABytes);
  };
  // one cp.async group per step, committed also when empty, so that the
  // wait below counts steps
  auto stage = [&](int s) {
    if (s < steps) {
      const int k = live_k[s / chunks];
      const int c0 = (s % chunks) * kK;
      stage_rows<T, kK, Tile::kLdA>(abuf(s), x, sidx + k * kRingM,
                                     live_g[s / chunks], c0, cin, sentinel,
                                     vec_a);
      stage_weights<T, kK, NC, Tile::kLdB, kThreads>(
          bbuf(s), w, k, c0, col0, cin, cout, vec_w);
    }
    __pipeline_commit();
  };

  typename Tile::Acc acc;
  Tile::zero(acc);
  for (int s = 0; s < kStages - 1; ++s) stage(s);
  for (int s = 0; s < steps; ++s) {
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();   // step s landed; step s - 1's buffers are free
    stage(s + kStages - 1);
    if (live_g[s / chunks] >> group & 1) {
      // channels of the chunk below Cin, rounded up to 4
      const int left = cin - (s % chunks) * kK;
      Tile::step(acc, abuf(s), bbuf(s), wr, wc,
                 left < kK ? (left + 3) & ~3 : kK);
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();   // every product read; the ring is free

  float* Cs = reinterpret_cast<float*>(smem);
  Tile::store(Cs, acc, wr, wc);
  __syncthreads();
  hook(Cs);
#pragma unroll 1   // rolled: 128 registers, two blocks on an SM
  for (int e = tid; e < kRingM * NC; e += kThreads) {
    const int r = e / NC;
    const int n = e % NC;
    const int co = col0 + n;
    if (row0 + r >= n_out || co >= cout) continue;
    const int i = rows != nullptr ? rows[r] : row0 + r;
    epilogue_store(Cs[r * Tile::kLdC + n], valid[i] ? 1.f : 0.f,
                   (size_t)i * cout + co, co, scale, shift, residual, out,
                   relu);
  }
}

// A block of kernel 1: its prologue (the tile's (K, 128) slice of idx,
// then which 32-row groups of each offset hold a neighbour) and the ring
// main loop. The block's rows are order[row0 + r] with a row order (kernel
// 1 and 4's dx: K = 27, the sentinel the level's last row), else row0 + r
// (order and keys null: the weighted kernel 2); their neighbour masks,
// keys[row0 + r] (bit k: idx[k, row] is not the sentinel) or every bit
// without keys, say which entries of idx to read. The order only regroups
// whole rows: each output is the same chain of products either way. Each
// thread reads its rows' order and mask entries itself (cached): a staging
// pass behind a barrier cost kernel 2 up to 5% (PERF.md §6).
template <typename Tile>
__device__ __forceinline__ void gather_gemm_ring_block(
    const typename Tile::T* __restrict__ x,
    const typename Tile::T* __restrict__ w, const int* __restrict__ idx,
    const int* __restrict__ order, const int* __restrict__ keys,
    const uint8_t* __restrict__ valid, const float* __restrict__ scale,
    const float* __restrict__ shift,
    const typename Tile::T* __restrict__ residual,
    typename Tile::T* __restrict__ out, int K, int n_out, int sentinel,
    int cin, int cout, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int sidx[kRingMaxK * kRingM];          // (K, 128) indices
  __shared__ int group_live[kRingMaxK * kRingGroups];
  __shared__ int live_k[kRingMaxK];    // the live offsets, in order
  __shared__ int live_g[kRingMaxK];    // their 32-row groups, a bit each
  __shared__ int n_live_s;
  __shared__ int srow[kRingM];         // with an order: the output rows

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRingM;
  const int col0 = blockIdx.y * Tile::kNC;

  for (int e = tid; e < K * kRingM; e += kThreads) {
    const int r = e % kRingM;
    const int k = e / kRingM;
    const int i = row0 + r;
    const int row = order != nullptr && i < n_out ? order[i] : i;
    const int key = i >= n_out ? 0 : keys != nullptr ? keys[i] : ~0;
    sidx[e] = key >> k & 1 ? idx[(size_t)k * n_out + row] : sentinel;
    if (k == 0) srow[r] = row;
  }
  __syncthreads();
  if (tid < K * kRingGroups) {   // (offset, group) = (tid / 4, tid % 4)
    int any = 0;
    for (int j = 0; j < 32; ++j)   // rotated start: no bank conflict
      any |= sidx[32 * tid + (j + tid) % 32] != sentinel;
    group_live[tid] = any;
  }
  __syncthreads();
  if (tid == 0) ring_live_lists(group_live, K, live_k, live_g, &n_live_s);
  __syncthreads();
  ring_main_loop<Tile>(smem, x, w, sidx, live_k, live_g, n_live_s, valid,
                       scale, shift, residual, out, n_out, sentinel, cin,
                       cout, relu, row0, col0,
                       order != nullptr ? srow : nullptr);
}

// The kernel entry of each dtype. bf16: ptxas's own register choice (128
// at NC 96 and 128, two blocks on an SM). f32: at most 128 registers, so
// that two blocks fit on an SM (left to itself ptxas takes up to 185 for
// the FMA tile); as a bound the bf16 body would take it too, but 102 and
// 112 registers at NC 32 and 64 instead of 78 and 99.
#define US3D_GATHER_GEMM_ARGS                                               \
  const typename Tile::T *__restrict__ x,                                   \
      const typename Tile::T *__restrict__ w, const int *__restrict__ idx,  \
      const int *__restrict__ order, const int *__restrict__ keys,          \
      const uint8_t *__restrict__ valid, const float *__restrict__ scale,   \
      const float *__restrict__ shift,                                      \
      const typename Tile::T *__restrict__ residual,                        \
      typename Tile::T *__restrict__ out, int K, int n_out, int sentinel,   \
      int cin, int cout, int relu
template <typename Tile>
__global__ void __launch_bounds__(kThreads)
gather_gemm_ring_kernel(US3D_GATHER_GEMM_ARGS) {
  gather_gemm_ring_block<Tile>(x, w, idx, order, keys, valid, scale, shift,
                               residual, out, K, n_out, sentinel, cin, cout,
                               relu);
}
template <typename Tile>
__global__ void __launch_bounds__(kThreads, 2)
gather_gemm_fma_ring_kernel(US3D_GATHER_GEMM_ARGS) {
  gather_gemm_ring_block<Tile>(x, w, idx, order, keys, valid, scale, shift,
                               residual, out, K, n_out, sentinel, cin, cout,
                               relu);
}
#undef US3D_GATHER_GEMM_ARGS

// f(Tile<NC>{}) for the narrowest NC of 32, 64, 96 and 128 that holds
// `width` (a wider one takes 128-wide column tiles).
template <template <int> class Tile, typename F>
int ring_by_cout(int width, F&& f) {
  if (width <= 32) return f(Tile<32>{});
  if (width <= 64) return f(Tile<64>{});
  if (width <= 96) return f(Tile<96>{});
  return f(Tile<128>{});
}

// The f32 tile's column width for n_out rows x Cout: the widest that holds
// Cout, narrowed by 32 at a time (to kFmaMinNC) while the grid would have
// fewer blocks than the card has SMs. Small levels then spread over more
// SMs; each output's fmaf chain is the same whatever the column tiling.
constexpr int kFmaMinNC = 64;
inline int fma_ring_width(int n_out, int cout) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int tiles = (n_out + kRingM - 1) / kRingM;
  int nc = cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 96 ? 96 : 128;
  while (nc > kFmaMinNC && tiles * ((cout + nc - 1) / nc) < sms) nc -= 32;
  return nc;
}

template <typename Tile>
int launch_ring(const void* x, const void* w, const int* idx,
                const int* order, const int* keys, const uint8_t* valid,
                const float* scale, const float* shift,
                const void* residual, void* out, int K, int n_out,
                int sentinel, int cin, int cout, int relu,
                cudaStream_t stream) {
  using T = typename Tile::T;
  constexpr int kBytes = Tile::kSmemBytes;
  constexpr int NC = Tile::kNC;
  auto* kernel = [] {
    if constexpr (std::is_same<T, float>::value)
      return gather_gemm_fma_ring_kernel<Tile>;
    else
      return gather_gemm_ring_kernel<Tile>;
  }();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((n_out + kRingM - 1) / kRingM, (cout + NC - 1) / NC);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), idx, order, keys,
      valid, scale, shift, static_cast<const T*>(residual),
      static_cast<T*>(out), K, n_out, sentinel, cin, cout, relu);
  return static_cast<int>(cudaGetLastError());
}

// order / keys: a row order of the (27, n_out) map idx and its rows'
// neighbour masks (ops/conv3.py:row_order), or both null.
template <typename T>
int launch_gather_gemm(const void* x, const void* w, const void* idx,
                       const void* order, const void* keys,
                       const void* valid, const void* scale,
                       const void* shift, const void* residual, void* out,
                       int K, int n_out, int sentinel, int cin, int cout,
                       int relu, cudaStream_t stream) {
  if (K > kRingMaxK || (order != nullptr && K != kRingMaxK)) return 1;
  auto launch = [&](auto tile) {   // 1: cudaErrorInvalidValue
    return launch_ring<decltype(tile)>(
        x, w, static_cast<const int*>(idx), static_cast<const int*>(order),
        static_cast<const int*>(keys),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(scale),
        static_cast<const float*>(shift), residual, out, K, n_out, sentinel,
        cin, cout, relu, stream);
  };
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return ring_by_cout<RingTile>(cout, launch);
  else
    return ring_by_cout<FmaRingTile>(fma_ring_width(n_out, cout), launch);
}

}  // namespace us3d
