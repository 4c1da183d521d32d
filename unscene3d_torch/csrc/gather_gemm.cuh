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
// Bound on the H100: the gather. Each output row reads ~8.7 valid neighbour
// rows x Cin x itemsize at level 0 of the bench scene (of 27 offsets), from
// anywhere in the level, while the FLOPs per gathered byte are small
// (2 x Cout / itemsize); what the card spends is the staging of those rows
// into shared memory and the fragment loads, not HBM bytes or MMAs.
//
// bf16 (gather_gemm_ring_kernel): one 256-thread block owns 128 output rows
// x all of Cout up to 128 (wider Cout takes 128-wide column tiles), so each
// gathered row feeds every output column of its block once. The block
// stages the tile's K x 128 neighbour indices once, with the list of live
// offsets (those some row of the tile has) and, per live offset, which of
// the four 32-row groups have it; the pipeline walks only the live (offset,
// 32-channel chunk) steps. A step's rows arrive by 16-byte cp.async
// (__pipeline_memcpy_async), a missing row as an explicit zero store, with
// the weight slice beside them, into a 3-stage ring with one barrier per
// step, so the next steps' copies fly while this one multiplies (WMMA
// 16x16x16, f32 accumulation; a warp owns 32 rows x half of the columns and
// skips a step where its rows have no neighbour). Rows or weights whose width
// or base is not 16-byte aligned (the stem's Cin 3) take scalar loads in the
// same kernel. The accumulators go through shared memory (over the ring) to
// the epilogue, so stores stay coalesced along channels.
//
// f32 (gather_gemm_kernel): the same skip of absent offsets, scalar staging
// and a 4x4 register tile per thread on the CUDA cores, no TF32.
//
// Every output element is summed in a fixed order (offsets in order, Cin
// chunks in order): no atomics, two runs are bitwise equal. The weight
// staging, the per-chunk products and the epilogue are device functions
// that kernel 6 (csr_conv.cu) and kernel 9 (win_decompose.cu) share;
// kernels 7 and 8 (brick_tile.cuh) share the epilogue, the accumulator
// fragment and the 16-byte staging helpers.
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
constexpr int kTK = 32;        // Cin chunk staged per step

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

// Stage w[k, c0 : c0 + kTK, col0 : col0 + TN] into Bs as f32 (zero past the
// edges).
template <int TN, typename T>
__device__ __forceinline__ void stage_weights_f32(float (*Bs)[TN],
                                                  const T* __restrict__ w,
                                                  int k, int c0, int col0,
                                                  int cin, int cout) {
  for (int e = threadIdx.x; e < kTK * TN; e += kThreads) {
    const int kk = e / TN;
    const int n = e % TN;
    const int c = c0 + kk;
    const int co = col0 + n;
    Bs[kk][n] = (c < cin && co < cout)
                    ? to_f32(w[((size_t)k * cin + c) * cout + co])
                    : 0.f;
  }
}

// One kTK chunk of the f32 product on the CUDA cores: acc (4 x 4 per
// thread, rows ty + TY * r, columns tx + TX * c) += As^T @ Bs with
// As[kk][row] and Bs[kk][col].
template <int TM, int TN>
__device__ __forceinline__ void fma_chunk(float (*As)[TM + 1],
                                          float (*Bs)[TN],
                                          float (&acc)[4][4], int tx,
                                          int ty) {
  constexpr int TX = TN / 4;
  constexpr int TY = kThreads / TX;
#pragma unroll 8
  for (int kk = 0; kk < kTK; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + TY * r];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + TX * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// TN output channels per block; TM = 4096 / TN output rows, so every thread
// owns a 4 x 4 register tile.
template <typename T, int TN>
__global__ void __launch_bounds__(kThreads)
gather_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const int* __restrict__ idx,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const T* __restrict__ residual, T* __restrict__ out,
                   int K, int n_out, int sentinel, int cin, int cout,
                   int relu) {
  constexpr int TM = 4096 / TN;
  constexpr int TX = TN / 4;          // threads across columns
  constexpr int TY = kThreads / TX;   // threads across rows
  static_assert(TY * 4 == TM, "4x4 register tile per thread");
  __shared__ float As[kTK][TM + 1];   // +1: conflict-free column stores
  __shared__ float Bs[kTK][TN];
  __shared__ int rows[TM];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k = 0; k < K; ++k) {
    int any = 0;
    for (int r = tid; r < TM; r += kThreads) {
      const int i = row0 + r;
      const int src = (i < n_out) ? idx[(size_t)k * n_out + i] : sentinel;
      rows[r] = src;
      any |= (src != sentinel);
    }
    // block-uniform: skip the offset when no row of the tile has it
    if (!__syncthreads_or(any)) continue;
    for (int c0 = 0; c0 < cin; c0 += kTK) {
      for (int e = tid; e < TM * kTK; e += kThreads) {
        const int r = e / kTK;
        const int kk = e % kTK;
        const int src = rows[r];
        const int c = c0 + kk;
        float v = 0.f;
        if (src != sentinel && c < cin) v = to_f32(x[(size_t)src * cin + c]);
        As[kk][r] = v;
      }
      stage_weights_f32<TN>(Bs, w, k, c0, col0, cin, cout);
      __syncthreads();
      fma_chunk<TM, TN>(As, Bs, acc, tx, ty);
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + ty + TY * r;
    if (i >= n_out) continue;
    const float vm = valid[i] ? 1.f : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int co = col0 + tx + TX * c;
      if (co >= cout) continue;
      epilogue_store(acc[r][c], vm, (size_t)i * cout + co, co, scale, shift,
                     residual, out, relu);
    }
  }
}

// The 128 x 64 tensor-core tile of kernels 6 and 9 (csr_conv.cu,
// win_decompose.cu): each of the 8 warps owns a 32 x 32 sub-tile (2 x 2
// fragments) and the accumulators go through shared memory to the epilogue.
constexpr int kTcM = 128, kTcN = 64, kTcK = 32;
constexpr int kTcLdA = kTcK + 8;   // bf16 leading dims: multiples of 8 and
constexpr int kTcLdB = kTcN + 8;   // 32-byte aligned fragment rows
constexpr int kTcLdC = kTcN + 4;   // f32 leading dim: a multiple of 4
// shared memory of a tensor-core block: the A and B staging, reused by the
// f32 accumulator tile after the main loop
constexpr int kTcABytes = kTcM * kTcLdA * 2;
constexpr int kTcBBytes = kTcK * kTcLdB * 2;
constexpr int kTcCBytes = kTcM * kTcLdC * 4;
constexpr int kTcBytes = kTcABytes + kTcBBytes > kTcCBytes
                             ? kTcABytes + kTcBBytes : kTcCBytes;

// Stage w[k, c0 : c0 + kTcK, col0 : col0 + kTcN] into Bs (bf16, leading
// dimension kTcLdB, zero past the edges).
template <typename T>
__device__ __forceinline__ void stage_weights_tc(T* Bs,
                                                 const T* __restrict__ w,
                                                 int k, int c0, int col0,
                                                 int cin, int cout) {
  const T zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < kTcK * kTcN; e += kThreads) {
    const int kk = e / kTcN;
    const int n = e % kTcN;
    const int c = c0 + kk;
    const int co = col0 + n;
    Bs[kk * kTcLdB + n] = (c < cin && co < cout)
                              ? w[((size_t)k * cin + c) * cout + co]
                              : zero;
  }
}

using AccFragment =
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// One kTcK chunk on the tensor cores: the warp's 32 x 32 sub-tile at (wr,
// wc) of the 128 x 64 block tile, acc (2 x 2 fragments) += As @ Bs.
template <typename T>
__device__ __forceinline__ void wmma_chunk(const T* As, const T* Bs,
                                           AccFragment (&acc)[2][2], int wr,
                                           int wc) {
  using namespace nvcuda;
#pragma unroll
  for (int ks = 0; ks < kTcK; ks += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], As + (wr + 16 * i) * kTcLdA + ks, kTcLdA);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], Bs + ks * kTcLdB + wc + 16 * j, kTcLdB);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

// Spill the warps' accumulator fragments into the block's f32 tile Cs
// (leading dimension kTcLdC), which may reuse the A/B staging: call after
// the main loop's last barrier; ends on a barrier.
__device__ __forceinline__ void store_acc_tile(float* Cs,
                                               AccFragment (&acc)[2][2],
                                               int wr, int wc) {
  using namespace nvcuda;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr + 16 * i) * kTcLdC + wc + 16 * j,
                              acc[i][j], kTcLdC, wmma::mem_row_major);
  __syncthreads();
}

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

// ---- the bf16 ring tile: 128 rows x NC columns per block (see the top)
constexpr int kRingM = 128;            // output rows per block
constexpr int kRingK = 32;             // Cin chunk per step
constexpr int kRingStages = 3;         // steps in flight
constexpr int kRingMaxK = 27;          // offsets a table may have
constexpr int kRingGroups = 4;         // 32-row groups: warps over rows
constexpr int kRingLdA = kRingK + 8;   // 32-byte aligned fragment rows

template <int NC>
struct RingTile {
  using T = __nv_bfloat16;
  static constexpr int kWC = 2;                 // warps over columns
  static constexpr int kFC = NC / 16 / kWC;     // fragment columns per warp
  static constexpr int kLdB = NC + 8;
  static constexpr int kLdC = NC + 4;
  static constexpr int kABytes = kRingM * kRingLdA * 2;
  static constexpr int kStageBytes = kABytes + kRingK * kLdB * 2;
  static constexpr int kRingBytes = kRingStages * kStageBytes;
  static constexpr int kCBytes = kRingM * kLdC * 4;
  static constexpr int kSmemBytes =
      kRingBytes > kCBytes ? kRingBytes : kCBytes;
  static_assert(kFC * 16 * kWC == NC, "whole fragments per warp");
  static_assert(kABytes % 128 == 0 && kStageBytes % 128 == 0,
                "aligned stages");
  static_assert(kRingGroups * kWC * 32 == kThreads, "8 warps");

  // One step: the warp's 32 rows x NC / 2 columns, acc += A @ B.
  static __device__ __forceinline__ void step(AccFragment (&acc)[2][kFC],
                                              const T* A, const T* B,
                                              int wr, int wc) {
    using namespace nvcuda;
#pragma unroll
    for (int ks = 0; ks < kRingK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], A + (wr + 16 * i) * kRingLdA + ks,
                               kRingLdA);
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
};

// Stage x[rows[r], c0 : c0 + kRingK] for the tile's 128 rows into A (zero
// for a missing row and past Cin); rows of a 32-row group outside `groups`
// are left as they are (their warps skip the step). `vec`: 16-byte copies.
template <typename T>
__device__ __forceinline__ void stage_rows(T* A, const T* __restrict__ x,
                                           const int* rows, int groups,
                                           int c0, int cin, int sentinel,
                                           bool vec) {
  if (vec) {
#pragma unroll 1   // rolled: 128 registers, two blocks on an SM
    for (int e = threadIdx.x; e < kRingM * (kRingK / 8); e += kThreads) {
      const int r = e / (kRingK / 8);
      const int c = 8 * (e % (kRingK / 8));
      if (!(groups >> (r / 32) & 1)) continue;
      const int src = rows[r];
      copy16(A + r * kRingLdA + c, x + (size_t)src * cin + c0 + c,
             src != sentinel && c0 + c < cin);
    }
  } else {
    for (int e = threadIdx.x; e < kRingM * kRingK; e += kThreads) {
      const int r = e / kRingK;
      const int c = e % kRingK;
      if (!(groups >> (r / 32) & 1)) continue;
      const int src = rows[r];
      A[r * kRingLdA + c] = (src != sentinel && c0 + c < cin)
                                ? x[(size_t)src * cin + c0 + c]
                                : from_f32<T>(0.f);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
gather_gemm_ring_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const int* __restrict__ idx,
                        const uint8_t* __restrict__ valid,
                        const float* __restrict__ scale,
                        const float* __restrict__ shift,
                        const __nv_bfloat16* __restrict__ residual,
                        __nv_bfloat16* __restrict__ out, int K, int n_out,
                        int sentinel, int cin, int cout, int relu) {
  using Tile = RingTile<NC>;
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int sidx[kRingMaxK * kRingM];          // (K, 128) indices
  __shared__ int group_live[kRingMaxK * kRingGroups];
  __shared__ int live_k[kRingMaxK];    // the live offsets, in order
  __shared__ int live_g[kRingMaxK];    // their 32-row groups, a bit each
  __shared__ int n_live_s;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int group = warp / Tile::kWC;              // the warp's 32 rows
  const int wr = 32 * group;
  const int wc = (warp % Tile::kWC) * (NC / Tile::kWC);
  const int row0 = blockIdx.x * kRingM;
  const int col0 = blockIdx.y * NC;

  for (int e = tid; e < K * kRingM; e += kThreads) {
    const int i = row0 + e % kRingM;
    sidx[e] = i < n_out ? idx[(size_t)(e / kRingM) * n_out + i] : sentinel;
  }
  __syncthreads();
  if (tid < K * kRingGroups) {   // (offset, group) = (tid / 4, tid % 4)
    int any = 0;
    for (int j = 0; j < 32; ++j)   // rotated start: no bank conflict
      any |= sidx[32 * tid + (j + tid) % 32] != sentinel;
    group_live[tid] = any;
  }
  __syncthreads();
  if (tid == 0) {
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
    n_live_s = n;
  }
  __syncthreads();

  const int chunks = (cin + kRingK - 1) / kRingK;
  const int steps = n_live_s * chunks;
  const bool vec_a = cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w =
      cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto abuf = [&](int s) {
    return reinterpret_cast<T*>(smem + (s % kRingStages) * Tile::kStageBytes);
  };
  auto bbuf = [&](int s) {
    return reinterpret_cast<T*>(smem + (s % kRingStages) * Tile::kStageBytes +
                                Tile::kABytes);
  };
  // one cp.async group per step, committed also when empty, so that the
  // wait below counts steps
  auto stage = [&](int s) {
    if (s < steps) {
      const int k = live_k[s / chunks];
      const int c0 = (s % chunks) * kRingK;
      stage_rows(abuf(s), x, sidx + k * kRingM, live_g[s / chunks], c0, cin,
                 sentinel, vec_a);
      stage_weights<T, kRingK, NC, Tile::kLdB, kThreads>(
          bbuf(s), w, k, c0, col0, cin, cout, vec_w);
    }
    __pipeline_commit();
  };

  AccFragment acc[2][Tile::kFC];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Tile::kFC; ++j)
      nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
  for (int s = 0; s < kRingStages - 1; ++s) stage(s);
  for (int s = 0; s < steps; ++s) {
    __pipeline_wait_prior(kRingStages - 2);
    __syncthreads();   // step s landed; step s - 1's buffers are free
    stage(s + kRingStages - 1);
    if (live_g[s / chunks] >> group & 1)
      Tile::step(acc, abuf(s), bbuf(s), wr, wc);
  }
  __pipeline_wait_prior(0);
  __syncthreads();   // every product read; the ring is free

  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < Tile::kFC; ++j)
      nvcuda::wmma::store_matrix_sync(
          Cs + (wr + 16 * i) * Tile::kLdC + wc + 16 * j, acc[i][j],
          Tile::kLdC, nvcuda::wmma::mem_row_major);
  __syncthreads();
#pragma unroll 1   // rolled: 128 registers, two blocks on an SM
  for (int e = tid; e < kRingM * NC; e += kThreads) {
    const int r = e / NC;
    const int n = e % NC;
    const int i = row0 + r;
    const int co = col0 + n;
    if (i >= n_out || co >= cout) continue;
    epilogue_store(Cs[r * Tile::kLdC + n], valid[i] ? 1.f : 0.f,
                   (size_t)i * cout + co, co, scale, shift, residual, out,
                   relu);
  }
}

template <int NC>
int launch_ring(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const int* idx, const uint8_t* valid, const float* scale,
                const float* shift, const __nv_bfloat16* residual,
                __nv_bfloat16* out, int K, int n_out, int sentinel, int cin,
                int cout, int relu, cudaStream_t stream) {
  constexpr int kBytes = RingTile<NC>::kSmemBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gather_gemm_ring_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((n_out + kRingM - 1) / kRingM, (cout + NC - 1) / NC);
  gather_gemm_ring_kernel<NC><<<grid, kThreads, kBytes, stream>>>(
      x, w, idx, valid, scale, shift, residual, out, K, n_out, sentinel, cin,
      cout, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather_gemm(const void* x, const void* w, const void* idx,
                       const void* valid, const void* scale,
                       const void* shift, const void* residual, void* out,
                       int K, int n_out, int sentinel, int cin, int cout,
                       int relu, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const int* ip = static_cast<const int*>(idx);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  const T* rp = static_cast<const T*>(residual);
  T* op = static_cast<T*>(out);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (K > kRingMaxK) return 1;   // cudaErrorInvalidValue
    if (cout <= 32)
      return launch_ring<32>(xp, wp, ip, vp, sp, hp, rp, op, K, n_out,
                             sentinel, cin, cout, relu, stream);
    if (cout <= 64)
      return launch_ring<64>(xp, wp, ip, vp, sp, hp, rp, op, K, n_out,
                             sentinel, cin, cout, relu, stream);
    if (cout <= 96)
      return launch_ring<96>(xp, wp, ip, vp, sp, hp, rp, op, K, n_out,
                             sentinel, cin, cout, relu, stream);
    return launch_ring<128>(xp, wp, ip, vp, sp, hp, rp, op, K, n_out,
                            sentinel, cin, cout, relu, stream);
  } else if (cout % 64 == 0) {
    dim3 grid((n_out + 63) / 64, cout / 64);
    gather_gemm_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        xp, wp, ip, vp, sp, hp, rp, op, K, n_out, sentinel, cin, cout, relu);
  } else {
    dim3 grid((n_out + 127) / 128, (cout + 31) / 32);
    gather_gemm_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
        xp, wp, ip, vp, sp, hp, rp, op, K, n_out, sentinel, cin, cout, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace us3d
