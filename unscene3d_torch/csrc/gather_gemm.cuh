// Shared gather-GEMM body of kernel 1 (conv3.cu) and the weighted case of
// kernel 2 (k_apply.cu):
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
// (2 x Cout / itemsize). This simple design: one 256-thread block per tile of
// TM output rows x TN output channels loops over the K offsets and over
// 32-channel Cin chunks; it stages the tile's neighbour indices in shared
// memory, skips an offset when no row of the tile has that neighbour,
// gathers the rows (coalesced along channels, zero for missing rows) and the
// weight slice into shared memory, and multiplies: f32 on the CUDA cores
// with a 4x4 register tile per thread, bf16 on the tensor cores through
// WMMA fragments with f32 accumulation. Every output element is summed in a
// fixed order: no atomics, bitwise deterministic. wgmma and cp.async/TMA
// staging are later work; valid-pair compaction is kernel 6 (csr_conv.cu).
// The weight staging, the per-chunk products and the epilogue are device
// functions that kernel 6 shares; kernels 7 and 8 (brick_tile.cuh) share the
// epilogue and the accumulator fragment.
#pragma once

#include <cuda_bf16.h>
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

// bf16 variant on the tensor cores (WMMA 16x16x16, f32 accumulation): the
// same gather and skip, one 256-thread block per 128 rows x 64 channels,
// each of the 8 warps owning a 32 x 32 sub-tile (2 x 2 fragments). The
// accumulators go through shared memory for the epilogue, so stores stay
// coalesced along channels. Still deterministic: the MMA order is fixed.
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

template <typename T>   // T = __nv_bfloat16 (a template: one copy per .so)
__global__ void __launch_bounds__(kThreads)
gather_gemm_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const int* __restrict__ idx,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift,
                      const T* __restrict__ residual, T* __restrict__ out,
                      int K, int n_out, int sentinel, int cin, int cout,
                      int relu) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 only");
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kTcBytes];
  __shared__ int rows[kTcM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + kTcABytes);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = (warp / 2) * 32;   // warp's row offset in the tile
  const int wc = (warp % 2) * 32;   // warp's column offset
  const int row0 = blockIdx.x * kTcM;
  const int col0 = blockIdx.y * kTcN;
  const T zero = __float2bfloat16(0.f);

  AccFragment acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k = 0; k < K; ++k) {
    int any = 0;
    for (int r = tid; r < kTcM; r += kThreads) {
      const int i = row0 + r;
      const int src = (i < n_out) ? idx[(size_t)k * n_out + i] : sentinel;
      rows[r] = src;
      any |= (src != sentinel);
    }
    if (!__syncthreads_or(any)) continue;
    for (int c0 = 0; c0 < cin; c0 += kTcK) {
      for (int e = tid; e < kTcM * kTcK; e += kThreads) {
        const int r = e / kTcK;
        const int kk = e % kTcK;
        const int src = rows[r];
        const int c = c0 + kk;
        As[r * kTcLdA + kk] = (src != sentinel && c < cin)
                                  ? x[(size_t)src * cin + c] : zero;
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
    const int n = e % kTcN;
    const int i = row0 + r;
    const int co = col0 + n;
    if (i >= n_out || co >= cout) continue;
    epilogue_store(Cs[r * kTcLdC + n], valid[i] ? 1.f : 0.f,
                   (size_t)i * cout + co, co, scale, shift, residual, out,
                   relu);
  }
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
    dim3 grid((n_out + kTcM - 1) / kTcM, (cout + kTcN - 1) / kTcN);
    gather_gemm_tc_kernel<T><<<grid, kThreads, 0, stream>>>(
        xp, wp, ip, vp, sp, hp, rp, op, K, n_out, sentinel, cin, cout, relu);
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
