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
// dW: bound by the row gather, like the forward. dW[k] is a GEMM whose
// reduction runs over rows: (Cin x rows) @ (rows x Cout). One 256-thread
// block owns one (offset k, 64-wide Cin tile, 64-wide Cout tile) and a fixed
// contiguous range of rows; it walks the range in 32-row chunks, stages the
// chunk's neighbour indices, gathers the x rows and reads the matching gm
// rows into shared memory (a chunk none of whose rows has the neighbour is
// skipped) and accumulates in f32: FMA on the CUDA cores for f32 (a 4x4 or
// smaller register tile per thread), WMMA 16x16x16 with f32 accumulation for
// bf16. Each block writes its partial (Cin tile x Cout tile) into a
// per-range slice of an f32 scratch; a second pass sums the slices in range
// order. No float atomics: two runs are bitwise equal.
#include "gather_gemm.cuh"

namespace {

using us3d::kThreads;
using us3d::to_f32;

constexpr int kRows = 32;   // rows reduced per chunk

// Block-uniform: stage the chunk's neighbour rows for offset k, return
// whether any row of the chunk has the neighbour.
__device__ __forceinline__ int stage_rows(const int* __restrict__ nbr,
                                          int* rows, int k, int r0, int r_end,
                                          int n) {
  int any = 0;
  const int tid = threadIdx.x;
  if (tid < kRows) {
    const int i = r0 + tid;
    const int src = (i < r_end) ? nbr[(size_t)k * n + i] : n - 1;
    rows[tid] = src;
    any = src != n - 1;
  }
  return __syncthreads_or(any);
}

// f32 on the CUDA cores: TC x TD output tile, 16 x 16 threads, each owning a
// (TC/16) x (TD/16) register tile.
template <typename T, int TC, int TD>
__global__ void __launch_bounds__(kThreads)
dw_fma_kernel(const T* __restrict__ x, const T* __restrict__ gm,
              const int* __restrict__ nbr, float* __restrict__ part, int n,
              int cin, int cout, int rows_per_split, int splits) {
  constexpr int RC = TC / 16;
  constexpr int RD = TD / 16;
  __shared__ float Xs[kRows][TC];
  __shared__ float Gs[kRows][TD];
  __shared__ int rows[kRows];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int d0 = blockIdx.x * TD;
  const int c0 = blockIdx.y * TC;
  const int k = blockIdx.z / splits;
  const int s = blockIdx.z % splits;
  const int r_begin = s * rows_per_split;
  const int r_end = n < r_begin + rows_per_split ? n : r_begin + rows_per_split;
  const int sentinel = n - 1;

  float acc[RC][RD];
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
    if (!stage_rows(nbr, rows, k, r0, r_end, n)) continue;
    for (int e = tid; e < kRows * TC; e += kThreads) {
      const int r = e / TC;
      const int c = e % TC;
      const int src = rows[r];
      Xs[r][c] = (src != sentinel && c0 + c < cin)
                     ? to_f32(x[(size_t)src * cin + c0 + c]) : 0.f;
    }
    for (int e = tid; e < kRows * TD; e += kThreads) {
      const int r = e / TD;
      const int d = e % TD;
      Gs[r][d] = (rows[r] != sentinel && d0 + d < cout)
                     ? to_f32(gm[(size_t)(r0 + r) * cout + d0 + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float a[RC], b[RD];
#pragma unroll
      for (int i = 0; i < RC; ++i) a[i] = Xs[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RD; ++j) b[j] = Gs[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RC; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + ((size_t)s * 27 + k) * cin * cout;
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= cin) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const int d = d0 + tx + 16 * j;
      if (d < cout) out[(size_t)c * cout + d] = acc[i][j];
    }
  }
}

// bf16 on the tensor cores: a 64 x 64 output tile, each of the 8 warps owning
// 16 Cin rows x 32 Cout columns (1 x 2 fragments). The gathered x chunk is
// stored transposed (Cin x rows), so both operands load row-major.
constexpr int kTcC = 64, kTcD = 64;
constexpr int kLdA = kRows + 8;   // bf16 leading dims: multiples of 8 and
constexpr int kLdB = kTcD + 8;    // 32-byte aligned fragment rows
constexpr int kLdC = kTcD + 4;    // f32 leading dim: a multiple of 4

template <typename T>   // T = __nv_bfloat16 (a template: one copy per .so)
__global__ void __launch_bounds__(kThreads)
dw_tc_kernel(const T* __restrict__ x, const T* __restrict__ gm,
             const int* __restrict__ nbr, float* __restrict__ part, int n,
             int cin, int cout, int rows_per_split, int splits) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 only");
  using namespace nvcuda;
  constexpr int kABytes = kTcC * kLdA * 2;
  constexpr int kBBytes = kRows * kLdB * 2;
  constexpr int kCBytes = kTcC * kLdC * 4;
  constexpr int kBytes = kABytes + kBBytes > kCBytes ? kABytes + kBBytes
                                                     : kCBytes;
  // the f32 accumulator tile reuses the A/B staging after the main loop
  __shared__ __align__(128) unsigned char smem[kBytes];
  __shared__ int rows[kRows];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + kABytes);
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wc = (warp / 2) * 16;   // warp's Cin offset in the tile
  const int wd = (warp % 2) * 32;   // warp's Cout offset
  const int d0 = blockIdx.x * kTcD;
  const int c0 = blockIdx.y * kTcC;
  const int k = blockIdx.z / splits;
  const int s = blockIdx.z % splits;
  const int r_begin = s * rows_per_split;
  const int r_end = n < r_begin + rows_per_split ? n : r_begin + rows_per_split;
  const int sentinel = n - 1;
  const T zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
    if (!stage_rows(nbr, rows, k, r0, r_end, n)) continue;
    for (int e = tid; e < kRows * kTcC; e += kThreads) {
      const int r = e / kTcC;
      const int c = e % kTcC;
      const int src = rows[r];
      As[c * kLdA + r] = (src != sentinel && c0 + c < cin)
                             ? x[(size_t)src * cin + c0 + c] : zero;
    }
    for (int e = tid; e < kRows * kTcD; e += kThreads) {
      const int r = e / kTcD;
      const int d = e % kTcD;
      Bs[r * kLdB + d] = (rows[r] != sentinel && d0 + d < cout)
                             ? gm[(size_t)(r0 + r) * cout + d0 + d] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kRows; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
      wmma::load_matrix_sync(a, As + wc * kLdA + ks, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + ks * kLdB + wd + 16 * j, kLdB);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[j], a, b[j], acc[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(Cs + wc * kLdC + wd + 16 * j, acc[j], kLdC,
                            wmma::mem_row_major);
  __syncthreads();
  float* out = part + ((size_t)s * 27 + k) * cin * cout;
  for (int e = tid; e < kTcC * kTcD; e += kThreads) {
    const int c = c0 + e / kTcD;
    const int d = d0 + e % kTcD;
    if (c < cin && d < cout)
      out[(size_t)c * cout + d] = Cs[(e / kTcD) * kLdC + e % kTcD];
  }
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

template <typename T, int TC, int TD>
void launch_fma(const void* x, const void* gm, const void* nbr, float* part,
                int n, int cin, int cout, int rows_per_split, int splits,
                cudaStream_t st) {
  dim3 grid((cout + TD - 1) / TD, (cin + TC - 1) / TC, 27 * splits);
  dw_fma_kernel<T, TC, TD><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gm),
      static_cast<const int*>(nbr), part, n, cin, cout, rows_per_split,
      splits);
}

}  // namespace

extern "C" int conv3_bwd_dx(const void* gm, const void* wflip,
                            const void* nbr, const void* valid, void* dx,
                            int n, int cin, int cout, int is_bf16,
                            void* stream) {
  // gm (N, Cout) gathered through wflip (27, Cout, Cin) into dx (N, Cin)
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return us3d::launch_gather_gemm<__nv_bfloat16>(
        gm, wflip, nbr, valid, nullptr, nullptr, nullptr, dx, 27, n, n - 1,
        cout, cin, 0, st);
  return us3d::launch_gather_gemm<float>(gm, wflip, nbr, valid, nullptr,
                                         nullptr, nullptr, dx, 27, n, n - 1,
                                         cout, cin, 0, st);
}

// part: (splits, 27, Cin, Cout) f32 scratch, unused (may be NULL) when
// splits == 1; dw: (27, Cin, Cout) f32.
extern "C" int conv3_dw(const void* x, const void* gm, const void* nbr,
                        void* part, void* dw, int n, int cin, int cout,
                        int splits, int rows_per_split, int is_bf16,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(splits > 1 ? part : dw);
  if (is_bf16) {
    dim3 grid((cout + kTcD - 1) / kTcD, (cin + kTcC - 1) / kTcC,
              27 * splits);
    dw_tc_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gm), static_cast<const int*>(nbr),
        out, n, cin, cout, rows_per_split, splits);
  } else if (cin <= 32 && cout <= 32) {
    launch_fma<float, 32, 32>(x, gm, nbr, out, n, cin, cout, rows_per_split,
                              splits, st);
  } else if (cin <= 32) {
    launch_fma<float, 32, 64>(x, gm, nbr, out, n, cin, cout, rows_per_split,
                              splits, st);
  } else if (cout <= 32) {
    launch_fma<float, 64, 32>(x, gm, nbr, out, n, cin, cout, rows_per_split,
                              splits, st);
  } else {
    launch_fma<float, 64, 64>(x, gm, nbr, out, n, cin, cout, rows_per_split,
                              splits, st);
  }
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0 || splits == 1) return code;
  const size_t m = (size_t)27 * cin * cout;
  dw_reduce_kernel<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), m, splits);
  return static_cast<int>(cudaGetLastError());
}
