// Kernel 2: K-offset cross-level gather, weighted or summed.
//
// Replaces unscene3d_tpu/ops/window_gather.py:window_k_apply (Pallas kernel
// `_kernel_k`): out[i] = out_valid[i] * sum_{k<K} x[table[k, i]] (@ w[k]),
// f32 accumulation, skipping entries equal to n_in - 1 (the input level's
// always-padding row). Its uses on the eval path: the k2s2 down conv (child
// tables), the k2 transposed up conv (one-hot parent tables) and, with no
// weights, the 8-child sum behind avg_pool2.
//
// Bound on the H100: the gather of up to 8 input rows per output row. The
// weighted case shares the gather-GEMM body of kernel 1 (gather_gemm.cuh).
//
// The unweighted sum (k_sum_kernel) moves bytes and does no other work: its
// bound is one read of the input level and one write of the output. A warp
// owns up to 32 output rows: lane l loads row l's first 8 table entries
// (one coalesced load per offset, as the table is (K, N_out)) and its valid
// flag once, then the warp walks its rows 32 / G at a time, a group of G
// lanes per row (row_gather.cuh), shuffling each row's entries to its
// group. A lane issues its 8 child loads (16 bytes each on the vector
// path) before it adds any, so they are in flight together. The rows per
// warp shrink (fewer passes of 32 / G rows) until the level gives every SM
// kWarpsPerSm warps, so that a small level still keeps many loads in
// flight. Each output element is the f32 sum s = 0, s += x[child] over the
// offsets in order, skipping the sentinel, then s * valid, rounded once:
// the same adds in the same order as one thread per element, so the output
// does not depend on the lanes' layout (the host's level_bounds replicate
// this order bitwise). No atomics.
#include "gather_gemm.cuh"
#include "row_gather.cuh"

namespace {

constexpr int kSumWarps = 4;     // warps per block
constexpr int kWarpsPerSm = 64;  // warps the rows per warp aim for
constexpr int kHeld = 8;         // table entries a lane holds: K <= 8

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kSumWarps * 32)
    k_sum_kernel(const T* __restrict__ x, const int* __restrict__ table,
                 const uint8_t* __restrict__ valid, T* __restrict__ out,
                 int K, int n_out, int sentinel, int c, int passes) {
  constexpr int kRowsPerPass = 32 / G;
  const int lane = threadIdx.x % 32;
  const int rows = passes * kRowsPerPass;  // this warp's, at most 32
  const int i0 = (blockIdx.x * kSumWarps + threadIdx.x / 32) * rows;
  if (i0 >= n_out) return;  // the whole warp
  const int blocks = c / VEC;
  const bool own = lane < rows && i0 + lane < n_out;
  int held[kHeld];
#pragma unroll
  for (int k = 0; k < kHeld; ++k)
    held[k] = own && k < K ? table[(size_t)k * n_out + i0 + lane] : sentinel;
  const int held_valid = own && valid[i0 + lane];
  for (int pass = 0; pass < passes; ++pass) {
    const int r = pass * kRowsPerPass + lane / G;  // row within the warp's
    int src[kHeld];
#pragma unroll
    for (int k = 0; k < kHeld; ++k) src[k] = __shfl_sync(~0u, held[k], r);
    const float vm = __shfl_sync(~0u, held_valid, r) ? 1.f : 0.f;
    const int i = i0 + r;
    if (i >= n_out) continue;  // after the shuffles, which every lane joins
#pragma unroll 1
    for (int b = lane % G; b < blocks; b += G) {
      us3d::RowPack<T, VEC> v[kHeld];
#pragma unroll
      for (int k = 0; k < kHeld; ++k)
        if (src[k] != sentinel)
          v[k] = us3d::load_pack<T, VEC>(x + (size_t)src[k] * c + b * VEC);
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll
      for (int k = 0; k < kHeld; ++k)
        if (src[k] != sentinel) us3d::add_pack(acc, v[k]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] *= vm;
      us3d::store_pack(out + (size_t)i * c + b * VEC, acc);
    }
  }
}

template <typename T>
int launch_sum(const void* x, const void* table, const void* valid, void* out,
               int K, int n_out, int n_in, int c, cudaStream_t st) {
  if (K > kHeld) return 1;  // cudaErrorInvalidValue
  const int vec = us3d::row_vec<T>(c, x, out);
  const int g = us3d::lanes_per_row(c / vec);
  const int per_pass = 32 / g;  // rows a pass covers
  auto warps = [&](int passes) {
    return (n_out + passes * per_pass - 1) / (passes * per_pass);
  };
  int passes = g;  // 32 rows per warp
  while (passes > 1 && warps(passes) < kWarpsPerSm * us3d::sm_count())
    passes /= 2;
  const unsigned blocks = (unsigned)((warps(passes) + kSumWarps - 1) /
                                     kSumWarps);
  return us3d::with_row_layout<T>(vec, g, [&](auto v, auto lanes) {
    constexpr int kVec = decltype(v)::value;
    constexpr int kG = decltype(lanes)::value;
    k_sum_kernel<T, kVec, kG><<<blocks, kSumWarps * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const int*>(table),
        static_cast<const uint8_t*>(valid), static_cast<T*>(out), K, n_out,
        n_in - 1, c, passes);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" int k_apply_gemm(const void* x, const void* w, const void* table,
                            const void* valid, void* out, int K, int n_out,
                            int n_in, int cin, int cout, int is_bf16,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return us3d::launch_gather_gemm<__nv_bfloat16>(
        x, w, table, nullptr, nullptr, valid, nullptr, nullptr, nullptr, out,
        K, n_out, n_in - 1, cin, cout, 0, st);
  return us3d::launch_gather_gemm<float>(x, w, table, nullptr, nullptr,
                                         valid, nullptr, nullptr, nullptr,
                                         out, K, n_out, n_in - 1, cin, cout,
                                         0, st);
}

extern "C" int k_apply_sum(const void* x, const void* table,
                           const void* valid, void* out, int K, int n_out,
                           int n_in, int c, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_sum<__nv_bfloat16>(x, table, valid, out, K, n_out, n_in, c,
                                     st);
  return launch_sum<float>(x, table, valid, out, K, n_out, n_in, c, st);
}
