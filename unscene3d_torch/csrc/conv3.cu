// Kernel 1: k3 submanifold sparse conv forward with fused epilogue.
//
// Replaces unscene3d_tpu/ops/window_conv.py:window_conv3_fwd (Pallas kernel
// `_kernel`): out[i] = valid[i] * epi(sum_{k<27} x[nbr_idx[k, i]] @ w[k]),
// f32 accumulation, epilogue *scale+shift, +residual, ReLU, validity mask.
// The TPU kernel streamed sliding row windows into VMEM and selected
// neighbours with one-hot matmuls; on Hopper the block reads the level's
// (27, N) neighbour map directly and gathers rows (see gather_gemm.cuh for
// the bound and the design). Missing neighbours point at row N-1 and are
// skipped, so padding rows need not be zero.
//
// The level's row order (ops/conv3.py:row_order), which kernel 1 and 4's
// dx walk: row_order_keys packs each row's 27-bit neighbour mask (one
// thread a row, reading the map's 27 rows coalesced; no (27, N)
// temporary), PyTorch's stable sort orders the rows by it, and
// row_order_tally counts, per 32-row group of the sorted keys, the
// offsets some row of the group has (the steps a group of the ring body
// computes) and the valid pairs.
#include "gather_gemm.cuh"

namespace {

constexpr int kKeyThreads = 256;

__global__ void row_order_keys_kernel(const int* __restrict__ nbr, int n,
                                      int* __restrict__ keys) {
  const int i = blockIdx.x * kKeyThreads + threadIdx.x;
  if (i >= n) return;
  int key = 0;
  for (int k = 0; k < 27; ++k)
    key |= (nbr[(size_t)k * n + i] != n - 1) << k;
  keys[i] = key;
}

// tally[g] = the offsets of 32-row group g (popc of its keys' OR), tally[
// groups + g] = its valid pairs (the sum of its keys' popc).
__global__ void row_order_tally_kernel(const int* __restrict__ keys, int n,
                                       int groups, int* __restrict__ tally) {
  const int g = blockIdx.x * kKeyThreads + threadIdx.x;
  if (g >= groups) return;
  const int end = 32 * g + 32 < n ? 32 * g + 32 : n;
  int any = 0;
  int pairs = 0;
  for (int r = 32 * g; r < end; ++r) {
    any |= keys[r];
    pairs += __popc(keys[r]);
  }
  tally[g] = __popc(any);
  tally[groups + g] = pairs;
}

}  // namespace

// order / keys: the (N,) int32 row order of nbr and its rows' neighbour
// masks in that order, or both NULL (the rows in their own order).
extern "C" int conv3_fwd(const void* x, const void* w, const void* nbr,
                         const void* order, const void* keys,
                         const void* valid, const void* scale,
                         const void* shift, const void* residual, void* out,
                         int n, int cin, int cout, int relu, int is_bf16,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return us3d::launch_gather_gemm<__nv_bfloat16>(
        x, w, nbr, order, keys, valid, scale, shift, residual, out, 27, n,
        n - 1, cin, cout, relu, st);
  return us3d::launch_gather_gemm<float>(x, w, nbr, order, keys, valid, scale,
                                         shift, residual, out, 27, n, n - 1,
                                         cin, cout, relu, st);
}

// nbr (27, N) int32 -> keys (N,) int32.
extern "C" int row_order_keys(const void* nbr, void* keys, int n,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + kKeyThreads - 1) / kKeyThreads);
  row_order_keys_kernel<<<blocks, kKeyThreads, 0, st>>>(
      static_cast<const int*>(nbr), n, static_cast<int*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// sorted keys (N,) int32 -> tally (2, groups) int32, groups = ceil(N / 32).
extern "C" int row_order_tally(const void* keys, void* tally, int n,
                               int groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      (unsigned)((groups + kKeyThreads - 1) / kKeyThreads);
  row_order_tally_kernel<<<blocks, kKeyThreads, 0, st>>>(
      static_cast<const int*>(keys), n, groups, static_cast<int*>(tally));
  return static_cast<int>(cudaGetLastError());
}
