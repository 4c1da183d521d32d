// Checks of the emulation itself, compiled into the emulated kernel library
// by tests/test_torch_kernels_emulated.py. One warp loads a WMMA fragment
// from shared memory `offset` bf16 values past a 128-byte aligned tile and
// multiplies it by a fragment of ones: the card needs a 32-byte aligned
// fragment pointer, and the shim reports any other through cudaGetLastError.
// A column-major matrix_a fragment reads its tile transposed. __ballot_sync
// gathers each lane's predicate into its bit. __shfl_sync reads another
// lane's value (within segments of `width` lanes), __shfl_xor_sync the value
// of the lane whose index differs by the mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

__global__ void wmma_load_kernel(int offset, float* out) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 tile[64 * 16];
  for (int i = threadIdx.x; i < 64 * 16; i += 32)
    tile[i] = __float2bfloat16(1.f);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
  wmma::fill_fragment(c, 0.f);
  wmma::load_matrix_sync(a, tile + offset, 16);
  wmma::load_matrix_sync(b, tile, 16);
  wmma::mma_sync(c, a, b, c);
  wmma::store_matrix_sync(out, c, 16, wmma::mem_row_major);
}

// A (16 x 16) read column-major from tile[16 * 16] (A[m][k] = tile[k * 16 +
// m]) times the identity: out = tile^T.
__global__ void wmma_col_major_kernel(const float* tile, float* out) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 a_s[16 * 16];
  __shared__ __align__(128) __nv_bfloat16 eye[16 * 16];
  for (int i = threadIdx.x; i < 16 * 16; i += 32) {
    a_s[i] = __float2bfloat16(tile[i]);
    eye[i] = __float2bfloat16(i / 16 == i % 16 ? 1.f : 0.f);
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
  wmma::fill_fragment(c, 0.f);
  wmma::load_matrix_sync(a, a_s, 16);
  wmma::load_matrix_sync(b, eye, 16);
  wmma::mma_sync(c, a, b, c);
  wmma::store_matrix_sync(out, c, 16, wmma::mem_row_major);
}

// Each thread: its rank among the lanes of its warp whose predicate holds,
// and the warp's count of them.
__global__ void ballot_kernel(const int* pred, int* rank, int* count) {
  const int t = threadIdx.x;
  const unsigned lane = t % 32;
  const unsigned votes = __ballot_sync(0xffffffffu, pred[t]);
  rank[t] = __popc(votes & ((1u << lane) - 1u));
  count[t] = __popc(votes);
}

// Per lane t of a warp: out[3t] = in[(t + 5) % 32] (an int from lane t + 5),
// out[3t + 1] = in[t & ~7 | (t + 3) & 7] (width 8), out[3t + 2] = the sum of
// the warp's values as floats by an xor butterfly (the same in every lane).
__global__ void shuffle_kernel(const int* in, float* out) {
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int v = in[t];
  out[3 * t] = (float)__shfl_sync(0xffffffffu, v, (lane + 5) % 32);
  out[3 * t + 1] = (float)__shfl_sync(0xffffffffu, v, lane + 3, 8);
  float s = (float)v;
  for (int off = 16; off >= 1; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  out[3 * t + 2] = s;
}

}  // namespace

// out (16, 16) f32; returns the launch's cudaGetLastError().
extern "C" int emu_wmma_at(int offset, void* out) {
  wmma_load_kernel<<<1, 32, 0, nullptr>>>(offset, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// tile, out (16, 16) f32 (tile's values exact in bf16).
extern "C" int emu_wmma_col_major(const void* tile, void* out) {
  wmma_col_major_kernel<<<1, 32, 0, nullptr>>>(
      static_cast<const float*>(tile), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// pred, rank, count (threads,) int32, threads a multiple of 32 or not.
extern "C" int emu_ballot(const void* pred, void* rank, void* count,
                          int threads) {
  ballot_kernel<<<1, threads, 0, nullptr>>>(static_cast<const int*>(pred),
                                            static_cast<int*>(rank),
                                            static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// in (threads,) int32, out (threads, 3) f32; threads a multiple of 32.
extern "C" int emu_shfl(const void* in, void* out, int threads) {
  shuffle_kernel<<<1, threads, 0, nullptr>>>(static_cast<const int*>(in),
                                             static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
