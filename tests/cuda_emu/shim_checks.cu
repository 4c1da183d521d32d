// A check of the emulation itself, compiled into the emulated kernel library
// by tests/test_torch_kernels_emulated.py: one warp loads a WMMA fragment
// from shared memory `offset` bf16 values past a 128-byte aligned tile and
// multiplies it by a fragment of ones. The card needs a 32-byte aligned
// fragment pointer; the shim reports any other through cudaGetLastError.
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

}  // namespace

// out (16, 16) f32; returns the launch's cudaGetLastError().
extern "C" int emu_wmma_at(int offset, void* out) {
  wmma_load_kernel<<<1, 32, 0, nullptr>>>(offset, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
