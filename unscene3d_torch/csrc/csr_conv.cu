// Kernel 6: k3 submanifold sparse conv over compacted valid pairs.
//
// Replaces unscene3d_tpu/ops/csr_conv.py:csr_conv3_fwd (Pallas kernel
// `_kernel`). The same function as kernel 1 (conv3.cu), from pair tables
// instead of the (27, N) neighbour map:
//
//   out[i] = valid[i] * epi( x[i] @ w[13]
//                            + sum_{k != 13, (j, i) in pairs_k} x[j] @ w[k] )
//
// The pairs (pair_in = j, pair_out = i) hold only the neighbours that exist,
// sorted by (offset, out row); tile_start[ki * tiles + t] is where the pairs
// of offset ki and out rows [64 t, 64 t + 64) begin, and the next entry is
// where they end (the array is flat). The TPU kernel read fixed two-block
// windows of a bucketed pair axis and selected rows with a one-hot matmul;
// here the ranges are ragged and exact, and x's padding rows are never read.
//
// Bound on the H100: the gather of the paired rows (about 7.6 per valid row
// at level 0 of a 2 cm scene, of 26 offsets). What compaction buys over
// kernel 1 is the product: kernel 1 multiplies a full row tile per offset
// that any row of the tile has, this kernel only the packed pairs. One
// 256-thread block owns TM out rows x TN channels and keeps their f32
// accumulators in registers (thread t: column t % TN, every (256 / TN)-th
// row). Per offset it reads the tile's pair range (an empty one costs
// nothing more), stages the pairs' x rows packed into shared memory (padded
// with zero rows to the product's row step, never reading past the range),
// multiplies the packed rows by w[k] (f32 FMA with a 4x4 register tile;
// bf16 WMMA 16x16x16 with f32 accumulation, only the 16-row fragments that
// hold pairs) and writes the packed product to shared memory; each thread
// then adds, for each of its rows that has a pair, the product row of that
// pair (slot[row]). The centre offset (13) runs in its turn through the
// same code with the identity pairing. Rows are unique within an offset and
// offsets go in order: a fixed summation order, no atomics, two runs bitwise
// equal.
#include "gather_gemm.cuh"

namespace {

using namespace us3d;

constexpr int kTile = 64;   // out rows per tile_start entry

// Block-uniform. Stage offset k for the block's TM rows from row0: the
// centre (13) pairs every row of the tile with itself, another offset reads
// its pair range (table index k - (k > 13)). Fills pin[p] (x row of packed
// pair p) and slot[r] (packed pair of tile row r, or -1) and returns the
// number of pairs; 0 without touching shared memory or a barrier when there
// is none.
template <int TM>
__device__ __forceinline__ int stage_pairs(int k,
                                           const int* __restrict__ pair_in,
                                           const int* __restrict__ pair_out,
                                           const int* __restrict__ tile_start,
                                           int tiles, int row0, int n,
                                           int* pin, int* slot) {
  const int tid = threadIdx.x;
  int lo = 0;
  int m;
  const bool centre = k == 13;
  if (centre) {
    m = n - row0 < TM ? n - row0 : TM;
  } else {
    const int t0 = row0 / kTile;
    const int t1 = t0 + TM / kTile < tiles ? t0 + TM / kTile : tiles;
    const int* ts = tile_start + (size_t)(k - (k > 13 ? 1 : 0)) * tiles;
    lo = ts[t0];
    m = ts[t1] - lo;
  }
  if (m == 0) return 0;
  for (int r = tid; r < TM; r += kThreads) {
    slot[r] = (centre && r < m) ? r : -1;
    if (centre && r < m) pin[r] = row0 + r;
  }
  __syncthreads();
  if (!centre)
    for (int p = tid; p < m; p += kThreads) {
      pin[p] = pair_in[lo + p];
      slot[pair_out[lo + p] - row0] = p;
    }
  __syncthreads();
  return m;
}

// f32 on the CUDA cores: TN channels x TM = 4096 / TN rows per block.
template <typename T, int TN>
__global__ void __launch_bounds__(kThreads)
csr_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ pair_in,
                const int* __restrict__ pair_out,
                const int* __restrict__ tile_start,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ scale,
                const float* __restrict__ shift,
                const T* __restrict__ residual, T* __restrict__ out, int n,
                int tiles, int cin, int cout, int relu) {
  constexpr int TM = 4096 / TN;
  constexpr int TX = TN / 4;          // threads across product columns
  constexpr int TY = kThreads / TX;   // threads across packed rows
  constexpr int RS = kThreads / TN;   // row step of a thread's accumulators
  constexpr int NA = TM / RS;         // accumulators per thread
  __shared__ float As[kTK][TM + 1];   // packed x rows, transposed
  __shared__ float Bs[kTK][TN];
  __shared__ float Ps[TM][TN];        // packed product rows
  __shared__ int pin[TM];
  __shared__ int slot[TM];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int col = tid % TN;
  const int rbase = tid / TN;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;

  float acc[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) acc[j] = 0.f;

  for (int k = 0; k < 27; ++k) {
    const int m = stage_pairs<TM>(k, pair_in, pair_out, tile_start, tiles,
                                  row0, n, pin, slot);
    if (m == 0) continue;
    const int m_up = (m + TY - 1) / TY * TY;   // <= TM: TY divides TM
    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[r][c] = 0.f;
    for (int c0 = 0; c0 < cin; c0 += kTK) {
      for (int e = tid; e < m_up * kTK; e += kThreads) {
        const int pr = e / kTK;
        const int kk = e % kTK;
        const int c = c0 + kk;
        As[kk][pr] = (pr < m && c < cin)
                         ? to_f32(x[(size_t)pin[pr] * cin + c]) : 0.f;
      }
      stage_weights_f32<TN>(Bs, w, k, c0, col0, cin, cout);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kTK; ++kk) {
        float b[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + TX * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (TY * r >= m) continue;   // block-uniform: no pair that far
          const float a = As[kk][ty + TY * r];
#pragma unroll
          for (int c = 0; c < 4; ++c) p[r][c] = fmaf(a, b[c], p[r][c]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (TY * r >= m) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[ty + TY * r][tx + TX * c] = p[r][c];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int s = slot[rbase + RS * j];
      if (s >= 0) acc[j] += Ps[s][col];
    }
    __syncthreads();
  }

  const int co = col0 + col;
  if (co >= cout) return;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const int i = row0 + rbase + RS * j;
    if (i >= n) continue;
    epilogue_store(acc[j], valid[i] ? 1.f : 0.f, (size_t)i * cout + co, co,
                   scale, shift, residual, out, relu);
  }
}

// bf16 on the tensor cores: 128 rows x 64 channels per block. Warp w owns
// column fragment w % 4 and the packed row fragments w / 4, w / 4 + 2, ...:
// interleaved, so the fragments that hold pairs spread over all warps.
template <typename T>   // T = __nv_bfloat16 (a template: one copy per .so)
__global__ void __launch_bounds__(kThreads)
csr_conv_tc_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const int* __restrict__ pair_in,
                   const int* __restrict__ pair_out,
                   const int* __restrict__ tile_start,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const T* __restrict__ residual, T* __restrict__ out, int n,
                   int tiles, int cin, int cout, int relu) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 only");
  using namespace nvcuda;
  constexpr int RS = kThreads / kTcN;   // 4
  constexpr int NA = kTcM / RS;         // 32 accumulators per thread
  // the packed product tile reuses the A/B staging after each offset's
  // products
  __shared__ __align__(128) unsigned char smem[kTcBytes];
  __shared__ int pin[kTcM];
  __shared__ int slot[kTcM];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + kTcABytes);
  float* Ps = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int cf = warp % 4;    // column fragment
  const int rf0 = warp / 4;   // first row fragment; then every second one
  const int col = tid % kTcN;
  const int rbase = tid / kTcN;
  const int row0 = blockIdx.x * kTcM;
  const int col0 = blockIdx.y * kTcN;
  const T zero = __float2bfloat16(0.f);

  float acc[NA];
#pragma unroll
  for (int j = 0; j < NA; ++j) acc[j] = 0.f;

  for (int k = 0; k < 27; ++k) {
    const int m = stage_pairs<kTcM>(k, pair_in, pair_out, tile_start, tiles,
                                    row0, n, pin, slot);
    if (m == 0) continue;
    const int m16 = (m + 15) / 16 * 16;   // <= kTcM
    AccFragment frag[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wmma::fill_fragment(frag[i], 0.f);
    for (int c0 = 0; c0 < cin; c0 += kTcK) {
      for (int e = tid; e < m16 * kTcK; e += kThreads) {
        const int pr = e / kTcK;
        const int kk = e % kTcK;
        const int c = c0 + kk;
        As[pr * kTcLdA + kk] = (pr < m && c < cin)
                                   ? x[(size_t)pin[pr] * cin + c] : zero;
      }
      stage_weights_tc(Bs, w, k, c0, col0, cin, cout);
      __syncthreads();
      if (rf0 * 16 < m) {   // warp-uniform
#pragma unroll
        for (int ks = 0; ks < kTcK; ks += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
          wmma::load_matrix_sync(b, Bs + ks * kTcLdB + cf * 16, kTcLdB);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rf = rf0 + 2 * i;
            if (rf * 16 >= m) continue;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
            wmma::load_matrix_sync(a, As + rf * 16 * kTcLdA + ks, kTcLdA);
            wmma::mma_sync(frag[i], a, b, frag[i]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rf = rf0 + 2 * i;
      if (rf * 16 >= m) continue;
      wmma::store_matrix_sync(Ps + rf * 16 * kTcLdC + cf * 16, frag[i],
                              kTcLdC, wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int s = slot[rbase + RS * j];
      if (s >= 0) acc[j] += Ps[s * kTcLdC + col];
    }
    __syncthreads();
  }

  const int co = col0 + col;
  if (co >= cout) return;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    const int i = row0 + rbase + RS * j;
    if (i >= n) continue;
    epilogue_store(acc[j], valid[i] ? 1.f : 0.f, (size_t)i * cout + co, co,
                   scale, shift, residual, out, relu);
  }
}

}  // namespace

// x (N, Cin), w (27, Cin, Cout), pair_in / pair_out (P,) int32, tile_start
// (26 * ceil(N / 64) + 1,) int32, valid (N,) bool, scale / shift (Cout,) f32
// or NULL, residual (N, Cout) or NULL, out (N, Cout).
extern "C" int csr_conv3_fwd(const void* x, const void* w,
                             const void* pair_in, const void* pair_out,
                             const void* tile_start, const void* valid,
                             const void* scale, const void* shift,
                             const void* residual, void* out, int n, int cin,
                             int cout, int relu, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  const int* pi = static_cast<const int*>(pair_in);
  const int* po = static_cast<const int*>(pair_out);
  const int* ts = static_cast<const int*>(tile_start);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  if (is_bf16) {
    using T = __nv_bfloat16;
    dim3 grid((n + kTcM - 1) / kTcM, (cout + kTcN - 1) / kTcN);
    csr_conv_tc_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), pi, po, ts, vp,
        sp, hp, static_cast<const T*>(residual), static_cast<T*>(out), n,
        tiles, cin, cout, relu);
  } else if (cout % 64 == 0) {
    dim3 grid((n + 63) / 64, cout / 64);
    csr_conv_kernel<float, 64><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), pi, po,
        ts, vp, sp, hp, static_cast<const float*>(residual),
        static_cast<float*>(out), n, tiles, cin, cout, relu);
  } else {
    dim3 grid((n + 127) / 128, (cout + 31) / 32);
    csr_conv_kernel<float, 32><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), pi, po,
        ts, vp, sp, hp, static_cast<const float*>(residual),
        static_cast<float*>(out), n, tiles, cin, cout, relu);
  }
  return static_cast<int>(cudaGetLastError());
}
