// Kernel 6: k3 submanifold sparse conv over compacted valid pairs.
//
// Replaces unscene3d_tpu/ops/csr_conv.py:csr_conv3_fwd (Pallas kernel
// `_kernel`, :150, pallas_call :295). The same function as kernel 1
// (conv3.cu), from pair tables instead of the (27, N) neighbour map:
//
//   out[i] = valid[i] * epi( x[i] @ w[13]
//                            + sum_{k != 13, (j, i) in pairs_k} x[j] @ w[k] )
//
// The pairs (pair_in = j, pair_out = i) hold only the neighbours that exist,
// sorted by (offset, out row); tile_start[ki * tiles + t] is where the pairs
// of offset ki and out rows [64 t, 64 t + 64) begin, and the next entry is
// where they end (the array is flat). x's padding rows are read only by the
// centre offset of padding rows, whose outputs the mask clears.
//
// bf16 (csr_conv_ring_kernel): bound on the H100 by the gather of the
// paired rows, 0.043 ms by bytes at level 0 of the bench scene (about 7.6
// pairs per valid row, of 26 offsets), so the body is kernel 1's: a
// 256-thread block owns 128 out rows x all of Cout up to 128 and runs the
// shared ring main loop (gather_gemm.cuh:ring_main_loop: 16-byte cp.async
// rows into a 3-stage ring, one barrier per live (offset, 32-channel
// chunk) step, warps skipping a step whose 32 rows have no pair). Only the
// prologue is its own: it reads each off-centre offset's pair range in
// the block (two 64-row tile_start entries), writes each pair's in row at
// its out row of the block's (27, 128) row table (every other entry stays
// "none", staged as a zero row) and marks the pair's 32-row group live at
// the first pair of each group; the centre is the identity for the rows
// below n. It never reads the neighbour map, and an empty range leaves the
// offset dead at no further cost. On Hopper compaction buys only that
// cheaper prologue: kernel 1 already skips missing rows and offsets, and
// multiplying packed pairs would cost a scatter of the products through
// shared memory, with its own barriers. The TPU kernel's one-hot row select,
// per-offset buckets with dummy tails and two-block read windows were for
// static shapes under Mosaic and have no counterpart. On valid rows the
// result is bitwise kernel 1's on the same level.
//
// f32 (csr_conv_kernel): one 256-thread block owns TM out rows x TN
// channels with f32 accumulators in registers (thread t: column t % TN,
// every (256 / TN)-th row). Per offset it reads the tile's pair range,
// stages the pairs' x rows packed into shared memory (padded with zero rows
// to the product's row step), multiplies them by w[k] with a 4x4 register
// tile per thread and writes the packed product to shared memory; each
// thread then adds, for each of its rows that has a pair, the product row
// of that pair (slot[row]).
//
// Both bodies take the offsets in order 0..26, the centre in its turn, and
// each row at most once per offset: a fixed summation order, no atomics,
// two runs bitwise equal.
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

constexpr int kNone = -1;   // a row table entry with no pair

// bf16: kernel 1's ring tile and main loop behind a prologue that reads the
// pair tables (see the top).
template <int NC>
__global__ void __launch_bounds__(kThreads)
csr_conv_ring_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const int* __restrict__ pair_in,
                     const int* __restrict__ pair_out,
                     const int* __restrict__ tile_start,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     const __nv_bfloat16* __restrict__ residual,
                     __nv_bfloat16* __restrict__ out, int n, int tiles,
                     int cin, int cout, int relu) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int sidx[27 * kRingM];          // (27, 128) x rows
  __shared__ int group_live[27 * kRingGroups];
  __shared__ int range[2 * 26];   // [lo, hi) of each off-centre offset
  __shared__ int live_k[27];
  __shared__ int live_g[27];
  __shared__ int n_live_s;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRingM;
  const int col0 = blockIdx.y * NC;
  const int rows = n - row0 < kRingM ? n - row0 : kRingM;

  for (int e = tid; e < 27 * kRingM; e += kThreads) {
    const int r = e % kRingM;
    sidx[e] = e / kRingM == 13 && r < rows ? row0 + r : kNone;
  }
  if (tid < 27 * kRingGroups)   // (offset, group) = (tid / 4, tid % 4)
    group_live[tid] =
        tid / kRingGroups == 13 && 32 * (tid % kRingGroups) < rows;
  if (tid < 2 * 26) {   // the block's two 64-row tile_start entries
    const int t0 = row0 / kTile;
    const int t1 = t0 + kRingM / kTile < tiles ? t0 + kRingM / kTile : tiles;
    range[tid] = tile_start[(size_t)(tid / 2) * tiles + (tid % 2 ? t1 : t0)];
  }
  __syncthreads();
  // slot j of offset ki: its pair lo + j, if any; unrolled, so that every
  // thread's loads are in flight together
  static_assert(26 * kRingM % kThreads == 0, "whole rounds");
#pragma unroll
  for (int i = 0; i < 26 * kRingM / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int ki = e / kRingM;
    const int lo = range[2 * ki];
    const int p = lo + e % kRingM;
    if (p >= range[2 * ki + 1]) continue;
    const int k = ki + (ki >= 13 ? 1 : 0);
    const int r = pair_out[p] - row0;
    sidx[k * kRingM + r] = pair_in[p];
    // out rows ascend within the range: the group's first pair marks it
    if (p == lo || (pair_out[p - 1] - row0) / 32 != r / 32)
      group_live[k * kRingGroups + r / 32] = 1;
  }
  __syncthreads();
  if (tid == 0) ring_live_lists(group_live, 27, live_k, live_g, &n_live_s);
  __syncthreads();
  ring_main_loop<NC>(smem, x, w, sidx, live_k, live_g, n_live_s, valid,
                     scale, shift, residual, out, n, kNone, cin, cout, relu,
                     row0, col0);
}

template <int NC>
int launch_csr_ring(const __nv_bfloat16* x, const __nv_bfloat16* w,
                    const int* pair_in, const int* pair_out,
                    const int* tile_start, const uint8_t* valid,
                    const float* scale, const float* shift,
                    const __nv_bfloat16* residual, __nv_bfloat16* out, int n,
                    int tiles, int cin, int cout, int relu,
                    cudaStream_t stream) {
  constexpr int kBytes = RingTile<NC>::kSmemBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      csr_conv_ring_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((n + kRingM - 1) / kRingM, (cout + NC - 1) / NC);
  csr_conv_ring_kernel<NC><<<grid, kThreads, kBytes, stream>>>(
      x, w, pair_in, pair_out, tile_start, valid, scale, shift, residual, out,
      n, tiles, cin, cout, relu);
  return static_cast<int>(cudaGetLastError());
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
    const T* xp = static_cast<const T*>(x);
    const T* wp = static_cast<const T*>(w);
    const T* rp = static_cast<const T*>(residual);
    T* op = static_cast<T*>(out);
    if (cout <= 32)
      return launch_csr_ring<32>(xp, wp, pi, po, ts, vp, sp, hp, rp, op, n,
                                 tiles, cin, cout, relu, st);
    if (cout <= 64)
      return launch_csr_ring<64>(xp, wp, pi, po, ts, vp, sp, hp, rp, op, n,
                                 tiles, cin, cout, relu, st);
    if (cout <= 96)
      return launch_csr_ring<96>(xp, wp, pi, po, ts, vp, sp, hp, rp, op, n,
                                 tiles, cin, cout, relu, st);
    return launch_csr_ring<128>(xp, wp, pi, po, ts, vp, sp, hp, rp, op, n,
                                tiles, cin, cout, relu, st);
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
