// Kernel 3: deterministic segment sum, (N, C) -> (S, C), f32 accumulation.
//
// Replaces unscene3d_tpu/ops/segment_pool.py:tile_segment_sum (Pallas kernel
// `_kernel`), which accumulated onehot(ids)^T @ x tiles into a VMEM-resident
// output across a sequential grid -- bitwise deterministic. Hopper blocks run
// in no order, so float atomics would break that. Instead the host collate
// (data/collate.py) gives a stable row order sorted by segment, and cuts
// each segment's run of that order into pieces of at most R rows (static
// per batch, ops/segment_pool.py:segment_pieces); invalid rows and ids
// outside [0, S) are absent from the order. The kernel reads the order as
// row indices only, so a row may appear in several segments' runs: the
// tri-plane projection (ops/triplane.py) walks an order that holds every
// voxel once per plane.
//
// Bound on the H100: one read of every valid row (204,800 x 128 bf16 = 52
// MB on the bench scene) plus the order table; the work is adds only.
// Segments are very uneven (on the bench scene the largest holds 5,310 of
// 199,697 rows, the median 304), so the pieces, not the segments, spread
// the rows over the card:
//  - pass 1 (piece_sum_kernel): one block of 4 warps per piece, warp w
//    over the piece's 32-row tiles w, w + 4, ... A warp takes a tile's 32
//    entries of the order with one coalesced load (its next tile's load
//    while this tile's rows do) and shuffles each row index to its group
//    of G lanes (row_gather.cuh: 16-byte lanes along the channels); a lane
//    issues up to 32 (f32) or 8 (bf16) row loads before it adds any, so a
//    tile's rows are in flight together. Each lane sums its rows in order,
//    the 32 / G row slots are added by a fixed shuffle tree, the 4 warps'
//    sums in warp order through shared memory, and the piece's f32 partial
//    goes to a scratch (P, C) that the wrapper allocates;
//  - pass 2 (piece_combine_kernel): each segment's partials added in piece
//    order and rounded once to x's dtype; an empty segment gives 0.
// Every sum has a fixed order: bitwise deterministic, no atomics.
#include "gather_gemm.cuh"
#include "row_gather.cuh"

namespace {

constexpr int kPieceWarps = 4;      // warps per block, one block a piece
constexpr int kMaxPassWidth = 256;  // f32 sums of one column pass: G * VEC
constexpr int kCombineThreads = 128;

template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kPieceWarps * 32)
    piece_sum_kernel(const T* __restrict__ x, const int* __restrict__ order,
                     const int* __restrict__ bounds,
                     float* __restrict__ partial, int c) {
  constexpr int kRowsPerPass = 32 / G;
  // row loads a lane issues before adding any: up to 32 in f32, 8 in bf16
  // (whose packs widen to f32 in registers; 16 took 206 registers and ran
  // slower, PERF.md)
  constexpr int kMaxAtOnce = sizeof(T) == 2 ? 8 : 32;
  constexpr int kAtOnce = G < kMaxAtOnce ? G : kMaxAtOnce;
  static_assert(G * VEC <= kMaxPassWidth, "a column pass too wide");
  __shared__ float warp_sums[kPieceWarps][kMaxPassWidth];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int p = blockIdx.x;
  const int beg = bounds[p];
  const int end = bounds[p + 1];
  const int blocks = c / VEC;
  const int slot = lane / G;
  for (int b0 = 0; b0 < blocks; b0 += G) {  // one pass per G column blocks
    const int b = b0 + lane % G;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    // warp w takes the piece's 32-row tiles w, w + 4, ...
    const int first = beg + 32 * warp;
    int held = first + lane < end ? order[first + lane] : -1;
    for (int j0 = first; j0 < end; j0 += 32 * kPieceWarps) {
      // the warp's next 32 entries of the order, while this tile's rows load
      const int j1 = j0 + 32 * kPieceWarps;
      const int next = j1 + lane < end ? order[j1 + lane] : -1;
#pragma unroll
      for (int q = 0; q < G; q += kAtOnce) {
        int row[kAtOnce];
#pragma unroll
        for (int u = 0; u < kAtOnce; ++u)
          row[u] = __shfl_sync(~0u, held, (q + u) * kRowsPerPass + slot);
        us3d::RowPack<T, VEC> v[kAtOnce];
#pragma unroll
        for (int u = 0; u < kAtOnce; ++u)
          if (row[u] >= 0 && b < blocks)
            v[u] = us3d::load_pack<T, VEC>(x + (size_t)row[u] * c + b * VEC);
#pragma unroll
        for (int u = 0; u < kAtOnce; ++u)
          if (row[u] >= 0 && b < blocks) us3d::add_pack(acc, v[u]);
      }
      held = next;
    }
#pragma unroll
    for (int off = 16; off >= G; off /= 2)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] += __shfl_xor_sync(~0u, acc[e], off);
    if (slot == 0)
#pragma unroll
      for (int e = 0; e < VEC; ++e) warp_sums[warp][lane * VEC + e] = acc[e];
    __syncthreads();
    // the warps' sums in warp order: the piece's partial for this pass
    for (int i = threadIdx.x; i < G * VEC && b0 * VEC + i < c;
         i += kPieceWarps * 32) {
      float t = warp_sums[0][i];
#pragma unroll
      for (int w = 1; w < kPieceWarps; ++w) t += warp_sums[w][i];
      partial[(size_t)p * c + b0 * VEC + i] = t;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    piece_combine_kernel(const float* __restrict__ partial,
                         const int* __restrict__ first, T* __restrict__ out,
                         int c) {
  const int s = blockIdx.x;
  const int ch = blockIdx.y * kCombineThreads + threadIdx.x;
  if (ch >= c) return;
  float acc = 0.f;
  for (int q = first[s]; q < first[s + 1]; ++q)
    acc += partial[(size_t)q * c + ch];
  out[(size_t)s * c + ch] = us3d::from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, const int* order, const int* pieces, float* partial,
           void* out, int num_segments, int num_pieces, int c,
           cudaStream_t st) {
  const int* first = pieces;                     // (S + 1,)
  const int* bounds = pieces + num_segments + 1;  // (P + 1,)
  if (num_pieces > 0) {
    // the partials are f32, so their 16-byte path needs only x aligned
    const int vec = us3d::row_vec<T>(c, x, partial);
    const int g = us3d::lanes_per_row(c / vec);
    const int code =
        us3d::with_row_layout<T>(vec, g, [&](auto v, auto lanes) {
          constexpr int kVec = decltype(v)::value;
          constexpr int kG = decltype(lanes)::value;
          piece_sum_kernel<T, kVec, kG><<<num_pieces, kPieceWarps * 32, 0,
                                          st>>>(
              static_cast<const T*>(x), order, bounds, partial, c);
          return static_cast<int>(cudaGetLastError());
        });
    if (code != 0) return code;
  }
  dim3 grid(num_segments, (c + kCombineThreads - 1) / kCombineThreads);
  piece_combine_kernel<T><<<grid, kCombineThreads, 0, st>>>(
      partial, first, static_cast<T*>(out), c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pieces: segment_pieces(offsets) as int32, (S + 1) piece starts per segment
// then (P + 1) piece bounds in the order; partial: (P, c) f32 scratch.
extern "C" int segment_sum(const void* x, const void* order,
                           const void* pieces, void* partial, void* out,
                           int num_segments, int num_pieces, int c,
                           int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(order);
  const int* pc = static_cast<const int*>(pieces);
  float* part = static_cast<float*>(partial);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, o, pc, part, out, num_segments,
                                 num_pieces, c, st);
  return launch<float>(x, o, pc, part, out, num_segments, num_pieces, c, st);
}
