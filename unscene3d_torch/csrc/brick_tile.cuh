// Slab tiles of the dense brick shift-GEMM conv, shared by kernel 7
// (brick_conv.cu) and kernel 8 (proto_brick.cu).
//
// A brick is a (1008, C) slab of 10^3 halo'd cells (flat cell id x * 100 +
// y * 10 + z, padded to 1008 rows); k3 offset k is a shift by d_k = 100 dx +
// 10 dy + dz of the flat cell axis, and window rows [111, 895) cover every
// interior cell. One block computes, for one brick and one 112-row tile of
// the 784 window rows (784 = 7 * 112: no tile is ragged),
//
//   out[b, 111 + r] = m[b, 111 + r]
//                     ? epi( sum_{k<27} g[b, 111 + d_k + r] @ w[k] ) : 0
//
// over all of Cout (up to 128 columns; wider Cout takes more column tiles),
// with m the occupancy mask (asm_idx != sentinel) or 1 when asm_idx is NULL,
// and writes rows [0, 111) and [895, 1008) as zeros when it is the brick's
// first or last row tile. A masked row is an exact zero whatever the inputs
// hold (a NaN within reach of an empty cell stays out of it), as it is when
// the tile or strip holding it is skipped.
//
// Design for Hopper. Every offset of a tile at window row r0 reads brick rows
// [r0 + 111 + d_k, r0 + 223 + d_k): together the kUnion = 334 rows [r0, r0 +
// 334), which never pass row 1008. A block stages that union once per Cin
// chunk into shared memory and reads each offset's A operand at its shifted
// row (111 + d_k + strip) of the one buffer: 334 row loads per chunk where a
// per-offset tile would load 27 x 112. Staging is 16-byte cp.async
// (__pipeline_memcpy_async) when the rows allow it (Cin a multiple of 8 bf16
// / 4 f32 values and a 16-byte aligned base) and scalar loads otherwise (the
// stem's Cin 3), inside the same kernel. The pipeline over the steps (Cin
// chunk c outer, offset k inner; a step multiplies three offsets) keeps two
// weight buffers, so that step s+1's w[k][chunk, :] slices load while step
// s multiplies, and two union buffers, the next chunk's union arriving in 8
// slices of 42 rows beside the weights: one barrier per three offsets.
// Products: bf16 WMMA 16x16x16 with f32 accumulation (the union buffer's
// row stride of 48 bf16 keeps every shifted fragment 32-byte aligned; the
// warp layout is TcTile's), accumulators through shared memory to the
// epilogue; f32 FMA on 224 threads with a 4 x (NC / 8) register tile each
// (weights read as 16-byte column quads), no TF32. With an occupancy mask
// (kernel 7) a tile with no occupied cell writes its zeros and multiplies
// nothing, and a warp skips the products of its 16-row strips that hold no
// occupied row (warp-uniform; it still joins every barrier). Fixed
// summation order (Cin chunks in order, within a chunk the offsets in
// K3_DELTAS order, f32 accumulation), no atomics: two runs are bitwise
// equal.
//
// What bounds it: WMMA's bf16 fragment loads compile to generic 32-bit loads
// (LD.E) plus a MOVM transpose per weight fragment, not ldmatrix. wgmma, with
// A in registers through ldmatrix (a shifted view is no valid shared-memory
// descriptor start), and TMA staging need inline PTX, which the CPU
// emulation of the tests does not compile: later work.
#pragma once

#include "gather_gemm.cuh"

namespace us3d {

constexpr int kCells = 1008;    // rows per brick
constexpr int kWinLo = 111;     // first window row
constexpr int kWinN = 784;      // window rows
constexpr int kBrickTM = 112;   // window rows per block
constexpr int kRowTiles = kWinN / kBrickTM;
constexpr int kUnion = kBrickTM + 2 * kWinLo;   // 334 brick rows per tile
constexpr int kStrips = kBrickTM / 16;          // 16-row strips per tile
// a step multiplies kStepOffsets offsets of one Cin chunk (one barrier)
constexpr int kStepOffsets = 3;
constexpr int kChunkSteps = 27 / kStepOffsets;
// weight buffers of whole steps: step s+1's slices load while step s
// multiplies
constexpr int kWStages = 2;
// the next chunk's union arrives in slices over the first kSliceSteps steps
// of a chunk, so that the last slice lands before that chunk's first step
constexpr int kSliceSteps = kChunkSteps - (kWStages - 1);
constexpr int kSliceRows = (kUnion + kSliceSteps - 1) / kSliceSteps;
static_assert(kRowTiles * kBrickTM == kWinN, "no ragged row tile");
static_assert((kRowTiles - 1) * kBrickTM + kUnion <= kCells, "in the slab");

__device__ __forceinline__ int k3_delta(int k) {
  return (k / 9 - 1) * 100 + ((k / 3) % 3 - 1) * 10 + (k % 3 - 1);
}

// Stage rows [u0, u1) x channels [c0, c0 + K) of the tile's union (brick rows
// from `rows0`) into A (leading dimension LD); zero past Cin. `vec`: 16-byte
// asynchronous copies (Cin a multiple of 16 / sizeof(T), base aligned),
// else scalar loads.
template <typename T, int K, int LD, int NT>
__device__ __forceinline__ void stage_union(T* A, const T* __restrict__ g,
                                            size_t rows0, int u0, int u1,
                                            int c0, int cin, bool vec) {
  constexpr int kV = 16 / sizeof(T);   // values per 16-byte vector
  if (vec) {
    for (int e = threadIdx.x; e < (u1 - u0) * (K / kV); e += NT) {
      const int u = u0 + e / (K / kV);
      const int c = c0 + (e % (K / kV)) * kV;
      copy16(A + u * LD + c - c0, g + (rows0 + u) * cin + c, c < cin);
    }
  } else {
    for (int e = threadIdx.x; e < (u1 - u0) * K; e += NT) {
      const int u = u0 + e / K;
      const int c = c0 + e % K;
      A[u * LD + c - c0] =
          c < cin ? g[(rows0 + u) * cin + c] : from_f32<T>(0.f);
    }
  }
}

// Zero rows [lo, lo + rows) of the brick at `base`, columns [col0, col0 +
// NC) clipped to Cout.
template <typename T, int NC, int NT>
__device__ __forceinline__ void zero_rows(T* __restrict__ out, size_t base,
                                          int lo, int rows, int col0,
                                          int cout) {
  const T zero = from_f32<T>(0.f);
  for (int e = threadIdx.x; e < rows * NC; e += NT) {
    const int co = col0 + e % NC;
    if (co < cout) out[(base + lo + e / NC) * cout + co] = zero;
  }
}

// bf16 tile: NC = 16 * NF output columns, WMMA fragments. At 96 columns each
// of 6 warps owns one 16-wide fragment column over all 7 strips, so that the
// weight fragment, whose load transposes it (WMMA's row-major B), is loaded
// once for 7 products (measured on the card at 96 only); at 32, 64 and 128
// each of 7 warps owns one strip and all of its fragments. Warp w: strips
// [s0, s0 + kSW), fragments [f0, f0 + kFW).
template <int NC>
struct TcTile {
  using T = __nv_bfloat16;
  static constexpr int kNC = NC;
  static constexpr int kNF = NC / 16;
  static constexpr bool kColumns = NC == 96;
  static constexpr int kSW = kColumns ? kStrips : 1;   // strips per warp
  static constexpr int kFW = kColumns ? 1 : kNF;       // fragments per warp
  static constexpr int kThreads = 32 * (kStrips / kSW) * (kNF / kFW);
  static constexpr int kK = 32;             // Cin chunk
  static constexpr int kLdA = 48;           // 32-byte aligned shifted rows
  static constexpr int kLdB = NC + 8;
  static constexpr int kLdC = NC + 4;
  static constexpr int kABytes = kUnion * kLdA * 2;
  static constexpr int kBBytes = kK * kLdB * 2;
  static constexpr int kSmemBytes =
      2 * kABytes + kWStages * kStepOffsets * kBBytes;
  static_assert(kBrickTM * kLdC * 4 <= 2 * kABytes, "C tile reuses A");
  static_assert(kABytes % 32 == 0 && kBBytes % 32 == 0, "aligned buffers");

  struct Acc {
    AccFragment f[kSW][kFW];
  };

  static __device__ __forceinline__ int s0() {
    return kSW == 1 ? threadIdx.x / 32 : 0;
  }
  static __device__ __forceinline__ int f0() {
    return kSW == 1 ? 0 : kFW * (threadIdx.x / 32);
  }

  static __device__ __forceinline__ void init(Acc& acc) {
#pragma unroll
    for (int i = 0; i < kSW; ++i)
#pragma unroll
      for (int j = 0; j < kFW; ++j)
        nvcuda::wmma::fill_fragment(acc.f[i][j], 0.f);
  }

  // Bit i: the warp's strip s0 + i holds an occupied row (warp-uniform).
  static __device__ __forceinline__ unsigned live_strips(const int* row_occ) {
    unsigned live = 0;
    for (int i = 0; i < kSW; ++i)
      for (int r = 0; r < 16; ++r)
        if (row_occ[16 * (s0() + i) + r]) live |= 1u << i;
    return live;
  }

  static __device__ __forceinline__ void step(Acc& acc, const T* A,
                                              const T* B, int delta,
                                              unsigned live) {
    using namespace nvcuda;
    const T* a0 = A + (kWinLo + delta + 16 * s0()) * kLdA;
    const T* b0 = B + 16 * f0();
#pragma unroll
    for (int ks = 0; ks < kK; ks += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[kFW];
#pragma unroll
      for (int j = 0; j < kFW; ++j)
        wmma::load_matrix_sync(b[j], b0 + ks * kLdB + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < kSW; ++i) {
        if (!(live >> i & 1u)) continue;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, a0 + 16 * i * kLdA + ks, kLdA);
#pragma unroll
        for (int j = 0; j < kFW; ++j)
          wmma::mma_sync(acc.f[i][j], a, b[j], acc.f[i][j]);
      }
    }
  }

  // After the main loop's last barrier: accumulators -> the f32 tile in
  // shared memory (over the union buffers) -> the epilogue, coalesced along
  // channels.
  static __device__ __forceinline__ void store(
      Acc& acc, unsigned char* smem, const int* row_occ, size_t cell0,
      int col0, int cout, const float* __restrict__ scale,
      const float* __restrict__ shift, const T* __restrict__ residual,
      T* __restrict__ out, int relu) {
    float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < kSW; ++i)
#pragma unroll
      for (int j = 0; j < kFW; ++j)
        nvcuda::wmma::store_matrix_sync(
            Cs + 16 * (s0() + i) * kLdC + 16 * (f0() + j), acc.f[i][j], kLdC,
            nvcuda::wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < kBrickTM * NC; e += kThreads) {
      const int r = e / NC;
      const int co = col0 + e % NC;
      if (co >= cout) continue;
      const size_t off = (cell0 + r) * cout + co;
      if (row_occ[r])
        epilogue_store(Cs[r * kLdC + e % NC], 1.f, off, co, scale, shift,
                       residual, out, relu);
      else
        out[off] = from_f32<T>(0.f);
    }
  }
};

// f32 tile: NC output columns; thread (tx, ty) = (tid % 8, tid / 8) owns rows
// ty + 28 r (r < 4) and the column quads 4 tx + 32 q (q < NC / 32), so that
// a step reads each quad of weights as one 16-byte load.
template <int NC>
struct FmaTile {
  using T = float;
  static constexpr int kNC = NC;
  static constexpr int kK = 16;             // Cin chunk
  static constexpr int kLdA = 20;           // 16-byte rows, no bank conflict
  static constexpr int kLdB = NC;
  static constexpr int kCols = NC / 8;
  static_assert(NC % 32 == 0, "whole column quads");
  static constexpr int kThreads = 2 * kBrickTM;        // 224
  static constexpr int kRowStep = kThreads / 8;        // 28
  static constexpr int kABytes = kUnion * kLdA * 4;
  static constexpr int kBBytes = kK * kLdB * 4;
  static constexpr int kSmemBytes =
      2 * kABytes + kWStages * kStepOffsets * kBBytes;
  static_assert(4 * kRowStep == kBrickTM, "4 rows per thread");

  struct Acc {
    float v[4][kCols];
  };

  static __device__ __forceinline__ void init(Acc& acc) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc.v[r][c] = 0.f;
  }

  // Bit 0: one of the warp's rows (ty in [4 warp, 4 warp + 4), each + 28
  // r) is occupied (warp-uniform).
  static __device__ __forceinline__ unsigned live_strips(const int* row_occ) {
    const int ty0 = 4 * (threadIdx.x / 32);
    unsigned live = 0;
    for (int i = 0; i < 16; ++i)
      if (row_occ[ty0 + i % 4 + kRowStep * (i / 4)]) live = 1;
    return live;
  }

  static __device__ __forceinline__ void step(Acc& acc, const T* A,
                                              const T* B, int delta,
                                              unsigned) {
    const int tx = threadIdx.x % 8;
    const int ty = threadIdx.x / 8;
    const T* a0 = A + (kWinLo + delta + ty) * kLdA;
#pragma unroll 4
    for (int kk = 0; kk < kK; ++kk) {
      float a[4], b[kCols];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = a0[kRowStep * r * kLdA + kk];
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(B + kk * kLdB + 4 * tx + 32 * q);
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc.v[r][c] = fmaf(a[r], b[c], acc.v[r][c]);
    }
  }

  static __device__ __forceinline__ void store(
      Acc& acc, unsigned char*, const int* row_occ, size_t cell0, int col0,
      int cout, const float* __restrict__ scale,
      const float* __restrict__ shift, const T* __restrict__ residual,
      T* __restrict__ out, int relu) {
    const int tx = threadIdx.x % 8;
    const int ty = threadIdx.x / 8;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + kRowStep * r;
      const size_t cell = cell0 + row;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int co = col0 + 4 * tx + 32 * (c / 4) + c % 4;
        if (co >= cout) continue;
        if (row_occ[row])
          epilogue_store(acc.v[r][c], 1.f, cell * cout + co, co, scale, shift,
                         residual, out, relu);
        else
          out[cell * cout + co] = 0.f;
      }
    }
  }
};

// The body of kernels 7 and 8: one block per (brick, row tile, column
// tile), blockIdx.x = brick * kRowTiles + row tile, blockIdx.y = column tile;
// Tile::kThreads threads and Tile::kSmemBytes of dynamic shared memory.
template <class Tile>
__device__ __forceinline__ void brick_tile(
    const typename Tile::T* __restrict__ g,
    const typename Tile::T* __restrict__ w, const int* __restrict__ asm_idx,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const typename Tile::T* __restrict__ residual,
    typename Tile::T* __restrict__ out, int sentinel, int cin, int cout,
    int relu) {
  using T = typename Tile::T;
  constexpr int K = Tile::kK;
  constexpr int NT = Tile::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int row_occ[kBrickTM];
  // the two union buffers (by chunk parity), then the kWStages weight
  // buffers (by step), each the slices of kStepOffsets offsets
  auto abuf = [&](int c) {
    return reinterpret_cast<T*>(smem + (c & 1) * Tile::kABytes);
  };
  auto bbuf = [&](int s, int i) {
    return reinterpret_cast<T*>(
        smem + 2 * Tile::kABytes +
        ((s % kWStages) * kStepOffsets + i) * Tile::kBBytes);
  };

  const int row_tile = blockIdx.x % kRowTiles;
  const size_t base = (size_t)(blockIdx.x / kRowTiles) * kCells;
  const int r0 = row_tile * kBrickTM;
  const int col0 = blockIdx.y * Tile::kNC;
  const size_t cell0 = base + kWinLo + r0;   // the tile's first window cell

  int occ = 0;
  if (threadIdx.x < kBrickTM) {
    occ = asm_idx == nullptr || asm_idx[cell0 + threadIdx.x] != sentinel;
    row_occ[threadIdx.x] = occ;
  }
  if (row_tile == 0)
    zero_rows<T, Tile::kNC, NT>(out, base, 0, kWinLo, col0, cout);
  if (row_tile == kRowTiles - 1)
    zero_rows<T, Tile::kNC, NT>(out, base, kWinLo + kWinN,
                            kCells - kWinLo - kWinN, col0, cout);
  // block-uniform: a tile with no occupied cell is all zeros
  if (!__syncthreads_or(occ)) {
    zero_rows<T, Tile::kNC, NT>(out, base, kWinLo + r0, kBrickTM, col0, cout);
    return;
  }
  const unsigned live = Tile::live_strips(row_occ);
  const bool vec_a = cin % (16 / sizeof(T)) == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const bool vec_w = cout % (16 / sizeof(T)) == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const size_t rows0 = base + r0;   // brick row of union row 0
  const int chunks = (cin + K - 1) / K;
  const int steps = kChunkSteps * chunks;

  // one cp.async group per step: group j holds step j's weights (and group
  // 0 the first chunk's union); the group a step commits holds step s +
  // kWStages - 1's weights and a slice of the next chunk's union
  auto stage_step_weights = [&](int t) {
    if (t >= steps) return;
    for (int i = 0; i < kStepOffsets; ++i)
      stage_weights<T, K, Tile::kNC, Tile::kLdB, NT>(
          bbuf(t, i), w, kStepOffsets * (t % kChunkSteps) + i,
          t / kChunkSteps * K, col0, cin, cout, vec_w);
  };
  typename Tile::Acc acc;
  Tile::init(acc);
  stage_union<T, K, Tile::kLdA, NT>(abuf(0), g, rows0, 0, kUnion, 0, cin,
                                vec_a);
  for (int t = 0; t < kWStages - 1; ++t) {
    stage_step_weights(t);
    __pipeline_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int c = s / kChunkSteps;
    const int j = s - kChunkSteps * c;
    __pipeline_wait_prior(kWStages - 2);
    __syncthreads();   // step s's operands landed; step s-1's are free
    stage_step_weights(s + kWStages - 1);
    if (c + 1 < chunks && j < kSliceSteps) {   // slice j of the next union
      const int u0 = j * kSliceRows;
      const int u1 = u0 + kSliceRows < kUnion ? u0 + kSliceRows : kUnion;
      if (u0 < u1)
        stage_union<T, K, Tile::kLdA, NT>(abuf(c + 1), g, rows0, u0, u1,
                                      (c + 1) * K, cin, vec_a);
    }
    __pipeline_commit();
    if (live)
#pragma unroll
      for (int i = 0; i < kStepOffsets; ++i)
        Tile::step(acc, abuf(c), bbuf(s, i), k3_delta(kStepOffsets * j + i),
                   live);
  }
  __syncthreads();   // every product read; the union buffers are free
  Tile::store(acc, smem, row_occ, cell0, col0, cout, scale, shift, residual,
              out, relu);
}

// Grid of kernels 7 and 8 over nb bricks: (nb * kRowTiles, column tiles).
template <class Tile>
inline dim3 brick_grid(int nb, int cout) {
  return dim3(nb * kRowTiles, (cout + Tile::kNC - 1) / Tile::kNC);
}

// Calls f(Tile{}) with the tile of the type and width: bf16 TcTile or f32
// FmaTile of 32, 64, 96 or 128 columns (Cout above 128: several 128-wide
// column tiles).
template <class F>
inline int with_brick_tile(int is_bf16, int cout, F f) {
  if (is_bf16) {
    if (cout <= 32) return f(TcTile<32>{});
    if (cout <= 64) return f(TcTile<64>{});
    if (cout <= 96) return f(TcTile<96>{});
    return f(TcTile<128>{});
  }
  if (cout <= 32) return f(FmaTile<32>{});
  if (cout <= 64) return f(FmaTile<64>{});
  if (cout <= 96) return f(FmaTile<96>{});
  return f(FmaTile<128>{});
}

}  // namespace us3d
