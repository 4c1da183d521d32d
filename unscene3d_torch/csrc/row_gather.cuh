// Row gathers of (N, C) tables shared by kernel 2's unweighted sum
// (k_apply.cu) and kernel 3 (segment_sum.cu).
//
// A group of G lanes covers one row: lane j of the group holds the row's
// VEC-wide column blocks j, j + G, ..., so a warp reads 32 / G rows per
// load instruction. VEC is 16 bytes' worth of elements (8 bf16, 4 f32)
// when the row width and the base pointers allow it, else 1 (scalar path,
// same kernel). The host picks G from the row's width in blocks: a thread
// per row up to 4 blocks (the C=3 coordinate pools), else the power of two
// that covers the row, up to a warp (16 lanes for a 128-wide bf16 row, 32
// for f32). Both kernels take the row indices of a 32-row tile with one
// coalesced load a lane and hand them out with __shfl_sync, so a row's
// loads depend on no other load of the row.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "gather_gemm.cuh"

namespace us3d {

// VEC consecutive elements of one row, moved in 16-byte accesses when
// VEC * sizeof(T) is a multiple of 16 (one for 8 bf16 or 4 f32; two for a
// pass-1 partial of 8 f32 in segment_sum.cu), else element by element.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T) % 16 == 0 ? 16 : alignof(T)) RowPack {
  T e[VEC];
};

template <typename T, int VEC>
constexpr int kWide = VEC * sizeof(T) % 16 == 0 ? VEC * sizeof(T) / 16 : 0;

template <typename T, int VEC>
__device__ __forceinline__ RowPack<T, VEC> load_pack(const T* p) {
  RowPack<T, VEC> r;
  if constexpr (kWide<T, VEC> > 0) {
#pragma unroll
    for (int i = 0; i < kWide<T, VEC>; ++i)
      reinterpret_cast<uint4*>(&r)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.e[i] = p[i];
  }
  return r;
}

// acc[i] += the pack's element i in f32 (one add per element, in order).
template <typename T, int VEC>
__device__ __forceinline__ void add_pack(float (&acc)[VEC],
                                         const RowPack<T, VEC>& v) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] += to_f32(v.e[i]);
}

// p[0 : VEC] = acc rounded once to T.
template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const float (&acc)[VEC]) {
  RowPack<T, VEC> r;
#pragma unroll
  for (int i = 0; i < VEC; ++i) r.e[i] = from_f32<T>(acc[i]);
  if constexpr (kWide<T, VEC> > 0) {
#pragma unroll
    for (int i = 0; i < kWide<T, VEC>; ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(&r)[i];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = r.e[i];
  }
}

// Elements per lane access for rows of c elements of T at the given bases:
// 16 bytes when c * sizeof(T) is a multiple of 16 and every base is
// 16-byte aligned, else 1.
template <typename T>
inline int row_vec(int c, const void* a, const void* b) {
  const bool vec = c * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return vec ? static_cast<int>(16 / sizeof(T)) : 1;
}

// Lanes per row for a row of `blocks` column blocks (see the top).
inline int lanes_per_row(int blocks) {
  if (blocks <= 4) return 1;
  int g = 8;
  while (g < blocks && g < 32) g *= 2;
  return g;
}

// Streaming multiprocessors of the current device (read once).
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// f(std::integral_constant<int, VEC>, std::integral_constant<int, G>) for
// the runtime vec (1 or 16 / sizeof(T)) and g (1, 8, 16 or 32, from
// lanes_per_row).
template <typename T, typename F>
int with_row_layout(int vec, int g, F f) {
  constexpr int kV = static_cast<int>(16 / sizeof(T));
  auto lanes = [&](auto v) {
    switch (g) {
      case 1: return f(v, std::integral_constant<int, 1>{});
      case 8: return f(v, std::integral_constant<int, 8>{});
      case 16: return f(v, std::integral_constant<int, 16>{});
      default: return f(v, std::integral_constant<int, 32>{});
    }
  };
  if (vec == kV) return lanes(std::integral_constant<int, kV>{});
  return lanes(std::integral_constant<int, 1>{});
}

}  // namespace us3d
