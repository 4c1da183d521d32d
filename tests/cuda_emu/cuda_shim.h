// CPU emulation of the CUDA subset that unscene3d_torch/csrc uses, so the
// kernels' index arithmetic, skipping, epilogues and bf16 rounding can be
// tested without a GPU (tests/test_torch_kernels_emulated.py).
//
// Every block runs its threads as std::threads with a std::barrier for
// __syncthreads; blocks run one after another, so `__shared__` arrays become
// function statics shared by the block's threads. Launches `k<<<g, b, s,
// st>>>(args)` are rewritten to `emu_launch(g, b, s, st, [&] { k(args); })`
// by the test before compiling with g++ -std=c++20, and a dynamic
// `extern __shared__ T name[];` to `T* name = (T*)emu_dynamic_smem();`: the
// launch's third argument sizes that buffer. cp.async (the __pipeline_*
// functions) lands at the wait that must see it, not before. A misaligned
// WMMA pointer (the card needs 32 bytes) is reported by the next
// cudaGetLastError, as cudaErrorMisalignedAddress. Of the warp intrinsics
// __ballot_sync, __shfl_sync and __shfl_xor_sync are emulated (every lane
// of the warp must call them), with __popc beside them. The device reports
// 4 SMs (cudaDeviceGetAttribute), so that a small level takes the narrower
// f32 column tiles a small grid gets on the card.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __shared__ static

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorMisalignedAddress = 716;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
// a card of 4 SMs: a level of two 128-row tiles takes narrower f32 column
// tiles where Cout fits one
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 4;
  return cudaSuccess;
}
inline std::atomic<int> g_emu_error{0};
inline cudaError_t cudaGetLastError() { return g_emu_error.exchange(0); }
template <class F>
cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) {
  return cudaSuccess;
}

struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }

// cp.async, per thread: a copy lands as late as the card allows, when
// __pipeline_wait_prior(n) leaves fewer than n+1 of the thread's committed
// groups outstanding (or when its block ends), so that a read before the
// wait and the barrier sees stale data, as it may on the card.
struct EmuCopy {
  void* dst;
  const void* src;
  size_t n, zfill;
};
inline thread_local std::vector<EmuCopy> g_copies_open;
inline thread_local std::deque<std::vector<EmuCopy>> g_copies_committed;
inline void emu_land(const std::vector<EmuCopy>& group) {
  for (const EmuCopy& c : group) {
    std::memcpy(c.dst, c.src, c.n - c.zfill);
    std::memset(static_cast<char*>(c.dst) + (c.n - c.zfill), 0, c.zfill);
  }
}
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t zfill = 0) {
  g_copies_open.push_back({dst, src, n, zfill});
}
inline void __pipeline_commit() {
  g_copies_committed.push_back(std::move(g_copies_open));
  g_copies_open.clear();
}
inline void __pipeline_wait_prior(size_t n) {
  while (g_copies_committed.size() > n) {
    emu_land(g_copies_committed.front());
    g_copies_committed.pop_front();
  }
}
inline void emu_pipeline_drain() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// the launch's dynamic shared memory, shared by the block's threads
inline unsigned char* g_dynamic_smem = nullptr;
inline unsigned char* emu_dynamic_smem() { return g_dynamic_smem; }

struct __nv_bfloat16 {
  uint16_t v;
};
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = static_cast<uint32_t>(b.v) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // round to nearest even
  uint32_t u;
  std::memcpy(&u, &f, 4);
  const uint32_t r = u + 0x7FFFu + ((u >> 16) & 1u);
  __nv_bfloat16 b;
  b.v = static_cast<uint16_t>(r >> 16);
  return b;
}

#define __align__(n) __attribute__((aligned(n)))

// WMMA: lane 0 of the warp holds the whole 16x16 tile, computes the whole
// product (the hardware splits it across the warp) and stores it; the other
// lanes' fragments stay unused, which is exact for kernels that touch
// fragments only through these calls (warp-uniform, as the API requires).
// Every lane checks the pointer's alignment.
namespace nvcuda {
namespace wmma {
struct row_major {};
struct col_major {};
struct matrix_a {};
struct matrix_b {};
struct accumulator {};
enum layout_t { mem_row_major };
template <class Use, int M, int N, int K, class T, class Layout = void>
struct fragment {
  T x[16 * 16];
};
inline bool lane0() { return threadIdx.x % 32 == 0; }
template <class F, class V>
void fill_fragment(F& f, V v) {
  if (!lane0()) return;
  for (auto& e : f.x) e = v;
}
// WMMA loads and stores need a 256-bit aligned pointer on the card
inline bool misaligned(const void* p) {
  if (reinterpret_cast<uintptr_t>(p) % 32 == 0) return false;
  g_emu_error.store(cudaErrorMisalignedAddress);
  return true;
}
template <class Use, class T, class L>
void load_matrix_sync(fragment<Use, 16, 16, 16, T, L>& f, const T* p,
                      unsigned ldm) {
  if (misaligned(p) || !lane0()) return;
  constexpr bool kColMajor = std::is_same_v<L, col_major>;
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c)
      f.x[r * 16 + c] = kColMajor ? p[c * ldm + r] : p[r * ldm + c];
}
inline float as_float(float v) { return v; }
inline float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <class T, class LA, class LB>
void mma_sync(fragment<accumulator, 16, 16, 16, float>& d,
              const fragment<matrix_a, 16, 16, 16, T, LA>& a,
              const fragment<matrix_b, 16, 16, 16, T, LB>& b,
              const fragment<accumulator, 16, 16, 16, float>& c) {
  if (!lane0()) return;
  float t[16 * 16];
  for (int r = 0; r < 16; ++r)
    for (int n = 0; n < 16; ++n) {
      float s = c.x[r * 16 + n];
      for (int k = 0; k < 16; ++k)
        s += as_float(a.x[r * 16 + k]) * as_float(b.x[k * 16 + n]);
      t[r * 16 + n] = s;
    }
  std::memcpy(d.x, t, sizeof(t));
}
inline void store_matrix_sync(float* p,
                              const fragment<accumulator, 16, 16, 16, float>& f,
                              unsigned ldm, layout_t) {
  if (misaligned(p) || !lane0()) return;
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c) p[r * ldm + c] = f.x[r * 16 + c];
}
}  // namespace wmma
}  // namespace nvcuda

inline std::barrier<>* g_block_barrier = nullptr;
inline std::atomic<int> g_block_or{0};
// one barrier and one vote slot per lane for each warp of the block, and two
// shuffle slots per lane (see emu_shuffle)
inline std::unique_ptr<std::barrier<>>* g_warp_barriers = nullptr;
inline unsigned* g_warp_votes = nullptr;
inline uint64_t* g_warp_words = nullptr;
inline thread_local unsigned g_shuffles = 0;  // this thread's, in its launch

inline int emu_linear_tid() {
  return static_cast<int>(threadIdx.x + blockDim.x * (threadIdx.y +
                                                      blockDim.y *
                                                      threadIdx.z));
}

// Bit l: lane l's predicate, for the lanes in `mask`.
inline unsigned __ballot_sync(unsigned mask, int pred) {
  const int t = emu_linear_tid();
  const int w = t / 32;
  const int lanes = static_cast<int>(blockDim.x * blockDim.y * blockDim.z) -
                    32 * w;
  g_warp_votes[t] = pred ? 1u : 0u;
  g_warp_barriers[w]->arrive_and_wait();
  unsigned r = 0;
  for (int l = 0; l < 32 && l < lanes; ++l) r |= g_warp_votes[32 * w + l] << l;
  g_warp_barriers[w]->arrive_and_wait();
  return r & mask;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }

// v of lane src_lane of the warp (a value of up to 8 bytes): every lane
// publishes its own value, waits for the warp, reads. Shuffles alternate
// between two slot sets, so one barrier each suffices: a lane overwrites a
// set only two shuffles later, after the barrier of the shuffle between,
// which every lane reaches only once it has read this one.
template <class V>
V emu_shuffle(V v, int src_lane) {
  static_assert(sizeof(V) <= sizeof(uint64_t), "shuffle of a wide value");
  const int t = emu_linear_tid();
  const int w = t / 32;
  const int nthr = static_cast<int>(blockDim.x * blockDim.y * blockDim.z);
  uint64_t* words = g_warp_words + (g_shuffles++ % 2) * nthr;
  uint64_t word = 0;
  std::memcpy(&word, &v, sizeof(V));
  words[t] = word;
  g_warp_barriers[w]->arrive_and_wait();
  word = words[32 * w + src_lane];
  V r;
  std::memcpy(&r, &word, sizeof(V));
  return r;
}
template <class V>
V __shfl_sync(unsigned, V v, int src, int width = 32) {
  const int lane = emu_linear_tid() % 32;
  return emu_shuffle(v, (lane & ~(width - 1)) + (src & (width - 1)));
}
template <class V>
V __shfl_xor_sync(unsigned, V v, int lane_mask, int width = 32) {
  const int lane = emu_linear_tid() % 32;
  const int src = lane ^ lane_mask;
  return emu_shuffle(v, src < ((lane & ~(width - 1)) + width) ? src : lane);
}

inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }

inline int __syncthreads_or(int pred) {
  if (pred) g_block_or.fetch_or(1);
  g_block_barrier->arrive_and_wait();
  const int r = g_block_or.load();
  g_block_barrier->arrive_and_wait();
  if (threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0)
    g_block_or.store(0);
  g_block_barrier->arrive_and_wait();
  return r;
}

// One std::thread per CUDA thread of a block, reused for every block of the
// grid in turn; the barrier after each block keeps the next block from
// touching the shared statics before all threads have left the last one.
template <class F>
void emu_launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, F body) {
  blockDim = block;
  gridDim = grid;
  std::vector<unsigned char> dynamic(smem + 128);
  g_dynamic_smem = dynamic.data() + (128 - reinterpret_cast<uintptr_t>(
                                               dynamic.data()) % 128);
  const int nthr = static_cast<int>(block.x * block.y * block.z);
  std::barrier<> bar(nthr);
  g_block_barrier = &bar;
  const int nwarps = (nthr + 31) / 32;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  for (int w = 0; w < nwarps; ++w)
    warp_bars.push_back(std::make_unique<std::barrier<>>(
        nthr - 32 * w < 32 ? nthr - 32 * w : 32));
  std::vector<unsigned> votes(nthr);
  std::vector<uint64_t> words(2 * nthr);
  g_warp_barriers = warp_bars.data();
  g_warp_votes = votes.data();
  g_warp_words = words.data();
  std::vector<std::thread> threads;
  threads.reserve(nthr);
  for (int t = 0; t < nthr; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                       t / (block.x * block.y));
      for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
          for (unsigned bx = 0; bx < grid.x; ++bx) {
            blockIdx = dim3(bx, by, bz);
            body();
            emu_pipeline_drain();
            bar.arrive_and_wait();
          }
    });
  for (auto& th : threads) th.join();
}
