// Flat open-addressing hash / sorted two-pointer k3 neighbour maps and the
// window-table passes of ops/win_graph.py, on the host. The port's own copy
// of unscene3d_tpu/native/kernel_maps.cpp, trimmed to what
// unscene3d_torch/native/__init__.py binds: build_neighbor_map_padded,
// win_lo_reg and win_fill_lidx. Every output entry is written once, so the
// result does not depend on the OpenMP thread count. Held bitwise to the
// numpy twins (native=False) by tests/test_torch_native.py.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kCoordBits = 18;
constexpr int64_t kCoordOffset = 1LL << (kCoordBits - 1);
constexpr uint64_t kEmpty = ~0ULL;

inline uint64_t ravel(int b, int x, int y, int z) {
    const uint64_t ux = static_cast<uint64_t>(x + kCoordOffset);
    const uint64_t uy = static_cast<uint64_t>(y + kCoordOffset);
    const uint64_t uz = static_cast<uint64_t>(z + kCoordOffset);
    return (static_cast<uint64_t>(b) << (3 * kCoordBits)) |
           (ux << (2 * kCoordBits)) | (uy << kCoordBits) | uz;
}

inline uint64_t mix(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    return k;
}

struct FlatMap {
    std::vector<uint64_t> keys;
    std::vector<int32_t> vals;
    uint64_t mask;
    explicit FlatMap(int n) {
        uint64_t cap = 16;
        while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
        keys.assign(cap, kEmpty);
        vals.assign(cap, -1);
        mask = cap - 1;
    }
    void insert(uint64_t k, int32_t v) {
        uint64_t i = mix(k) & mask;
        while (keys[i] != kEmpty) {
            if (keys[i] == k) return;  // keep first occurrence
            i = (i + 1) & mask;
        }
        keys[i] = k;
        vals[i] = v;
    }
    int32_t find(uint64_t k) const {
        uint64_t i = mix(k) & mask;
        while (keys[i] != kEmpty) {
            if (keys[i] == k) return vals[i];
            i = (i + 1) & mask;
        }
        return -1;
    }
};

}  // namespace

extern "C" {

// coords: (n, 4) int32 [b,x,y,z]; offsets: (k, 3) int32. Writes the
// (k, n_pad) map with `fill` at misses and in the padding tail [n, n_pad);
// returns 0, or 1 when no padding row is left.
//
// Fast path: level coords arrive in sorted ravel-key order (sparse_quantize
// and the stride-2 downsample both emit sorted-unique), and a constant
// offset shifts every key by the same delta, so each offset's lookups are a
// two-pointer merge of two sorted streams. Unsorted input takes the flat
// hash.
int build_neighbor_map_padded(const int* coords, int n,
                              const int* offsets, int k,
                              int n_pad, int fill, int* out_idx) {
    // n_pad == n would alias fill = n_pad-1 onto a real data row: misses
    // must point at a padding row
    if (n_pad <= n || n < 0) return 1;
    std::vector<uint64_t> keys(n);
    bool sorted = true;
    for (int i = 0; i < n; ++i) {
        const int* c = coords + 4L * i;
        keys[i] = ravel(c[0], c[1], c[2], c[3]);
        if (i && keys[i] <= keys[i - 1]) sorted = false;
    }
    if (sorted) {
#pragma omp parallel for schedule(dynamic, 1)
        for (int o = 0; o < k; ++o) {
            const int dx = offsets[3 * o], dy = offsets[3 * o + 1],
                      dz = offsets[3 * o + 2];
            const int64_t delta =
                (static_cast<int64_t>(dx) << (2 * kCoordBits)) +
                (static_cast<int64_t>(dy) << kCoordBits) +
                static_cast<int64_t>(dz);
            int* row = out_idx + static_cast<long>(o) * n_pad;
            int j = 0;
            for (int i = 0; i < n; ++i) {
                const uint64_t q =
                    static_cast<uint64_t>(static_cast<int64_t>(keys[i]) + delta);
                while (j < n && keys[j] < q) ++j;
                row[i] = (j < n && keys[j] == q) ? j : fill;
            }
            for (int i = n; i < n_pad; ++i) row[i] = fill;
        }
        return 0;
    }
    FlatMap map(n > 0 ? n : 1);
    for (int i = 0; i < n; ++i) map.insert(keys[i], i);
#pragma omp parallel for schedule(dynamic, 1)
    for (int o = 0; o < k; ++o) {
        const int dx = offsets[3 * o], dy = offsets[3 * o + 1],
                  dz = offsets[3 * o + 2];
        int* row = out_idx + static_cast<long>(o) * n_pad;
        for (int i = 0; i < n; ++i) {
            const int* c = coords + 4L * i;
            const int32_t j = map.find(ravel(c[0], c[1] + dx, c[2] + dy, c[3] + dz));
            row[i] = j >= 0 ? j : fill;
        }
        for (int i = n; i < n_pad; ++i) row[i] = fill;
    }
    return 0;
}

// ------------------------------------------------------------------------
// The two inner passes of the window tables (ops/win_graph.py:
// build_win_graph): single sweeps, OpenMP-parallel over regions / offsets,
// in place of the numpy loops over (27, n_pad) int64 temporaries.

constexpr int32_t kLoSentinel = 0x7fffffff;  // INT32_MAX: no valid neighbor

// Pass 1: per-(region, tile) min of valid neighbor indices, 32-aligned.
// nbr: (27, n_pad) int32, missing = n_pad-1. lo_reg: (3, n_tiles) int32,
// kLoSentinel where a region has no valid pair in the tile. Center offset
// (13) is skipped, matching the python ks list.
int win_lo_reg(const int* nbr, int n_pad, int tile, int* lo_reg) {
    if (n_pad <= 0 || tile <= 0 || n_pad % tile) return 1;
    const int n_tiles = n_pad / tile;
    for (long i = 0; i < 3L * n_tiles; ++i) lo_reg[i] = kLoSentinel;
#pragma omp parallel for schedule(dynamic, 1)
    for (int r = 0; r < 3; ++r) {
        int* lo_r = lo_reg + static_cast<long>(r) * n_tiles;
        for (int k = r * 9; k < (r + 1) * 9; ++k) {
            if (k == 13) continue;
            const int* row = nbr + static_cast<long>(k) * n_pad;
            for (int t = 0; t < n_tiles; ++t) {
                int32_t lo = kLoSentinel;
                const int* p = row + static_cast<long>(t) * tile;
                for (int j = 0; j < tile; ++j) {
                    const int32_t v = p[j];
                    if (v != n_pad - 1 && v < lo) lo = v;
                }
                if (lo != kLoSentinel) {
                    lo &= ~31;
                    if (lo < lo_r[t]) lo_r[t] = lo;
                }
            }
        }
    }
    return 0;
}

// Pass 2: window-local ids + spill triples. lo_of: (3, n_tiles) int32 final
// region window starts (absolute rows); w_reg: (3,) widths. lidx out:
// (n_pad, 26) int16 (-1 = missing/spilled). Spills append in (ki, row)
// lexicographic order -- identical to the numpy np.concatenate order -- into
// the cap-sized buffers. Returns the spill count, or -needed when cap is
// too small (caller re-invokes with a bigger buffer, like segment_mesh).
int win_fill_lidx(const int* nbr, int n_pad, int tile,
                  const int* lo_of, const int* w_reg,
                  int16_t* lidx, int* sp_out, int* sp_in, int* sp_k,
                  int cap) {
    if (n_pad <= 0 || tile <= 0 || n_pad % tile) return 0;
    const int n_tiles = n_pad / tile;
    // per-offset spill counts first so writes can be placed deterministically
    long counts[26];
#pragma omp parallel for schedule(dynamic, 1)
    for (int ki = 0; ki < 26; ++ki) {
        const int k = ki < 13 ? ki : ki + 1;
        const int r = k / 9;
        const int* row = nbr + static_cast<long>(k) * n_pad;
        const int* lo_r = lo_of + static_cast<long>(r) * n_tiles;
        const int w = w_reg[r];
        long cnt = 0;
        for (int i = 0; i < n_pad; ++i) {
            const int32_t v = row[i];
            if (v == n_pad - 1) {
                lidx[static_cast<long>(i) * 26 + ki] = -1;
                continue;
            }
            const long rel = static_cast<long>(v) - lo_r[i / tile];
            if (rel >= 0 && rel < w) {
                lidx[static_cast<long>(i) * 26 + ki] = static_cast<int16_t>(rel);
            } else {
                lidx[static_cast<long>(i) * 26 + ki] = -1;
                ++cnt;
            }
        }
        counts[ki] = cnt;
    }
    long total = 0, offs[26];
    for (int ki = 0; ki < 26; ++ki) { offs[ki] = total; total += counts[ki]; }
    if (total > cap) return total > 0 ? -static_cast<int>(total) : 0;
#pragma omp parallel for schedule(dynamic, 1)
    for (int ki = 0; ki < 26; ++ki) {
        if (!counts[ki]) continue;
        const int k = ki < 13 ? ki : ki + 1;
        const int r = k / 9;
        const int* row = nbr + static_cast<long>(k) * n_pad;
        const int* lo_r = lo_of + static_cast<long>(r) * n_tiles;
        const int w = w_reg[r];
        long q = offs[ki];
        for (int i = 0; i < n_pad; ++i) {
            const int32_t v = row[i];
            if (v == n_pad - 1) continue;
            const long rel = static_cast<long>(v) - lo_r[i / tile];
            if (rel < 0 || rel >= w) {
                sp_out[q] = i;
                sp_in[q] = v;
                sp_k[q] = k;
                ++q;
            }
        }
    }
    return static_cast<int>(total);
}

}  // extern "C"
