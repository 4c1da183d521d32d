// Furthest point sampling on the host: the collate-time query seeds of
// data/collate.py (the port's own copy of unscene3d_tpu/native/point_ops.cpp).
//
// Bit-identical to data/collate.py:fps_numpy: start at row 0, f32 (x-c)^2
// component sums in ((dx2+dy2)+dz2) order, elementwise running min, and the
// first maximum of dist over the valid rows (padding rows never win).
// Built with -ffp-contract=off (native/__init__.py): an FMA contraction
// would change the f32 rounding and the seeds.

#include <cmath>
#include <cstdint>
#include <limits>

extern "C" {

// xyz: (n, 3) f32; valid: (n,) uint8; out_idx: (k,) int32. Returns 0.
int furthest_point_sample(const float* xyz, int n, const uint8_t* valid,
                          int k, float* dist_buf, int* out_idx) {
    if (n <= 0 || k <= 0) return 1;
    const float inf = std::numeric_limits<float>::infinity();
    for (int j = 0; j < n; ++j) dist_buf[j] = inf;
    out_idx[0] = 0;
    for (int i = 1; i < k; ++i) {
        const float* c = xyz + 3L * out_idx[i - 1];
        const float cx = c[0], cy = c[1], cz = c[2];
        float best = -inf;
        int best_j = 0;
#pragma omp parallel
        {
            float tbest = -inf;
            int tbest_j = n;  // sentinel: larger than any real index
#pragma omp for schedule(static) nowait
            for (int j = 0; j < n; ++j) {
                const float dx = xyz[3L * j] - cx;
                const float dy = xyz[3L * j + 1] - cy;
                const float dz = xyz[3L * j + 2] - cz;
                const float d = (dx * dx + dy * dy) + dz * dz;
                const float m = dist_buf[j] < d ? dist_buf[j] : d;
                dist_buf[j] = m;
                const float v = valid[j] ? m : -inf;
                // strict > keeps the FIRST maximum (numpy argmax semantics)
                if (v > tbest) { tbest = v; tbest_j = j; }
            }
#pragma omp critical
            {
                if (tbest > best || (tbest == best && tbest_j < best_j)) {
                    best = tbest;
                    best_j = tbest_j;
                }
            }
        }
        out_idx[i] = best_j < n ? best_j : 0;
    }
    return 0;
}

}  // extern "C"
