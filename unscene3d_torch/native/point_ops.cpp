// Furthest point sampling on the host: the collate-time query seeds of
// data/collate.py (the port's own copy of unscene3d_tpu/native/point_ops.cpp),
// and the mutual-reachability minimum spanning tree of pseudo/hdbscan.py.
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

// HDBSCAN's exact mutual-reachability MST by Prim (pseudo/hdbscan.py:
// prim_mst, scikit-learn's mst_from_data_matrix), bitwise the numpy loop:
// f64 distances as sqrt(((d0*d0) + d1*d1) + ...), a node's best edge
// replaced only when strictly smaller, the first minimum taken next.
// x: (n, dim) f64; core: (n,) f64; best: (n,) f64 and src_buf: (n,) int64
// scratch; in_tree: (n,) uint8 scratch; out_src, out_dst: (n - 1,) int64;
// out_w: (n - 1,) f64. Returns 0.
int hdbscan_prim_mst(const double* x, int n, int dim, const double* core,
                     double* best, int64_t* src_buf, uint8_t* in_tree,
                     int64_t* out_src, int64_t* out_dst, double* out_w) {
    if (n < 2 || dim <= 0) return 1;
    const double inf = std::numeric_limits<double>::infinity();
    for (int j = 0; j < n; ++j) {
        best[j] = inf;
        src_buf[j] = 1;
        in_tree[j] = 0;
    }
    int cur = 0;
    for (int i = 0; i < n - 1; ++i) {
        in_tree[cur] = 1;
        const double* c = x + (int64_t)dim * cur;
        const double core_c = core[cur];
        double gbest = inf;
        int gbest_j = n;
#pragma omp parallel
        {
            double tbest = inf;
            int tbest_j = n;  // sentinel: larger than any real index
#pragma omp for schedule(static) nowait
            for (int j = 0; j < n; ++j) {
                if (in_tree[j]) continue;
                const double* xj = x + (int64_t)dim * j;
                double d0 = xj[0] - c[0];
                double acc = d0 * d0;
                for (int k = 1; k < dim; ++k) {
                    const double dk = xj[k] - c[k];
                    acc = acc + dk * dk;
                }
                double mr = std::sqrt(acc);
                const double cm = core_c > core[j] ? core_c : core[j];
                if (cm > mr) mr = cm;
                if (mr < best[j]) {
                    best[j] = mr;
                    src_buf[j] = cur;
                }
                // strict < keeps the FIRST minimum (numpy argmin semantics)
                if (best[j] < tbest) { tbest = best[j]; tbest_j = j; }
            }
#pragma omp critical
            {
                if (tbest < gbest || (tbest == gbest && tbest_j < gbest_j)) {
                    gbest = tbest;
                    gbest_j = tbest_j;
                }
            }
        }
        if (gbest_j >= n) return 2;  // no finite edge left
        out_src[i] = src_buf[gbest_j];
        out_dst[i] = gbest_j;
        out_w[i] = gbest;
        cur = gbest_j;
    }
    return 0;
}

}  // extern "C"
