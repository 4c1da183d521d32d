// Felzenszwalb graph segmentation over mesh edges (the port's own copy of
// the JAX package's native/segmentator.cpp, the counterpart of the
// reference's felzenszwalb_cpp extension, utils/cpp_utils/segmentator.cpp:
// 17-155). Felzenszwalb-Huttenlocher (https://cs.brown.edu/~pff/segment/):
//   vertex normals = running mean of incident face cross products
//   edge weight    = (1 - n1.n2) * |color1 - color2|_1, squared when the
//                    edge bends convexly and colors are similar
//   union-find with adaptive threshold k/|component|, then small-segment
//   merge, consecutive re-labeling and a segment adjacency list.
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

namespace {

struct Edge {
    float w;
    int a, b;
    bool operator<(const Edge& o) const { return w < o.w; }
};

struct UnionFind {
    std::vector<int> parent, rank_, size_;
    explicit UnionFind(int n) : parent(n), rank_(n, 0), size_(n, 1) {
        for (int i = 0; i < n; ++i) parent[i] = i;
    }
    int find(int x) {
        int root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) { int nx = parent[x]; parent[x] = root; x = nx; }
        return root;
    }
    void join(int a, int b) {
        a = find(a); b = find(b);
        if (a == b) return;
        if (rank_[a] < rank_[b]) std::swap(a, b);
        parent[b] = a;
        size_[a] += size_[b];
        if (rank_[a] == rank_[b]) ++rank_[a];
    }
    int size(int x) { return size_[find(x)]; }
};

}  // namespace

extern "C" {

// Returns number of connectivity pairs written, or -(pairs needed) if
// max_pairs was too small (out_comps is still valid in that case).
int segment_mesh(const float* vertices, int n_vertices,
                 const int* faces, int n_faces,
                 const float* colors,
                 float kthr, int seg_min_verts,
                 int* out_comps,
                 int* out_connectivity, int max_pairs) {
    const long n_edges = 3L * n_faces;
    std::vector<Edge> edges(n_edges);
    std::vector<float> normals(3L * n_vertices, 0.f);
    std::vector<int> counts(n_vertices, 0);

    for (int f = 0; f < n_faces; ++f) {
        const int i1 = faces[3 * f], i2 = faces[3 * f + 1], i3 = faces[3 * f + 2];
        const float* p1 = vertices + 3L * i1;
        const float* p2 = vertices + 3L * i2;
        const float* p3 = vertices + 3L * i3;
        float ux = p2[0] - p1[0], uy = p2[1] - p1[1], uz = p2[2] - p1[2];
        float vx = p3[0] - p1[0], vy = p3[1] - p1[1], vz = p3[2] - p1[2];
        float nx = uy * vz - uz * vy;
        float ny = uz * vx - ux * vz;
        float nz = ux * vy - uy * vx;
        const long e = 3L * f;
        edges[e] = {0.f, i1, i2};
        edges[e + 1] = {0.f, i1, i3};
        edges[e + 2] = {0.f, i3, i2};
        const int vs[3] = {i1, i2, i3};
        for (int k = 0; k < 3; ++k) {
            const int vi = vs[k];
            const float t = 1.f / (counts[vi] + 1.f);  // running mean
            normals[3L * vi] += (nx - normals[3L * vi]) * t;
            normals[3L * vi + 1] += (ny - normals[3L * vi + 1]) * t;
            normals[3L * vi + 2] += (nz - normals[3L * vi + 2]) * t;
            ++counts[vi];
        }
    }

    for (long e = 0; e < n_edges; ++e) {
        const int a = edges[e].a, b = edges[e].b;
        const float* n1 = normals.data() + 3L * a;
        const float* n2 = normals.data() + 3L * b;
        const float* p1 = vertices + 3L * a;
        const float* p2 = vertices + 3L * b;
        float dx = p2[0] - p1[0], dy = p2[1] - p1[1], dz = p2[2] - p1[2];
        const float dd = std::sqrt(dx * dx + dy * dy + dz * dz);
        if (dd > 0.f) { dx /= dd; dy /= dd; dz /= dd; }
        const float dot = n1[0] * n2[0] + n1[1] * n2[1] + n1[2] * n2[2];
        const float normal_dist = 1.f - dot;
        const float* c1 = colors + 3L * a;
        const float* c2 = colors + 3L * b;
        const float color_dist = std::fabs(c1[0] - c2[0]) +
                                 std::fabs(c1[1] - c2[1]) +
                                 std::fabs(c1[2] - c2[2]);
        float dist = normal_dist * color_dist;
        const float dot2 = n2[0] * dx + n2[1] * dy + n2[2] * dz;
        if (dot2 > 0.f && color_dist < 0.05f) dist *= dist;  // convexity discount
        edges[e].w = dist;
    }

    std::stable_sort(edges.begin(), edges.end());
    UnionFind u(n_vertices);
    std::vector<float> threshold(n_vertices, kthr);
    for (long e = 0; e < n_edges; ++e) {
        const int a = u.find(edges[e].a);
        const int b = u.find(edges[e].b);
        if (a != b && edges[e].w <= threshold[a] && edges[e].w <= threshold[b]) {
            u.join(a, b);
            const int r = u.find(a);
            threshold[r] = edges[e].w + kthr / u.size(r);
        }
    }
    for (long e = 0; e < n_edges; ++e) {
        const int a = u.find(edges[e].a);
        const int b = u.find(edges[e].b);
        if (a != b && (u.size(a) < seg_min_verts || u.size(b) < seg_min_verts))
            u.join(a, b);
    }

    // consecutive re-labeling in sorted-root order (matches the reference's
    // sorted-unique mapping, :200-219)
    std::vector<int> roots(n_vertices);
    for (int v = 0; v < n_vertices; ++v) roots[v] = u.find(v);
    std::vector<int> uniq(roots);
    std::sort(uniq.begin(), uniq.end());
    uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
    for (int v = 0; v < n_vertices; ++v) {
        out_comps[v] = static_cast<int>(
            std::lower_bound(uniq.begin(), uniq.end(), roots[v]) - uniq.begin());
    }

    // directed adjacency pairs between distinct segments
    std::unordered_set<uint64_t> pairs;
    pairs.reserve(n_edges / 4);
    for (long e = 0; e < n_edges; ++e) {
        const int s1 = out_comps[edges[e].a];
        const int s2 = out_comps[edges[e].b];
        if (s1 != s2)
            pairs.insert((static_cast<uint64_t>(s1) << 32) | static_cast<uint32_t>(s2));
    }
    std::vector<uint64_t> sorted_pairs(pairs.begin(), pairs.end());
    std::sort(sorted_pairs.begin(), sorted_pairs.end());
    const int n_pairs = static_cast<int>(sorted_pairs.size());
    if (n_pairs > max_pairs) return -n_pairs;
    for (int i = 0; i < n_pairs; ++i) {
        out_connectivity[2 * i] = static_cast<int>(sorted_pairs[i] >> 32);
        out_connectivity[2 * i + 1] = static_cast<int>(sorted_pairs[i] & 0xffffffffu);
    }
    return n_pairs;
}

}  // extern "C"
