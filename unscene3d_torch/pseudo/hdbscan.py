"""HDBSCAN on numpy and scipy: the labels of scikit-learn's
`HDBSCAN(min_cluster_size=m).fit(x).labels_` at its defaults, without
scikit-learn (the GPU machine has none).

The steps are scikit-learn 1.9's (sklearn/cluster/_hdbscan):
  * core distance: the Euclidean distance to the `min_samples`-th nearest
    neighbour, the point itself counted (`min_samples` defaults to
    `min_cluster_size`);
  * mutual reachability max(core_a, core_b, |a - b|) (alpha = 1);
  * the exact minimum spanning tree by Prim over dense mutual-reachability
    rows (`mst_from_data_matrix`): start at node 0, take the first minimum,
    replace a node's best edge only when strictly smaller;
  * the single-linkage tree over the edges in `np.argsort` order of their
    weights, merged with scikit-learn's union-find;
  * the tree condensed at `min_cluster_size`, excess-of-mass selection with
    allow_single_cluster=False and cluster_selection_epsilon=0;
  * noise -1 and the selected clusters numbered in ascending node order.

Prim runs in the native host library (`native.hdbscan_prim_mst`, C++ over
OpenMP threads), bitwise its numpy twin `prim_mst` (`native=False`): the
numpy loop's n Python-level iterations are too slow at the 3DUIS CLI's
~40k voxels a scene.

Every float is computed as scikit-learn computes it (squared differences
summed over the axes in order, then the square root), so equal distances
tie the same way and the labels equal scikit-learn's exactly. Prim is
O(n^2) time and O(n) memory, as scikit-learn's.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from unscene3d_torch import native as native_lib


def _dist_to(x: np.ndarray, i: int) -> np.ndarray:
    """Euclidean distance from row i to every row, summed over the axes in
    order as scikit-learn's `euclidean_rdist` does."""
    d = x - x[i]
    acc = d[:, 0] * d[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + d[:, k] * d[:, k]
    return np.sqrt(acc)


def core_distances(x: np.ndarray, min_samples: int) -> np.ndarray:
    """Distance to the min_samples-th neighbour, the point itself counted:
    the k nearest from a KD-tree, their distances recomputed with
    `_dist_to`'s arithmetic."""
    _, idx = cKDTree(x).query(x, k=min_samples)
    idx = np.asarray(idx).reshape(len(x), min_samples)
    d = x[idx] - x[:, None, :]
    acc = d[..., 0] * d[..., 0]
    for k in range(1, x.shape[1]):
        acc = acc + d[..., k] * d[..., k]
    return np.sqrt(acc).max(axis=1)


def prim_mst(x: np.ndarray, core: np.ndarray):
    """(source, target, weight) of the n - 1 edges of the mutual-reachability
    MST in the order Prim adds them (scikit-learn's
    `mst_from_data_matrix`)."""
    n = len(x)
    src = np.empty(n - 1, np.int64)
    dst = np.empty(n - 1, np.int64)
    w = np.empty(n - 1, np.float64)
    best = np.full(n, np.inf)
    source = np.ones(n, np.int64)
    in_tree = np.zeros(n, bool)
    cur = 0
    for i in range(n - 1):
        in_tree[cur] = True
        mr = np.maximum(np.maximum(core[cur], core), _dist_to(x, cur))
        better = (mr < best) & ~in_tree
        best[better] = mr[better]
        source[better] = cur
        cand = np.where(in_tree, np.inf, best)
        nxt = int(np.argmin(cand))
        src[i], dst[i], w[i] = source[nxt], nxt, cand[nxt]
        cur = nxt
    return src, dst, w


def single_linkage(src, dst, w, n: int):
    """(left, right, distance, size) rows of the dendrogram: the MST edges
    in `np.argsort` order of their weights, joined by scikit-learn's
    `UnionFind` (new node ids from n up)."""
    order = np.argsort(w)
    parent = np.full(2 * n - 1, -1, np.int64)
    size = np.zeros(2 * n - 1, np.int64)
    size[:n] = 1
    left = np.empty(n - 1, np.int64)
    right = np.empty(n - 1, np.int64)
    csize = np.empty(n - 1, np.int64)

    def find(a):
        root = a
        while parent[root] != -1:
            root = parent[root]
        while a != root and parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    nxt = n
    for r, e in enumerate(order.tolist()):
        a, b = find(int(src[e])), find(int(dst[e]))
        left[r], right[r] = a, b
        size[nxt] = csize[r] = size[a] + size[b]
        parent[a] = parent[b] = nxt
        nxt += 1
    return left, right, w[order], csize


def _bfs(left, right, n: int, root: int) -> list:
    out, queue = [], [root]
    while queue:
        out.extend(queue)
        nxt = []
        for node in queue:
            if node >= n:
                nxt.append(int(left[node - n]))
                nxt.append(int(right[node - n]))
        queue = nxt
    return out


def condense_tree(left, right, dist, csize, min_cluster_size: int):
    """(parent, child, lambda, size) rows of the condensed tree
    (scikit-learn's `_condense_tree`)."""
    n = len(left) + 1
    root = 2 * (n - 1)
    relabel = np.empty(root + 1, np.int64)
    relabel[root] = n
    next_label = n + 1
    ignore = np.zeros(root + 1, bool)
    rows = []

    def count(node):
        return int(csize[node - n]) if node >= n else 1

    def drop(parent_label, sub, lam):
        for s in _bfs(left, right, n, sub):
            if s < n:
                rows.append((parent_label, s, lam, 1))
            ignore[s] = True

    for node in _bfs(left, right, n, root):
        if ignore[node] or node < n:
            continue
        a, b = int(left[node - n]), int(right[node - n])
        d = float(dist[node - n])
        lam = 1.0 / d if d > 0.0 else np.inf
        ca, cb = count(a), count(b)
        p = int(relabel[node])
        if ca >= min_cluster_size and cb >= min_cluster_size:
            relabel[a] = next_label
            rows.append((p, next_label, lam, ca))
            relabel[b] = next_label + 1
            rows.append((p, next_label + 1, lam, cb))
            next_label += 2
        elif ca < min_cluster_size and cb < min_cluster_size:
            drop(p, a, lam)
            drop(p, b, lam)
        elif ca < min_cluster_size:
            relabel[b] = p
            drop(p, a, lam)
        else:
            relabel[a] = p
            drop(p, b, lam)
    parent = np.array([r[0] for r in rows], np.int64)
    child = np.array([r[1] for r in rows], np.int64)
    lam = np.array([r[2] for r in rows], np.float64)
    size = np.array([r[3] for r in rows], np.int64)
    return parent, child, lam, size


def _stability(parent, child, lam, size) -> dict:
    """scikit-learn's `_compute_stability`: sum over a cluster's rows of
    (lambda - its birth lambda) * size, accumulated in row order."""
    smallest = int(parent.min())
    births = np.full(max(int(child.max()), smallest) + 1, np.nan)
    births[child] = lam
    births[smallest] = 0.0
    result = np.zeros(int(parent.max()) - smallest + 1)
    np.add.at(result, parent - smallest, (lam - births[parent]) * size)
    return {smallest + i: float(v) for i, v in enumerate(result)}


def select_clusters(parent, child, lam, size) -> np.ndarray:
    """Excess-of-mass selection (allow_single_cluster=False, epsilon 0) and
    the labels of the points: -1 for noise, else the rank of the selected
    cluster among the selected ones."""
    stability = _stability(parent, child, lam, size)
    node_list = sorted(stability, reverse=True)[:-1]
    is_tree = size > 1
    tp, tc = parent[is_tree], child[is_tree]
    kids: dict = {}
    for p, c in zip(tp.tolist(), tc.tolist()):
        kids.setdefault(p, []).append(c)
    is_cluster = {c: True for c in node_list}
    for node in node_list:
        sub = float(np.sum([stability[c] for c in kids.get(node, [])]))
        if sub > stability[node]:
            is_cluster[node] = False
            stability[node] = sub
        else:
            queue = list(kids.get(node, []))
            while queue:
                s = queue.pop()
                is_cluster[s] = False
                queue.extend(kids.get(s, []))
    clusters = sorted(c for c, v in is_cluster.items() if v)
    label_of = {c: k for k, c in enumerate(clusters)}
    root = int(parent.min())
    # each condensed node's owner: itself if selected, else its parent's
    # owner (rows list a parent before its children)
    owner = {root: root}
    for p, c in zip(tp.tolist(), tc.tolist()):
        owner[c] = c if c in label_of else owner[p]
    labels = np.full(root, -1, np.int64)
    pts = ~is_tree
    for p, c in zip(parent[pts].tolist(), child[pts].tolist()):
        o = owner[p]
        labels[c] = label_of[o] if o != root else -1
    return labels


def hdbscan_labels(x: np.ndarray, min_cluster_size: int = 5,
                   min_samples: int | None = None,
                   native: bool = True) -> np.ndarray:
    """scikit-learn's `HDBSCAN(min_cluster_size, min_samples).fit(x).labels_`
    for finite x (N, D): -1 for noise, clusters 0..K-1. `native=False` runs
    Prim in numpy."""
    x = np.ascontiguousarray(x, np.float64)
    n = len(x)
    if n == 1:
        raise ValueError("n_samples=1 while HDBSCAN requires more than one "
                         "sample")
    if not np.isfinite(x).all():
        raise ValueError("hdbscan_labels takes finite points only")
    k = min_cluster_size if min_samples is None else min_samples
    if k > n:
        raise ValueError(f"min_samples ({k}) must be at most the number of "
                         f"samples in X ({n})")
    core = core_distances(x, k)
    mst = native_lib.hdbscan_prim_mst if native else prim_mst
    left, right, dist, csize = single_linkage(*mst(x, core), n)
    return select_clusters(*condense_tree(left, right, dist, csize,
                                          min_cluster_size))
