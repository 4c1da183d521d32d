"""Greedy masked Normalized-Cut pseudo-mask generation (counterpart of
unscene3d_tpu/pseudo/ncut.py).

Per batch of scenes: segment features -> cosine affinity, normalized and
binarized at tau -> the second generalized eigenvector of (D - A, D) ->
mean-threshold bipartition with the > 0.8 foreground flip -> the connected
component picked by the separation mode -> IoU / min-size gates -> painting,
for up to `max_number_of_instances` rounds. Painted and padding segments
have their affinity rows and columns forced to eps, so padding needs no
special spectral treatment. Every function is batched by a leading
dimension.

NCut has no hand-written kernel, as it has no Pallas kernel in the JAX
package: the solvers are batched `torch.linalg` (`cholesky_ex`,
`cholesky_solve`, `eigh`) and `matmul`. This path relies on full-f32
matmuls: the `cholinv` inverse carries an error of ~kappa * eps that the
iteration corrects in f32 but not in TF32, so `BatchedNCut` refuses to run
on a GPU while `torch.backends.cuda.matmul.allow_tf32` is set.

Solvers: `cholinv` (default: shift-inverted block subspace iteration through
one batched Cholesky and an explicit inverse, 16 rounds of block 16) and
`eigh` (the exact spectrum). The `subspace` solver of the JAX package (its
`ncut_eigenvectors` still defaults to it) never converges on realistic
spectra and is not ported: asking for it raises ValueError.

The greedy loop runs on the device with no host synchronisation
(`_device_greedy`: components by neighbour-min and pointer-jump label
propagation over int32 labels; component sizes as integer counts; ties of
the `largest` mode broken towards the lowest label), or on the host in two
pipelined half-batches (`device_loop=False`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from unscene3d_torch.eval.postprocess import separate_segments
from unscene3d_torch.runtime import resolve_device

SOLVERS = ("cholinv", "eigh")


@dataclasses.dataclass
class NCutConfig:
    affinity_tau: float = 0.65
    max_number_of_instances: int = 20
    similarity_metric: str = "cos"
    max_extent_ratio: float = 0.8
    min_segment_size: int = 4
    separation_mode: str = "max"
    eps: float = 1e-5
    # 'cholinv' (shift-inverted subspace iteration) or 'eigh' (exact)
    solver: str = "cholinv"
    solver_iters: int = 16
    solver_block: int = 16
    # run the whole greedy loop on the device (no per-iteration host round
    # trip); False takes the per-iteration host loop
    device_loop: bool = True
    label_prop_steps: int = 24


def _check_solver(solver: str) -> None:
    if solver == "subspace":
        raise ValueError(
            "solver 'subspace' is not ported: its per-step contraction "
            "~(1 - gap/2) never converges on realistic spectra (|cos| to the "
            "float64 Fiedler vector ~0.33); use 'cholinv' or 'eigh'")
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}")


def _normalize_mat(a, valid2):
    """Shift by the smallest positive entry, clip negatives, scale by the
    max; min and max over valid (non-padding) entries only. a, valid2:
    (B, S, S)."""
    inf = float("inf")
    pos = (a > 0) & valid2
    minpos = torch.where(pos, a, inf).amin(dim=(-2, -1))
    shift = torch.where(torch.isfinite(minpos), minpos, 0.0)
    a = a - torch.where(pos.any(-1).any(-1), shift, 0.0)[:, None, None]
    a = torch.clamp_min(a, 0.0)
    top = torch.where(valid2, a, -inf).amax(dim=(-2, -1))
    return a / (top + 1e-5)[:, None, None]


def _affinity_from_feats(feats, mask, valid, rowwise_minmax: bool):
    """One modality's affinity (B, S, S). The unimodal path applies the
    row-wise min-max of the reference's cosine_sim; the multimodal path
    none. Padding rows and columns are excluded from every min and max."""
    inf = float("inf")
    f = feats * (1.0 - mask)[..., None]
    norm = torch.sqrt((f * f).sum(-1, keepdim=True))
    f = f / torch.clamp_min(norm, 1e-12)
    a = f @ f.transpose(-1, -2)
    valid2 = valid[:, :, None] & valid[:, None, :]
    if rowwise_minmax:
        rowmin = torch.where(valid2, a, inf).amin(-1, keepdim=True)
        a = a - torch.where(torch.isfinite(rowmin), rowmin, 0.0)
        rowmax = torch.where(valid2, a, -inf).amax(-1, keepdim=True)
        a = a / (torch.where(torch.isfinite(rowmax), rowmax, 0.0) + 1e-10)
    return _normalize_mat(a, valid2)


def affinity_matrix(feats_a, feats_b, painting, invalid, multimodal: bool):
    """The affinity before the tau threshold, (B, S, S)."""
    valid = ~invalid
    if multimodal:
        return (_affinity_from_feats(feats_a, painting, valid, False)
                + _affinity_from_feats(feats_b, painting, valid, False)) / 2.0
    return _affinity_from_feats(feats_a, painting, valid, True)


def binarized_affinity(a, painting, invalid, tau: float, eps: float,
                       symmetrize: bool):
    """1 above tau and eps elsewhere; rows and columns of painted or padding
    segments at eps. `symmetrize` (the cholinv path) averages with the
    transpose: the Cholesky needs an exactly symmetric operator."""
    a = torch.where(a > tau, 1.0, eps)
    dead = (painting > 0) | invalid
    a = torch.where(dead[:, :, None] | dead[:, None, :], eps, a)
    if symmetrize:
        a = (a + a.transpose(-1, -2)) * 0.5
    return a


def normalized_laplacian(a):
    """(D^-1/2 (D - A) D^-1/2, d) with d the column sums of a."""
    d = a.sum(dim=1)
    inv_sqrt_d = torch.rsqrt(d)
    lap = torch.diag_embed(d) - a
    return inv_sqrt_d[:, :, None] * lap * inv_sqrt_d[:, None, :], d


def _second_vec_eigh(sym):
    # jnp.linalg.eigh averages the two triangles; torch reads the lower one
    _, vecs = torch.linalg.eigh((sym + sym.transpose(-1, -2)) * 0.5)
    return vecs[:, :, 1]


def _mgs(x):
    """Modified Gram-Schmidt of the columns of x (B, S, k) from elementwise
    ops and sums: robust to the near-singular Gram matrix that the binarized
    tau-graph's disconnected components produce (Cholesky-QR is not), and
    free of any batched QR. Column j has the projections on q_0 .. q_{j-1}
    taken off in that order, each against the updated column, as in the JAX
    package; here every finished q_i is taken off all later columns in one
    step (the same arithmetic per column, k steps instead of k^2 / 2)."""
    x = x.clone()
    k = x.shape[-1]
    for j in range(k):
        v = x[:, :, j]
        q = v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-30)
        x[:, :, j] = q
        if j + 1 < k:
            rest = x[:, :, j + 1:]
            rest -= q[:, :, None] * (q[:, :, None] * rest).sum(1, keepdim=True)
    return x


def _ritz_second(sym, v0, x, shift: float = 3.0):
    """Fiedler vector from the subspace span{v0, x}: the v0 direction (the
    exact or quasi null vector) is lifted by +1 inside the Ritz operator,
    so the single smallest Ritz vector is the Fiedler vector; it is
    extracted by repeated squaring (matmuls only)."""
    z = _mgs(torch.cat([v0, x], dim=-1))                 # (B, S, k+1)
    kk = z.shape[-1]
    t = z.transpose(-1, -2) @ (sym @ z)
    t = (t + t.transpose(-1, -2)) * 0.5
    t[:, 0, 0] += 1.0                                    # lift the v0 pair
    m = shift * torch.eye(kk, dtype=sym.dtype, device=sym.device) - t
    for _ in range(24):
        m = m @ m
        m = m / (torch.sqrt((m * m).sum(dim=(-2, -1), keepdim=True)) + 1e-30)
    # column through the strongest diagonal entry of the limit projector
    j = torch.argmax(torch.diagonal(m, dim1=-2, dim2=-1), dim=-1)
    u = torch.gather(m, 2, j[:, None, None].expand(-1, kk, 1))   # (B, kk, 1)
    u = u * torch.rsqrt((u * u).sum(1, keepdim=True) + 1e-30)
    return (z @ u)[:, :, 0]


def _second_vec_cholinv(sym, d_sqrt, iters: int, k: int,
                        sigma: float = 0.005):
    """Fiedler vector by shift-inverted block subspace iteration: one
    batched Cholesky of sym + v0 v0^T + sigma I (the rank-one term lifts the
    null direction, so a tiny sigma keeps the factor SPD), one wide solve
    for the explicit inverse, then `iters` rounds of matmul, v0 deflation
    and Gram-Schmidt; Rayleigh-Ritz runs on the original operator. `sym`
    must be an exactly PSD normalized Laplacian whose null vector is d_sqrt.
    A matrix that fails to factor (NaN input) yields NaN for its scene and
    leaves the rest of the batch alone."""
    B, S, _ = sym.shape
    eye = torch.eye(S, dtype=sym.dtype, device=sym.device)
    sym = (sym + sym.transpose(-1, -2)) * 0.5
    v0 = d_sqrt / torch.sqrt((d_sqrt * d_sqrt).sum(-1, keepdim=True))
    v0 = v0[:, :, None]
    a = sym + v0 @ v0.transpose(-1, -2)
    chol, info = torch.linalg.cholesky_ex(a + sigma * eye)
    chol = torch.where((info > 0)[:, None, None], float("nan"), chol)
    inv_a = torch.cholesky_solve(eye.expand(B, S, S), chol)
    x = torch.sin(torch.arange(S * k, dtype=sym.dtype, device=sym.device)
                  * 0.73).reshape(S, k).expand(B, S, k)
    for _ in range(iters):
        y = inv_a @ x
        y = y - v0 * (v0.transpose(-1, -2) @ y)
        x = _mgs(y)
    return _ritz_second(sym, v0, x)


def ncut_eigenvectors(feats_a, feats_b, painting, invalid, tau: float = 0.65,
                      eps: float = 1e-5, multimodal: bool = True,
                      solver: str = "cholinv", iters: int = 16,
                      block: int = 16):
    """Batched second-smallest generalized eigenvector of (D - A, D).
    feats_a (B, S, Da), feats_b (B, S, Db) (feats_a when unimodal), painting
    (B, S) float with 1 = masked out, invalid (B, S) bool padding. Returns
    (B, S), under a canonical sign: the entry of largest magnitude over the
    valid rows is positive, so every solver and every batch size picks the
    same side when the bipartition fraction ties the flip threshold."""
    _check_solver(solver)
    valid = ~invalid
    a = affinity_matrix(feats_a, feats_b, painting, invalid, multimodal)
    a = binarized_affinity(a, painting, invalid, tau, eps,
                           symmetrize=solver == "cholinv")
    sym, d = normalized_laplacian(a)
    if solver == "eigh":
        y = _second_vec_eigh(sym)
    else:
        y = _second_vec_cholinv(sym, torch.sqrt(d), iters, block)
    vec = y * torch.rsqrt(d)
    absv = torch.where(valid, vec.abs(), -float("inf"))
    lead = torch.gather(vec, 1, torch.argmax(absv, dim=1, keepdim=True))
    return vec * torch.where(lead < 0, -1.0, 1.0)


def _first_max(values, fill):
    """Index of the first maximum along dim 1 (torch.argmax on the GPU does
    not promise the first of equal maxima). values: (B, S) integers."""
    S = values.shape[1]
    iota = torch.arange(S, device=values.device)
    top = values.amax(dim=1, keepdim=True)
    return torch.where(values == top, iota, fill).amin(dim=1)


def _device_greedy(fa, fb, invalid, adj, *, tau, eps, multimodal, solver,
                   iters, block, max_inst, max_extent_ratio,
                   min_segment_size, mode, prop_steps):
    """The whole greedy masked-NCut loop on the device, with no host
    synchronisation: mean-threshold bipartition, > 0.8 flip, connectivity
    separation, IoU and min-size gates, painting. adj: (B, S, S) bool.
    Returns (B, max_inst, S) accepted masks (all-False rows = rejected)."""
    if mode not in ("max", "avg", "largest", "all"):
        raise NotImplementedError(mode)
    B, S = invalid.shape
    dev = invalid.device
    iota = torch.arange(S, dtype=torch.int32, device=dev)
    valid = ~invalid
    cntv = torch.clamp_min(valid.sum(-1), 1).to(torch.float32)
    painting = torch.zeros(B, S, dtype=torch.float32, device=dev)
    fg = torch.zeros(B, S, dtype=torch.bool, device=dev)
    masks = torch.zeros(B, max_inst, S, dtype=torch.bool, device=dev)
    brow = torch.arange(B, device=dev)[:, None] * (S + 1)
    ninf = -float("inf")

    for it in range(max_inst):
        vec = ncut_eigenvectors(fa, fb, painting, invalid, tau=tau, eps=eps,
                                multimodal=multimodal, solver=solver,
                                iters=iters, block=block)
        mean = (vec * valid).sum(-1) / cntv
        bip = (vec > mean[:, None]) & valid
        frac = bip.sum(-1) / cntv
        flip = frac > max_extent_ratio
        bip = torch.where(flip[:, None], valid & ~bip, bip)
        vec = torch.where(flip[:, None], -vec, vec)

        # connected components: neighbour-min + pointer jumping, int32
        # labels (an int64 (B, S, S) intermediate is 103 MB at 64 x 448)
        lab = torch.where(bip, iota[None, :], S)
        adjb = adj & bip[:, :, None] & bip[:, None, :]
        for _ in range(prop_steps):
            nm = torch.where(adjb, lab[:, None, :], S).amin(dim=-1)
            lab = torch.where(bip, torch.minimum(lab, nm), lab)
            ptr = torch.gather(lab, 1, lab.clamp(0, S - 1).long())
            lab = torch.where(bip, torch.minimum(lab, ptr), lab)

        if mode == "all":
            comp = bip
        else:
            # component sizes are counts: integer adds, in any order
            ids = (brow + lab.clamp(0, S)).reshape(-1)
            sizes = torch.zeros(B * (S + 1), dtype=torch.int64, device=dev)
            sizes = sizes.index_add_(0, ids, bip.reshape(-1).long())
            sizes = sizes.reshape(B, S + 1)[:, :S]
            if mode == "max":
                seed = torch.argmax(torch.where(valid, vec, ninf), dim=1,
                                    keepdim=True)
                seed_lab = torch.gather(lab, 1, seed)[:, 0]
                seed_in = torch.gather(bip, 1, seed)[:, 0]
                # seed outside the bipartition -> first component
                fallback = torch.where(bip, lab, S).amin(dim=1)
                chosen = torch.where(seed_in, seed_lab, fallback)
            elif mode == "largest":
                chosen = _first_max(sizes, S)
            else:   # avg: a float sum per component, as a one-hot product
                onehot = (lab[:, :, None] == iota[None, None, :]).to(vec.dtype)
                vsum = ((vec * bip)[:, None, :] @ onehot)[:, 0, :]
                means = vsum / torch.clamp_min(sizes, 1).to(vec.dtype)
                chosen = torch.argmax(torch.where(sizes > 0, means, ninf),
                                      dim=1)
            comp = bip & (lab == chosen[:, None])

        painting = torch.clamp(painting + comp, 0.0, 1.0)
        size = comp.sum(-1)
        inter = (comp & fg).sum(-1)
        iou = inter / torch.clamp_min(size, 1)
        accept = (size > 0) & (iou <= 0.5) & (size >= min_segment_size)
        masks[:, it] = comp & ~fg & accept[:, None]
        fg = fg | (comp & accept[:, None])
    return masks


def _separate(bipartition, vec, unique_segments, connectivity, mode):
    """Connected components of the bipartition under segment adjacency; one
    is picked by the separation mode."""
    comps = separate_segments(bipartition, unique_segments, connectivity)
    if not comps:
        return set()
    if mode == "all":
        return set(unique_segments[bipartition].tolist())
    if mode == "max":
        seed_id = unique_segments[int(np.argmax(vec))]
        for c in comps:
            if seed_id in c:
                return set(int(x) for x in c)
        return set(int(x) for x in comps[0])
    if mode == "avg":
        means = [vec[np.isin(unique_segments, c)].mean() for c in comps]
        return set(int(x) for x in comps[int(np.argmax(means))])
    if mode == "largest":
        sizes = [len(c) for c in comps]
        return set(int(x) for x in comps[int(np.argmax(sizes))])
    raise NotImplementedError(mode)


def generate_scene_masks(aggregated_features, unique_segments, connectivity,
                         segment_ids, scene_coords,
                         cfg: NCutConfig | None = None, device="cuda"):
    """One scene through the greedy loop. aggregated_features: (S, D) or a
    tuple of two; unique_segments (S,); connectivity (E, 2); segment_ids
    (P,); scene_coords (P, 3). Returns (K, S) bool segment-level masks."""
    return BatchedNCut(cfg, device).run(
        [dict(features=aggregated_features, unique_segments=unique_segments,
              connectivity=connectivity, segment_ids=segment_ids,
              coords=scene_coords)])[0]


def _edge_rows(scene: dict, s_pad: int) -> np.ndarray:
    """The scene's segment-id edges as (E', 2) row pairs; edges that name an
    unknown segment are dropped."""
    conn = np.asarray(scene["connectivity"]).reshape(-1, 2)
    uniq = np.asarray(scene["unique_segments"])
    sorter = np.argsort(uniq, kind="stable")
    su = uniq[sorter]
    pos = np.minimum(np.searchsorted(su, conn), len(su) - 1)
    okk = (su[pos] == conn).all(axis=1)
    return sorter[pos[okk]].reshape(-1, 2)


class BatchedNCut:
    """Runs the greedy NCut loop for a list of scenes in lockstep on
    `device`: the whole loop there (`cfg.device_loop`), or one batched
    eigensolve per iteration followed by host-side set logic per scene."""

    def __init__(self, cfg: NCutConfig | None = None, device="cuda"):
        self.cfg = cfg or NCutConfig()
        self.device = resolve_device(device)
        _check_solver(self.cfg.solver)

    def run(self, scenes: list[dict]) -> list[np.ndarray]:
        cfg, dev = self.cfg, self.device
        if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("NCut needs full-f32 matmuls: unset "
                               "torch.backends.cuda.matmul.allow_tf32")
        B = len(scenes)
        multimodal = isinstance(scenes[0]["features"], tuple)
        s_pad = max(len(s["unique_segments"]) for s in scenes)
        s_pad = int(np.ceil(s_pad / 64) * 64)

        def padded(which):
            per_scene = [np.asarray(s["features"][which] if multimodal
                                    else s["features"]) for s in scenes]
            out = np.zeros((B, s_pad, per_scene[0].shape[1]), np.float32)
            for b, f in enumerate(per_scene):
                out[b, :len(f)] = f
            return out

        fa = padded(0)
        invalid = np.ones((B, s_pad), bool)
        for b, s in enumerate(scenes):
            invalid[b, :len(s["unique_segments"])] = False
        # static per batch: uploaded once
        fa_d = torch.from_numpy(fa).to(dev)
        fb_d = torch.from_numpy(padded(1)).to(dev) if multimodal else fa_d
        invalid_d = torch.from_numpy(invalid).to(dev)

        painting = np.zeros((B, s_pad), np.float32)
        results: list[list[np.ndarray]] = [[] for _ in range(B)]
        foreground: list[set] = [set() for _ in range(B)]
        active = np.ones(B, bool)
        # scenes with < 3 segments: one all-ones mask
        for b, s in enumerate(scenes):
            if len(s["unique_segments"]) < 3:
                results[b].append(np.ones(len(s["unique_segments"]), bool))
                active[b] = False

        solver_kw = dict(tau=cfg.affinity_tau, eps=cfg.eps,
                         multimodal=multimodal, solver=cfg.solver,
                         iters=cfg.solver_iters, block=cfg.solver_block)
        with torch.no_grad():
            if cfg.device_loop:
                return self._run_device(scenes, fa_d, fb_d, invalid_d, s_pad,
                                        results, active, solver_kw)
            return self._run_host(scenes, fa_d, fb_d, invalid_d, painting,
                                  results, foreground, active, solver_kw)

    def _run_device(self, scenes, fa_d, fb_d, invalid_d, s_pad, results,
                    active, solver_kw):
        cfg, dev = self.cfg, self.device
        B = len(scenes)
        # segment-id edges -> row-space adjacency, one upload per batch
        rows = [_edge_rows(s, s_pad) for s in scenes]
        bidx = np.concatenate([np.full(len(r), b, np.int64)
                               for b, r in enumerate(rows)])
        edges = torch.from_numpy(np.concatenate(rows).astype(np.int64)).to(dev)
        bidx = torch.from_numpy(bidx).to(dev)
        adj = torch.zeros(B, s_pad, s_pad, dtype=torch.bool, device=dev)
        adj[bidx, edges[:, 0], edges[:, 1]] = True
        adj = adj | adj.transpose(1, 2)
        masks_d = _device_greedy(
            fa_d, fb_d, invalid_d, adj, **solver_kw,
            max_inst=cfg.max_number_of_instances,
            max_extent_ratio=cfg.max_extent_ratio,
            min_segment_size=cfg.min_segment_size, mode=cfg.separation_mode,
            prop_steps=cfg.label_prop_steps).cpu().numpy()
        out = []
        for b, s in enumerate(scenes):
            ns = len(s["unique_segments"])
            rows = ([m[:ns] for m in results[b]] if not active[b]
                    else [m[:ns] for m in masks_d[b] if m.any()])
            out.append(np.stack(rows) if rows else np.zeros((0, ns), bool))
        return out

    def _run_host(self, scenes, fa_d, fb_d, invalid_d, painting, results,
                  foreground, active, solver_kw):
        cfg, dev = self.cfg, self.device
        B = len(scenes)

        def host_step(b, s, vec_row):
            """One scene's per-iteration set logic (flip, separation, IoU
            gate, paint); mutates painting, results and foreground."""
            ns = len(s["unique_segments"])
            vec = vec_row[:ns]
            uniq = np.asarray(s["unique_segments"])
            bipartition = vec > vec.mean()
            # flip when the partition covers too much of the scene
            if (bipartition.sum() / max(len(bipartition), 1)
                    > cfg.max_extent_ratio):
                bipartition = ~bipartition
                vec = -vec
            sep = _separate(bipartition, vec, uniq, s["connectivity"],
                            cfg.separation_mode)
            mask = np.isin(uniq, list(sep))
            # paint the current mask whether or not it is accepted
            painting[b, :ns] = np.clip(painting[b, :ns] + mask, 0, 1)
            if len(sep) == 0:
                return
            iou = len(sep & foreground[b]) / len(sep)
            if iou > 0.5 or len(sep) < cfg.min_segment_size:
                return
            results[b].append(np.isin(uniq, list(sep - foreground[b])))
            foreground[b] |= sep

        # two half-batches pipelined: the device solves one half's
        # eigenproblems while the host runs the other half's set logic
        halves = [np.arange(B)[: B // 2], np.arange(B)[B // 2:]]
        halves = [h for h in halves if len(h)]
        idx_d = [torch.from_numpy(h).to(dev) for h in halves]

        def solve(g):
            idx = idx_d[g]
            return ncut_eigenvectors(
                fa_d[idx], fb_d[idx],
                torch.from_numpy(painting[halves[g]]).to(dev),
                invalid_d[idx], **solver_kw)

        pending = {0: solve(0)}
        iters_left = {g: cfg.max_number_of_instances
                      for g in range(len(halves))}
        while pending:
            for g in list(pending):
                nxt = (g + 1) % len(halves)
                # dispatch the other half before fetching this one
                if (len(halves) > 1 and nxt not in pending
                        and iters_left[nxt] > 0
                        and active[halves[nxt]].any()):
                    pending[nxt] = solve(nxt)
                vecs = pending.pop(g).cpu().numpy()
                for j, b in enumerate(halves[g]):
                    if active[b]:
                        host_step(b, scenes[b], vecs[j])
                iters_left[g] -= 1
                if iters_left[g] > 0 and active[halves[g]].any():
                    pending[g] = solve(g)

        out = []
        for b, s in enumerate(scenes):
            ns = len(s["unique_segments"])
            out.append(np.stack([m[:ns] for m in results[b]]) if results[b]
                       else np.zeros((0, ns), bool))
        return out
