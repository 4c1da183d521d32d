"""The pseudo-mask row of the benchmark (counterpart of bench.py's
`bench_pseudo`): a batch of scenes of random segment features with chain
connectivity through `BatchedNCut`, one warm run and the median of a few;
and the two agreement criteria of benchmarks/ncut_solver_agreement.py
(`matched_iou`, `object_recovery`) for runs whose masks are compared.

    python3 -m unscene3d_torch.bench.pseudo
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from unscene3d_torch.pseudo.ncut import BatchedNCut, NCutConfig
from unscene3d_torch.runtime import resolve_device


def make_pseudo_scenes(batch_scenes: int = 64, num_segments: int = 400,
                       dim: int = 96, seed: int = 0) -> list[dict]:
    """`batch_scenes` scenes of `num_segments` segments with normal random
    features, chain connectivity and five points per segment."""
    r = np.random.RandomState(seed)
    scenes = []
    for _ in range(batch_scenes):
        s = num_segments
        feats = r.randn(s, dim).astype(np.float32)
        uniq = np.arange(s)
        conn = np.column_stack([np.arange(s - 1), np.arange(1, s)])
        conn = np.vstack([conn, conn[:, ::-1]])
        seg_ids = np.repeat(uniq, 5)
        coords = r.rand(len(seg_ids), 3).astype(np.float32) * 8
        scenes.append(dict(features=feats, unique_segments=uniq,
                           connectivity=conn, segment_ids=seg_ids,
                           coords=coords))
    return scenes


def matched_iou(masks_a, masks_b) -> float:
    """Mean IoU of a greedy best-IoU matching between two sets of masks;
    unmatched masks on either side score 0 (the solver-agreement criterion
    of benchmarks/ncut_solver_agreement.py)."""
    if len(masks_a) == 0 and len(masks_b) == 0:
        return 1.0
    a = [np.asarray(m, bool) for m in masks_a]
    b = [np.asarray(m, bool) for m in masks_b]
    used, scores = set(), []
    for m in a:
        best, best_j = 0.0, None
        for j, n in enumerate(b):
            if j in used:
                continue
            union = (m | n).sum()
            iou = (m & n).sum() / union if union else 0.0
            if iou > best:
                best, best_j = iou, j
        if best_j is not None:
            used.add(best_j)
        scores.append(best)
    scores += [0.0] * (len(b) - len(used))
    return float(np.mean(scores)) if scores else 1.0


def object_recovery(masks, objects, iou_thresh: float = 0.75) -> float:
    """Fraction of planted objects (sets of segment indices) that some mask
    recovers at IoU >= iou_thresh (the quality criterion of
    benchmarks/ncut_solver_agreement.py)."""
    if not objects:
        return 1.0
    hit = 0
    for o in objects:
        o = np.asarray(sorted(o))
        for m in masks:
            m = np.asarray(m, bool)
            inter = m[o].sum()
            union = m.sum() + len(o) - inter
            if union and inter / union >= iou_thresh:
                hit += 1
                break
    return hit / len(objects)


def bench_pseudo(device="cuda", batch_scenes: int = 64,
                 num_segments: int = 400, cfg: NCutConfig | None = None,
                 runs: int = 3, scenes: list[dict] | None = None,
                 log=print) -> dict:
    """Returns {"ms_per_scene" (median of `runs` after one warm run),
    "masks" (of the last run), "runs_ms", "first_ms" (the warm run)}; host
    clock around runs that end with the masks on the host."""
    device = resolve_device(device)
    cfg = cfg or NCutConfig()
    if scenes is None:
        scenes = make_pseudo_scenes(batch_scenes, num_segments)
    runner = BatchedNCut(cfg, device)
    t0 = time.perf_counter()
    masks = runner.run(scenes)          # warm
    first_ms = 1e3 * (time.perf_counter() - t0)
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        masks = runner.run(scenes)
        times.append(1e3 * (time.perf_counter() - t0))
    ms = statistics.median(times) / len(scenes) if times else float("nan")
    log(f"pseudo ({cfg.solver}, device_loop={cfg.device_loop}, {device}): "
        f"{len(scenes)} scenes x {len(scenes[0]['unique_segments'])} segs, "
        f"first run {first_ms:.1f}ms, {ms:.3f}ms/scene (median of {runs})")
    return dict(ms_per_scene=ms, masks=masks, runs_ms=times,
                first_ms=first_ms)


if __name__ == "__main__":
    bench_pseudo("cuda")
