"""2D instance masks (e.g. CutLER's) projected into 3D and scored against
the GT (the port's counterpart of the repository's eval_cutler_projection.py;
reference pseudo_masks/eval_cutler_projection_performance.py and
eval_cutler_images.py): per frame, each 2D mask id is splat onto the
visible points through the z-buffer projection (pseudo/projection.py, on
the card unless `--device cpu`), every point takes its frame's id, and the
instances are merged across frames by point overlap on the host. It prints
the JAX CLI's lines:

  python -m unscene3d_torch.eval_cutler_projection --masks_dir cutler_outputs \\
      --gt_dir data/ScanNet/scannet_200_insseg --scans_dir data/ScanNet/scans

masks_dir layout: {scene}/{frame}.png (uint8/16 instance-id maps, 0 = none).
The scenes are those of `dataset_sets.val_scenes` when a split file is
found, else every scene with a mask directory. `--device cuda` (the
default) raises without a GPU. The projection rounds alike on the CPU and
the card, so both give the same per-frame ids.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from unscene3d_torch.data.dataset_sets import val_scenes
from unscene3d_torch.data.scannet_pseudo import ScanNetPseudoDataset
from unscene3d_torch.eval.instance_eval import evaluate_instances
from unscene3d_torch.eval_freemask_gt_performance import ap_line
from unscene3d_torch.pseudo.projection import project_2d_features
from unscene3d_torch.runtime import resolve_device


def project_frame_masks(mask_img, world_pts, pose, K, device="cuda"):
    """(P,) int64 2D instance id of every point for one frame (0 = none):
    the one-hot id maps projected with `project_2d_features` on `device`
    (`world_pts` a numpy array or a tensor already there)."""
    dev = resolve_device(device)
    h, w = mask_img.shape
    ids = np.unique(mask_img)
    ids = ids[ids > 0]
    if len(ids) == 0:
        return np.zeros(len(world_pts), np.int64)
    img = torch.as_tensor(np.asarray(mask_img).astype(np.int64), device=dev)
    onehot = (img[None, :, :, None] == torch.as_tensor(
        ids.astype(np.int64), device=dev)).to(torch.float32)
    pts = torch.as_tensor(world_pts, dtype=torch.float32, device=dev)
    feats, cnt = project_2d_features(
        onehot, pts, torch.ones(len(pts), dtype=torch.bool, device=dev),
        torch.as_tensor(pose[None], dtype=torch.float32, device=dev),
        torch.as_tensor(K, dtype=torch.float32, device=dev), h, w)
    best = feats.argmax(-1)
    hit = (cnt > 0) & (feats.amax(-1) > 0.5)
    best, hit = best.cpu().numpy(), hit.cpu().numpy()
    return np.where(hit, ids[best], 0).astype(np.int64)


def merge_instances(per_frame_ids: list[np.ndarray], min_overlap: float = 0.3,
                    min_size: int = 50) -> np.ndarray:
    """Greedy cross-frame merge by point overlap; returns (N, K) bool
    masks."""
    masks = []
    for ids in per_frame_ids:
        for i in np.unique(ids[ids > 0]):
            m = ids == i
            if m.sum() < min_size:
                continue
            merged = False
            for k, existing in enumerate(masks):
                inter = (m & existing).sum()
                if inter / min(m.sum(), existing.sum()) > min_overlap:
                    masks[k] = existing | m
                    merged = True
                    break
            if not merged:
                masks.append(m)
    return (np.stack(masks, 1) if masks
            else np.zeros((len(per_frame_ids[0]), 0), bool))


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--masks_dir", required=True)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--scans_dir", required=True)
    ap.add_argument("--max_scenes", type=int, default=-1)
    ap.add_argument("--frame_skip", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="where the projection runs: cuda (default; raises "
                         "without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Print one line per scene and the AP line; return {"results": the AP
    dict or None, "scenes", "frames", "seconds": wall time,
    "project_seconds": the projections' wall time, "per_frame": {scene:
    [(P,) ids per frame]}}."""
    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    from PIL import Image

    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    ds = ScanNetPseudoDataset(args.gt_dir, scans_path=args.scans_dir,
                              frame_skip=args.frame_skip)
    # the fixed validation subset when a split file is found (reference
    # eval_cutler_images.py:79 uses the constants' VAL_SCENES)
    fixed_val = set(val_scenes(args.gt_dir))
    scenes = [s for s in ds.scenes
              if os.path.isdir(os.path.join(args.masks_dir, s))
              and (not fixed_val or s in fixed_val)]
    if args.max_scenes > 0:
        scenes = scenes[: args.max_scenes]

    preds, gts, per_frame_all = {}, {}, {}
    proj_s, frames = 0.0, 0
    for scene in scenes:
        points, _, _, inst = ds.get_full_cloud(scene)
        base = os.path.join(args.scans_dir, scene)
        K = np.loadtxt(os.path.join(base, "intrinsic",
                                    "intrinsic_color.txt"))[:3, :3]
        pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
        per_frame = []
        for mask_file in sorted(Path(args.masks_dir, scene).glob("*.png")):
            img = np.asarray(Image.open(mask_file))
            pose = np.loadtxt(os.path.join(base, "pose",
                                           mask_file.stem + ".txt"))
            scale = np.array([img.shape[1] / 1296.0, img.shape[0] / 968.0,
                              1.0])
            tp = time.perf_counter()
            per_frame.append(project_frame_masks(img, pts, pose,
                                                 K * scale[:, None], dev))
            proj_s += time.perf_counter() - tp
        if not per_frame:
            continue
        frames += len(per_frame)
        per_frame_all[scene] = per_frame
        masks = merge_instances(per_frame)
        k = masks.shape[1]
        preds[scene] = {"masks": masks, "classes": np.ones(k, np.int64),
                        "scores": np.linspace(0.9, 0.5, max(k, 1))[:k]}
        gts[scene] = np.where(inst >= 0, 1000 + inst.astype(np.int64) + 1, 0)
        print(f"{scene}: {k} projected instances")

    res = None
    if preds:
        res = evaluate_instances(preds, gts, min_region_size=10)
        print(ap_line(res))
    return {"results": res, "scenes": len(preds), "frames": frames,
            "seconds": time.perf_counter() - t0, "project_seconds": proj_s,
            "per_frame": per_frame_all}


if __name__ == "__main__":
    main()
