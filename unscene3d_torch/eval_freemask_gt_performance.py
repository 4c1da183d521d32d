"""Pseudo-mask quality against the GT instances (the port's counterpart of
the repository's eval_freemask_gt_performance.py; reference
pseudo_masks/eval_freemask_gt_performance.py:22-100).

Loads the `{scene}_cloud.npy` / `{scene}_masks.npy` pseudo masks through
`ScanNetFreeDataset` (hard threshold and XY extent filter), matches them to
the scannet200_insseg GT clouds and prints class-agnostic AP / AP50 / AP25
(min_region 10, as the pseudo app's Evaluator), the JAX CLI's line:

  python -m unscene3d_torch.eval_freemask_gt_performance \\
      --masks_dir outputs/unscene3d_dino_csc \\
      --gt_dir data/ScanNet/scannet_200_insseg [--phase val] [--max_scenes N]

Host-side numpy; no device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
from scipy.spatial import KDTree

from unscene3d_torch.data.pseudo_datasets import ScanNetFreeDataset
from unscene3d_torch.eval.instance_eval import evaluate_instances


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--masks_dir", required=True)
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--phase", default="val")
    ap.add_argument("--max_scenes", type=int, default=-1)
    ap.add_argument("--hard_mask_threshold", type=float, default=0.5)
    ap.add_argument("--max_extent_ratio", type=float, default=0.8,
                    help="ScanNetFree XY instance-to-scene extent filter "
                         "(scannet_free.py:322-338); <=0 disables")
    return ap.parse_args(argv)


def ap_line(res: dict) -> str:
    return (f"AP {res['all_ap']:.4f}  AP50 {res['all_ap_50%']:.4f}  "
            f"AP25 {res['all_ap_25%']:.4f}")


def main(argv=None) -> dict:
    """Print one line per scene and the AP line; return {"results": the
    AP dict or None, "scenes": count, "seconds": wall time}."""
    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    t0 = time.perf_counter()
    split_file = os.path.join(args.gt_dir, f"{args.phase}.txt")
    if os.path.exists(split_file):
        with open(split_file) as f:
            scenes = [ln.strip() for ln in f if ln.strip()]
    else:
        scenes = sorted(p.stem.replace("_cloud", "")
                        for p in Path(args.masks_dir).glob("*_cloud.npy"))
    if args.max_scenes > 0:
        scenes = scenes[: args.max_scenes]

    # reference-faithful mask loading: hard threshold + extent filter
    # through the ScanNetFree data set (eval_freemask_gt_performance.py:
    # 43-47), scoring the pseudo masks (not the oracle)
    dataset = ScanNetFreeDataset(
        masks_path=args.masks_dir, scannet_insseg_path=args.gt_dir,
        phase=args.phase, oracle_mode=False,
        hard_mask_threshold=args.hard_mask_threshold,
        instance_to_scene_max_ratio=(args.max_extent_ratio
                                     if args.max_extent_ratio > 0 else 1e9))

    preds, gts = {}, {}
    for scene in scenes:
        cloud_p = os.path.join(args.masks_dir, f"{scene}_cloud.npy")
        gt_p = os.path.join(args.gt_dir, f"{scene}.pth")
        if not (os.path.exists(cloud_p) and os.path.exists(gt_p)):
            continue
        cloud = np.load(cloud_p)
        _, _, _, _, masks = dataset.load_unsupervised_scene(scene)
        points, _, _, inst = [np.asarray(x) for x in torch.load(
            gt_p, map_location="cpu", weights_only=False)[:4]]
        if len(points) != len(cloud):
            _, match = KDTree(cloud[:, :3]).query(points, k=1)
            masks = masks[match]
        # class-agnostic GT: every annotated instance is 'foreground'
        gt = np.where(inst >= 0, 1000 + inst.astype(np.int64) + 1, 0)
        k = masks.shape[1]
        preds[scene] = {
            "masks": masks,
            "classes": np.ones(k, np.int64),
            # ranked by emission order, as the JAX CLI
            "scores": np.linspace(0.9, 0.5, max(k, 1))[:k],
        }
        gts[scene] = gt
        print(f"{scene}: {k} masks, {len(np.unique(inst[inst >= 0]))} gt")

    if not preds:
        print("no scenes evaluated")
        return {"results": None, "scenes": 0,
                "seconds": time.perf_counter() - t0}
    res = evaluate_instances(preds, gts, min_region_size=10)
    print(f"{ap_line(res)}  ({len(preds)} scenes)")
    return {"results": res, "scenes": len(preds),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
