"""Geometric clustering baseline against the GT (the port's counterpart of
the repository's eval_3duis_performance.py; reference
pseudo_masks/eval_3duis_performance.py): HDBSCAN over each scene's points,
voxel-downsampled, as a no-learning unsupervised-instance baseline, scored
with the class-agnostic AP of the pseudo masks. It prints the JAX CLI's
lines:

  python -m unscene3d_torch.eval_3duis_performance \\
      --gt_dir data/ScanNet/scannet_200_insseg \\
      [--phase val] [--max_scenes N] [--min_cluster_size 20]

HDBSCAN is the port's own (pseudo/hdbscan.py, labels equal to
scikit-learn's), with its spanning tree in the native host library.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from unscene3d_torch.eval.instance_eval import evaluate_instances
from unscene3d_torch.eval_freemask_gt_performance import ap_line
from unscene3d_torch.ops.hashing import sparse_quantize
from unscene3d_torch.pseudo.freemask_utils import lidar_3duis


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt_dir", required=True)
    ap.add_argument("--phase", default="val")
    ap.add_argument("--max_scenes", type=int, default=-1)
    ap.add_argument("--min_cluster_size", type=int, default=20)
    ap.add_argument("--voxel_size", type=float, default=0.05,
                    help="clustering resolution (downsample before HDBSCAN)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Print one line per scene and the AP line; return {"results": the
    AP dict or None, "scenes", "seconds": wall time, "hdbscan_seconds",
    "voxels": clustered points per scene}."""
    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    t0 = time.perf_counter()
    split_file = os.path.join(args.gt_dir, f"{args.phase}.txt")
    if os.path.exists(split_file):
        with open(split_file) as f:
            scenes = [ln.strip() for ln in f]
    else:
        scenes = sorted(p[:-4] for p in os.listdir(args.gt_dir)
                        if p.endswith(".pth"))
    if args.max_scenes > 0:
        scenes = scenes[: args.max_scenes]

    preds, gts = {}, {}
    hdb_s, voxels = 0.0, []
    for scene in scenes:
        path = os.path.join(args.gt_dir, f"{scene}.pth")
        if not os.path.exists(path):
            continue
        points, _, _, inst = [np.asarray(x) for x in torch.load(
            path, map_location="cpu", weights_only=False)[:4]]
        _, unique_map, inverse_map = sparse_quantize(points, args.voxel_size)
        th = time.perf_counter()
        labels_vox = lidar_3duis(points[unique_map],
                                 min_cluster_size=args.min_cluster_size)
        hdb_s += time.perf_counter() - th
        voxels.append(len(unique_map))
        labels = labels_vox[inverse_map]
        ids = np.unique(labels[labels >= 0])
        masks = (np.stack([labels == i for i in ids], 1) if len(ids)
                 else np.zeros((len(points), 0), bool))
        preds[scene] = {
            "masks": masks,
            "classes": np.ones(len(ids), np.int64),
            "scores": np.linspace(0.9, 0.5, max(len(ids), 1))[: len(ids)],
        }
        gts[scene] = np.where(inst >= 0, 1000 + inst.astype(np.int64) + 1, 0)
        print(f"{scene}: {len(ids)} clusters")

    res = None
    if preds:
        res = evaluate_instances(preds, gts, min_region_size=10)
        print(ap_line(res))
    return {"results": res, "scenes": len(preds),
            "seconds": time.perf_counter() - t0, "hdbscan_seconds": hdb_s,
            "voxels": voxels}


if __name__ == "__main__":
    main()
