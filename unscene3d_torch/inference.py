"""Per-scene eval inference, the port's entry point (the role of
unscene3d_tpu/train/experiment.py:Experiment.evaluate's per-scene path).

Each request: scene dict -> host collate (the native library's k3 maps and
FPS seeds) -> host-to-device copy -> Mask3D eval forward -> post-processing
with the defaults of conf/config_base_instance_segmentation.yaml ->
{masks (P, K) bool, classes (K,), scores (K,)} over the scene's points.
The post-processing takes the reference's two routes
(experiment.py:744-749): by default the device packs the outputs
(`eval/device_post.py:pack_eval_outputs`: softmax, sigmoid mask scores,
bit-packed masks), the host copies back those three arrays and runs the
tail in segment space (`Predictor.tail`, one `SegmentVote` per
request); with `use_dbscan` the (N, Q) voxel logits come to the host and
each query is split into its DBSCAN clusters first (`postprocess`, the
full-resolution route, as experiment.py:853-862).

    predictor = Predictor(build_mask3d(torch.bfloat16), "cuda")
    result = predictor(scene)

`csr_levels` is the collator's `data.csr_levels` (conf/data/indoor.yaml): at
those levels the batch carries valid-pair tables and every k3 conv runs
through kernel 6 (ops/csr_conv.py) instead of kernel 1.
"""

from __future__ import annotations

import torch

from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.eval.device_post import pack_eval_outputs, to_host
from unscene3d_torch.eval.postprocess import (eval_scene_predictions,
                                              eval_scene_predictions_packed)
from unscene3d_torch.models import backbone as backbones
from unscene3d_torch.models.mask3d import Mask3D
from unscene3d_torch.models.weights import init_random_
from unscene3d_torch.runtime import resolve_device

# conf/config_base_instance_segmentation.yaml (general.*)
EVAL_DEFAULTS = dict(eval_on_segments=True, topk_per_image=-1,
                     filter_instances=False, iou_threshold=1.0,
                     scores_threshold=0.0, separate_instances=False)


def build_mask3d(dtype=torch.float32, backbone: str = "Res16UNet34C",
                 seed: int | None = 0, **kw) -> Mask3D:
    """Mask3D over `backbone` at conf/model/mask3d.yaml's widths (hidden
    128, 100 queries, 8 heads, FFN 1024, 3 shared decoders, hlevels 0-3,
    num_classes 3), with seeded random weights unless seed is None, in eval
    mode. Params are stored in the compute dtype (train/loop.py builds f32
    masters instead)."""
    cfg = dict(num_classes=3, hidden_dim=128, num_queries=100, num_heads=8,
               dim_feedforward=1024, num_decoders=3, hlevels=(0, 1, 2, 3))
    cfg.update(kw)
    bb = getattr(backbones, backbone)(out_channels=2, dtype=dtype)
    model = Mask3D(backbone=bb, dtype=dtype, **cfg)
    if seed is not None:
        init_random_(model, seed)
    return model.eval()


def postprocess(out: dict, meta, vox_coords=None, dbscan_eps: float = 0.95,
                dbscan_min_points: int = 1) -> dict:
    """Host post-processing of one single-scene forward over its (N, Q)
    voxel logits, at full resolution; with `vox_coords` (the scene's
    (n_vox, 3) raw coords) each query is split into DBSCAN clusters first."""
    n_vox = meta.num_voxels[0]
    logits = out["pred_logits"][-1][0].float().cpu().numpy()
    vox = out["pred_masks_vox"][-1][:n_vox].float().cpu().numpy()
    return eval_scene_predictions(
        logits, vox, inverse_map=meta.inverse_maps[0],
        point2segment_full=meta.original_segments[0],
        segment_connectivity=meta.segment_connectivity[0],
        use_dbscan=vox_coords is not None, vox_coords=vox_coords,
        dbscan_eps=dbscan_eps, dbscan_min_points=dbscan_min_points,
        **EVAL_DEFAULTS)


class Predictor:
    """Answers one scene per call on `device` ('cuda' needs a GPU and
    raises without one; 'cpu' runs the kernels' plain twins). `use_dbscan`
    takes the host route with the DBSCAN query split (general.use_dbscan,
    dbscan_eps, dbscan_min_points of the reference's config)."""

    def __init__(self, model: Mask3D, device="cuda", voxel_size: float = 0.02,
                 fine_buckets: bool = True, csr_levels: tuple = (),
                 use_dbscan: bool = False, dbscan_eps: float = 0.95,
                 dbscan_min_points: int = 1):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.collator = FreeMaskCollator(voxel_size=voxel_size,
                                         fine_buckets=fine_buckets,
                                         fps_queries=model.num_queries,
                                         csr_levels=csr_levels)
        self.use_dbscan = bool(use_dbscan)
        self.dbscan_eps = float(dbscan_eps)
        self.dbscan_min_points = int(dbscan_min_points)

    def run(self, scene: dict):
        """(raw model outputs, the batch on the device, collate meta)."""
        batch, meta = self.collator([scene])
        batch = batch.to(self.device)
        return self.model(batch), batch, meta

    def pack(self, out: dict, batch) -> dict:
        """The device-post route's first stage: the arrays that the host
        copies back, still on the device."""
        return pack_eval_outputs(out, batch.graph.levels[0].valid)

    def tail(self, host: dict, meta) -> dict:
        """The device-post route's host tail over `to_host(self.pack(...))`,
        in segment space (one `SegmentVote` per request)."""
        return eval_scene_predictions_packed(
            host["probs"], host["mask_scores"], host["packed"],
            meta.num_voxels[0], inverse_map=meta.inverse_maps[0],
            point2segment_full=meta.original_segments[0],
            segment_connectivity=meta.segment_connectivity[0],
            **EVAL_DEFAULTS)

    def post(self, out: dict, batch, meta) -> dict:
        """The instances of one forward, by this predictor's route."""
        if self.use_dbscan:
            n_vox = meta.num_voxels[0]
            return postprocess(
                out, meta, vox_coords=batch.raw_coords[:n_vox].cpu().numpy(),
                dbscan_eps=self.dbscan_eps,
                dbscan_min_points=self.dbscan_min_points)
        return self.tail(to_host(self.pack(out, batch)), meta)

    def __call__(self, scene: dict) -> dict:
        return self.post(*self.run(scene))
