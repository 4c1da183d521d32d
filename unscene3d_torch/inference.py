"""Per-scene eval inference, the port's entry point (the role of
unscene3d_tpu/train/experiment.py:Experiment.evaluate's per-scene path with
host post-processing).

Each request: scene dict -> host collate -> host-to-device copy -> Mask3D eval
forward -> `eval/postprocess.py:eval_scene_predictions` (the port's own numpy
and scipy copy) with the defaults of
conf/config_base_instance_segmentation.yaml ->
{masks (P, K) bool, classes (K,), scores (K,)} over the scene's points.

    predictor = Predictor(build_mask3d(torch.bfloat16), "cuda")
    result = predictor(scene)

`csr_levels` is the collator's `data.csr_levels` (conf/data/indoor.yaml): at
those levels the batch carries valid-pair tables and every k3 conv runs
through kernel 6 (ops/csr_conv.py) instead of kernel 1.
"""

from __future__ import annotations

import torch

from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.eval.postprocess import eval_scene_predictions
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


def postprocess(out: dict, meta) -> dict:
    """Host post-processing of one single-scene forward."""
    n_vox = meta.num_voxels[0]
    logits = out["pred_logits"][-1][0].float().cpu().numpy()
    vox = out["pred_masks_vox"][-1][:n_vox].float().cpu().numpy()
    return eval_scene_predictions(
        logits, vox, inverse_map=meta.inverse_maps[0],
        point2segment_full=meta.original_segments[0],
        segment_connectivity=meta.segment_connectivity[0], **EVAL_DEFAULTS)


class Predictor:
    """Answers one scene per call on `device` ('cuda' needs a GPU and
    raises without one; 'cpu' runs the kernels' plain twins)."""

    def __init__(self, model: Mask3D, device="cuda", voxel_size: float = 0.02,
                 fine_buckets: bool = True, csr_levels: tuple = ()):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.collator = FreeMaskCollator(voxel_size=voxel_size,
                                         fine_buckets=fine_buckets,
                                         fps_queries=model.num_queries,
                                         csr_levels=csr_levels)

    def forward(self, scene: dict):
        """(raw model outputs on the device, collate meta)."""
        batch, meta = self.collator([scene])
        batch = batch.to(self.device)
        return self.model(batch), meta

    def __call__(self, scene: dict) -> dict:
        return postprocess(*self.forward(scene))
