"""Pseudo-mask entry point of the port (the counterpart of the repository's
pseudo_masks_main.py, reference pseudo_masks/unscene3d_pseudo_main.py:
532-667).

It takes the reference scripts' overrides unchanged, composes the
repository's conf/pseudo/default.yaml with the port's own loader and runs on
the GPU unless the override `misc.device=cpu` asks for the CPU:

  python -m unscene3d_torch.pseudo_masks_main freemask.modality=both \\
      data.scannet_path=data/ScanNet/scannet_200_insseg \\
      net.weights_for_inner_model=model_weights/CSC_train_Res16UNet34C_2cm.pth \\
      image_data.model_checkpoint=model_weights/dino_deitsmall8_pretrain.pth \\
      misc.save_dir=outputs/unscene3d_dino_csc

Scenes go through the pipeline in batches of `data.batch_size`, so the NCut
eigensolves batch on the device. Each host takes the strided slice
`misc.shard` of `misc.num_shards`; a scene whose `{scene}_cloud.npy` exists
is skipped, so shards and reruns never conflict.
"""

from __future__ import annotations

import os
import sys

_CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "conf", "pseudo", "default.yaml")


def load_parameters(overrides):
    """conf/pseudo/default.yaml composed with `overrides`."""
    from unscene3d_torch.config import load_config

    return load_config(_CONF, overrides, conf_dir=os.path.dirname(_CONF))


def main(argv=None):
    """Make the pseudo masks of the configured split; returns the
    pipeline (its `timings` are the last batch's)."""
    from unscene3d_torch.data.scannet_pseudo import ScanNetPseudoDataset
    from unscene3d_torch.pseudo.ncut import NCutConfig
    from unscene3d_torch.pseudo.pipeline import PseudoMaskPipeline

    cfg = load_parameters(sys.argv[1:] if argv is None else argv)
    dataset = ScanNetPseudoDataset(
        scannet_insseg_path=cfg.data.scannet_path,
        scans_path=cfg.data.scannet_images_path,
        phase=cfg.train.train_phase,
        align_scenes=bool(cfg.data.align_scenes),
        segmentation_threshold=float(cfg.data.segmentation_threshold),
        segments_min_vert_nums=tuple(cfg.data.segments_min_vert_nums),
        use_images=bool(cfg.image_data.use_images)
        or cfg.freemask.modality in ("color", "both"),
        image_resolution=tuple(cfg.image_data.image_resolution),
        downsample_ratio=float(cfg.image_data.downsample_ratio),
    )
    pipeline = PseudoMaskPipeline(
        modality=cfg.freemask.modality,
        method=cfg.freemask.get("method", "ncut"),
        ncut_cfg=NCutConfig(
            affinity_tau=float(cfg.freemask.affinity_tau),
            max_number_of_instances=int(cfg.freemask.max_instance_num),
            similarity_metric=cfg.freemask.similarity_metric,
            max_extent_ratio=float(cfg.freemask.max_extent_ratio),
            min_segment_size=int(cfg.freemask.min_segment_size),
            separation_mode=cfg.freemask.separation_mode,
        ),
        csc_weights=cfg.net.weights_for_inner_model,
        dino_weights=cfg.image_data.model_checkpoint,
        resolution_scale=int(cfg.freemask.resolution_scale),
        aggregation_mode=cfg.freemask.aggregation_mode,
        device=cfg.misc.get("device") or "cuda",
    )

    save_dir = cfg.misc.save_dir
    bs = int(cfg.data.batch_size)
    num_shards = int(cfg.misc.get("num_shards", 1) or 1)
    shard = int(cfg.misc.get("shard", 0) or 0)
    indices = list(range(shard, len(dataset), num_shards))
    n = len(indices)
    if num_shards > 1:
        print(f"[shard {shard}/{num_shards}] {n} of {len(dataset)} scenes")
    for start in range(0, n, bs):
        scenes = [dataset[indices[i]]
                  for i in range(start, min(start + bs, n))]
        results = pipeline.process_scenes(
            scenes, save_dir=save_dir,
            save_visualizations=bool(cfg.misc.get("save_visualizations")))
        done = ", ".join(f"{k}:{v[1].shape[1]}m" for k, v in results.items())
        print(f"[{start + len(scenes)}/{n}] {done}", flush=True)
    return pipeline


if __name__ == "__main__":
    main()
