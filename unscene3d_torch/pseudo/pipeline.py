"""Pseudo-mask generation pipeline (counterpart of
unscene3d_tpu/pseudo/pipeline.py).

Per scene batch: encode features with the 3D CSC multires backbone
(modalities `geom`, `both`) and the 2D DINO ViT projected through the
z-buffer splat (`color`, `both`), pool them onto the scene's segments, run
the batched greedy masked NCut (or the query-key generator), lift the
segment bipartitions to voxels, rebase them to the full-resolution cloud and
save `{scene}_cloud.npy` and `{scene}_masks.npy`. Scenes go through NCut in
lockstep, so the eigensolves batch on the device.

The 2D encoding runs frame by frame on the device: the ViT's features stay
there, each frame is projected there (`projection.project_2d_features`) and
folded into the running per-voxel features, so no frame's features reach
the host: by the reference's pairwise mean (`reference_average=True`, the
default) or, with `reference_average=False`, into a running sum and hit
count, each voxel's mean over the frames that hit it. Weights come from the
checkpoints (`csc_weights`, `dino_weights`), for the CSC also from JAX
variables (`csc_variables`; the tests), or are seeded random ones.
`save_visualizations` writes each saved scene's PLY layers and HTML viewer
under `<save_dir>/visualizations` (eval/visualize.py). `timings` holds the
seconds the last `process_scenes` call spent by stage (the CSC extractor's
host graph build and its forward apart, the ViT and the projection apart).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from scipy.spatial import KDTree

from unscene3d_torch.eval.visualize import save_scene_visualization
from unscene3d_torch.models.encoders_2d.dino import DinoNet, load_dino_weights
from unscene3d_torch.models.torch_convert import load_csc_backbone
from unscene3d_torch.ops.segment_ops import segment_mean
from unscene3d_torch.pseudo.csc import CSCFeatureExtractor
from unscene3d_torch.pseudo.features import aggregate_features
from unscene3d_torch.pseudo.freemask_query import freemask_query_masks
from unscene3d_torch.pseudo.ncut import BatchedNCut, NCutConfig
from unscene3d_torch.pseudo.projection import project_2d_features
from unscene3d_torch.runtime import resolve_device

VOXEL_SIZE = 0.02


class PseudoMaskPipeline:
    def __init__(
        self,
        modality: str = "geom",            # 'geom' | 'color' | 'both'
        method: str = "ncut",              # 'ncut' | 'query'
        ncut_cfg: NCutConfig | None = None,
        csc_weights: str | None = None,
        dino_weights: str | None = None,
        csc_variables=None,                # a JAX backbone's variables tree
        resolution_scale: int = 2,
        aggregation_mode: str = "mean",
        voxel_size: float = VOXEL_SIZE,
        device="cuda",
        dtype=torch.float32,
        reference_average: bool = True,
    ):
        """dtype: the CSC backbone's compute dtype (the ViT runs in f32).
        reference_average: how the 2D features fold over a scene's frames
        (unscene3d_tpu/pseudo/pipeline.py:88-99): the reference's pairwise
        mean, or the mean over each voxel's hit frames."""
        if modality not in ("geom", "color", "both"):
            raise ValueError(f"unknown modality {modality!r}")
        if method not in ("ncut", "query"):
            raise ValueError(f"unknown method {method!r}")
        self.device = resolve_device(device)
        self.modality = modality
        self.method = method
        self.cfg = ncut_cfg or NCutConfig()
        self.aggregation_mode = aggregation_mode
        self.voxel_size = voxel_size
        self.reference_average = bool(reference_average)
        self.csc = None
        if modality in ("geom", "both"):
            self.csc = CSCFeatureExtractor(
                variables=csc_variables, resolution_scale=resolution_scale,
                device=self.device, dtype=dtype,
                state_dict=(load_csc_backbone(csc_weights) if csc_weights
                            else None))
        self.dino = None
        if modality in ("color", "both"):
            self.dino = DinoNet(
                state_dict=(load_dino_weights(dino_weights) if dino_weights
                            else None),
                device=self.device)
        self.timings: dict[str, float] = {}
        # the share of each scene's voxels that a frame hit, last encoded
        self.hit_share: dict[str, float] = {}

    def _clock(self, stage: str, t0: float) -> float:
        """Add the time since t0 to `stage` (after the device has caught
        up) and return the new start."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[stage] = self.timings.get(stage, 0.0) + now - t0
        return now

    def _encode_2d(self, scene: dict) -> np.ndarray:
        """(N, 384) per-voxel DINO features of one scene's frames: each
        frame through the ViT and projected on the device, folded into the
        running features on the voxels a frame hits: the reference's
        pairwise mean, or a sum and a count divided at the end."""
        images, K = scene["images"], scene["intrinsics"]
        if images is None or len(images) == 0:
            raise ValueError(f"{scene['scene_name']}: no frames to encode")
        h, w = images.shape[1:3]
        n = len(scene["coords"])
        dev = self.device
        world = torch.from_numpy(
            (scene["coords"].astype(np.float32) + 0.5) * self.voxel_size
        ).to(dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        poses = torch.from_numpy(
            np.asarray(scene["poses"], np.float32)).to(dev)
        K = torch.from_numpy(np.asarray(K, np.float32)).to(dev)
        acc = torch.zeros(n, self.dino.feature_dim, device=dev)
        hits = torch.zeros(n, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        for i in range(len(images)):
            feats = self.dino(images[i][None])           # (1, h, w, 384)
            t0 = self._clock("dino", t0)
            out, cnt = project_2d_features(feats, world, valid,
                                           poses[i][None], K, h, w)
            hit = cnt > 0
            hits += hit.to(torch.int32)
            if self.reference_average:
                acc = torch.where(hit[:, None], (acc + out) / 2.0, acc)
            else:
                acc = acc + torch.where(hit[:, None], out, 0.0)
            t0 = self._clock("project", t0)
        if not self.reference_average:
            acc = acc / hits.clamp_min(1)[:, None].to(torch.float32)
        self.hit_share[scene["scene_name"]] = (
            (hits > 0).float().mean().item())
        return acc.cpu().numpy()

    def _query_masks(self, inp: dict) -> np.ndarray:
        """The query-key generator on one scene; with two modalities it reads
        the 2D features, as the JAX package does."""
        feats = inp["features"]
        feats = feats[0] if isinstance(feats, tuple) else feats
        uniq = inp["unique_segments"]
        local = np.searchsorted(uniq, inp["segment_ids"])
        seg_coords = segment_mean(torch.from_numpy(inp["coords"]),
                                  torch.from_numpy(local.astype(np.int64)),
                                  len(uniq)).numpy()
        extent = inp["coords"].max(0) - inp["coords"].min(0)
        masks, _ = freemask_query_masks(
            np.asarray(feats), uniq, inp["connectivity"],
            seg_coords, extent,
            instance_to_scene_max_ratio=self.cfg.max_extent_ratio,
            max_instance_num=self.cfg.max_number_of_instances)
        return masks

    def process_scenes(self, scenes: list[dict], save_dir: str | None = None,
                       skip_existing: bool = True,
                       save_visualizations: bool = False) -> dict:
        """scenes: dicts with scene_name, coords (N, 3) int voxel coords,
        feats (N, C), segment_ids and segment_connectivity (one-element
        sequences: (N,) ids and (E, 2) id pairs) and full_coords (P, 3);
        for the 2D modalities also images (V, h, w, 3) in [0, 1], poses
        (V, 4, 4) camera-to-world and intrinsics (3, 3) (as
        data/scannet_pseudo.py gives them). Returns {scene_name: (cloud
        (P, 3) f32, masks (P, K) bool)}; saves both as .npy when save_dir
        is set, skipping scenes whose cloud file exists, and with
        `save_visualizations` the scene's RGB, segment and mask layers
        under save_dir/visualizations."""
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        todo = [s for s in scenes if not (
            save_dir and skip_existing and os.path.exists(
                os.path.join(save_dir, f"{s['scene_name']}_cloud.npy")))]

        self.timings = {}
        t0 = time.perf_counter()
        ncut_inputs = []
        for s in todo:
            seg_ids = np.asarray(s["segment_ids"][0])
            conn = np.asarray(s["segment_connectivity"][0])
            encoded = []                  # 2D first, as the JAX package
            if self.dino is not None:
                encoded.append(self._encode_2d(s))
            if self.csc is not None:
                encoded.append(self.csc(s["coords"], s["feats"]))
                for stage, sec in self.csc.timings.items():
                    self.timings[f"csc_{stage}"] = (
                        self.timings.get(f"csc_{stage}", 0.0) + sec)
            t0 = time.perf_counter()
            feats = []
            for enc in encoded:
                f, uniq = aggregate_features(enc, seg_ids, conn,
                                             self.aggregation_mode)
                feats.append(f)
            ncut_inputs.append(dict(
                features=tuple(feats) if len(feats) == 2 else feats[0],
                unique_segments=uniq, connectivity=conn, segment_ids=seg_ids,
                coords=s["coords"][:, -3:].astype(np.float32)))
            t0 = self._clock("aggregation", t0)

        if self.method == "query":
            bipartitions = [self._query_masks(inp) for inp in ncut_inputs]
        else:
            bipartitions = (BatchedNCut(self.cfg, self.device).run(ncut_inputs)
                            if ncut_inputs else [])
        t0 = self._clock(self.method, t0)

        results = {}
        for s, inp, bip in zip(todo, ncut_inputs, bipartitions):
            # segment-level -> voxel-level masks
            pos = np.searchsorted(inp["unique_segments"], inp["segment_ids"])
            point_masks = bip.T[pos]                    # (N, K)
            # rebase to the full-res cloud (+0.5: voxel centres)
            tree = KDTree(s["coords"].astype(np.float64) + 0.5)
            _, match = tree.query(s["full_coords"] / self.voxel_size, k=1)
            full_masks = point_masks[match]
            cloud = s["full_coords"].astype(np.float32)
            results[s["scene_name"]] = (cloud, full_masks)
            if save_dir:
                np.save(os.path.join(save_dir, f"{s['scene_name']}_cloud.npy"),
                        cloud)
                np.save(os.path.join(save_dir, f"{s['scene_name']}_masks.npy"),
                        full_masks)
                if save_visualizations:
                    # browsable pseudo-mask scenes (reference pyviz3d
                    # export, unscene3d_pseudo_main.py:601-644)
                    save_scene_visualization(
                        os.path.join(save_dir, "visualizations"),
                        s["scene_name"], cloud,
                        colors=s.get("full_colors"),
                        segments=inp["segment_ids"][match],
                        masks=full_masks.astype(bool))
        self._clock("lift_rebase", t0)
        return results
