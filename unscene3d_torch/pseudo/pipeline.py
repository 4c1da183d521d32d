"""Pseudo-mask generation pipeline (counterpart of
unscene3d_tpu/pseudo/pipeline.py).

Per scene batch: encode features with the 3D CSC multires backbone, pool
them onto the scene's segments, run the batched greedy masked NCut (or the
query-key generator), lift the segment bipartitions to voxels, rebase them
to the full-resolution cloud and save `{scene}_cloud.npy` and
`{scene}_masks.npy`. Scenes go through NCut in lockstep, so the eigensolves
batch on the device.

Ported: the `geom` modality with `method` 'ncut' and 'query'. The 'color'
and 'both' modalities need the DINO ViT encoder (models/encoders_2d), which
is not ported, and raise NotImplementedError, as do `save_visualizations`
and `csc_weights` (the checkpoint loader waits for a file the repository
does not hold). `timings` holds the seconds the last `process_scenes` call
spent by stage (the CSC extractor's host graph build and its forward apart).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from scipy.spatial import KDTree

from unscene3d_torch.ops.segment_ops import segment_mean
from unscene3d_torch.pseudo.csc import CSCFeatureExtractor
from unscene3d_torch.pseudo.features import aggregate_features
from unscene3d_torch.pseudo.freemask_query import freemask_query_masks
from unscene3d_torch.pseudo.ncut import BatchedNCut, NCutConfig
from unscene3d_torch.runtime import resolve_device

VOXEL_SIZE = 0.02


class PseudoMaskPipeline:
    def __init__(
        self,
        modality: str = "geom",            # 'geom' ('color' | 'both' wait)
        method: str = "ncut",              # 'ncut' | 'query'
        ncut_cfg: NCutConfig | None = None,
        csc_weights: str | None = None,
        csc_variables=None,                # a JAX backbone's variables tree
        resolution_scale: int = 2,
        aggregation_mode: str = "mean",
        voxel_size: float = VOXEL_SIZE,
        device="cuda",
        dtype=torch.float32,
    ):
        if modality in ("color", "both"):
            raise NotImplementedError(
                f"modality {modality!r} needs the DINO ViT encoder "
                "(models/encoders_2d/dino.py), which is not ported yet")
        if modality != "geom":
            raise ValueError(f"unknown modality {modality!r}")
        if method not in ("ncut", "query"):
            raise ValueError(f"unknown method {method!r}")
        if csc_weights:
            raise NotImplementedError(
                "loading the CSC checkpoint (load_csc_backbone) is not "
                "ported yet; pass csc_variables or use seeded random weights")
        self.device = resolve_device(device)
        self.modality = modality
        self.method = method
        self.cfg = ncut_cfg or NCutConfig()
        self.aggregation_mode = aggregation_mode
        self.voxel_size = voxel_size
        self.csc = CSCFeatureExtractor(
            variables=csc_variables, resolution_scale=resolution_scale,
            device=self.device, dtype=dtype)
        self.timings: dict[str, float] = {}

    def _clock(self, stage: str, t0: float) -> float:
        """Add the time since t0 to `stage` (after the device has caught
        up) and return the new start."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[stage] = self.timings.get(stage, 0.0) + now - t0
        return now

    def _query_masks(self, inp: dict) -> np.ndarray:
        uniq = inp["unique_segments"]
        local = np.searchsorted(uniq, inp["segment_ids"])
        seg_coords = segment_mean(torch.from_numpy(inp["coords"]),
                                  torch.from_numpy(local.astype(np.int64)),
                                  len(uniq)).numpy()
        extent = inp["coords"].max(0) - inp["coords"].min(0)
        masks, _ = freemask_query_masks(
            np.asarray(inp["features"]), uniq, inp["connectivity"],
            seg_coords, extent,
            instance_to_scene_max_ratio=self.cfg.max_extent_ratio,
            max_instance_num=self.cfg.max_number_of_instances)
        return masks

    def process_scenes(self, scenes: list[dict], save_dir: str | None = None,
                       skip_existing: bool = True,
                       save_visualizations: bool = False) -> dict:
        """scenes: dicts with scene_name, coords (N, 3) int voxel coords,
        feats (N, C), segment_ids and segment_connectivity (one-element
        sequences: (N,) ids and (E, 2) id pairs) and full_coords (P, 3).
        Returns {scene_name: (cloud (P, 3) f32, masks (P, K) bool)}; saves
        both as .npy when save_dir is set, skipping scenes whose cloud
        file exists."""
        if save_visualizations:
            raise NotImplementedError(
                "save_visualizations needs eval/visualize.py, which is not "
                "ported yet")
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
            encoded = self.csc(s["coords"], s["feats"])
            for stage, sec in self.csc.timings.items():
                self.timings[f"csc_{stage}"] = (
                    self.timings.get(f"csc_{stage}", 0.0) + sec)
            t0 = time.perf_counter()
            feats, uniq = aggregate_features(encoded, seg_ids, conn,
                                             self.aggregation_mode)
            ncut_inputs.append(dict(
                features=feats, unique_segments=uniq, connectivity=conn,
                segment_ids=seg_ids,
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
        self._clock("lift_rebase", t0)
        return results
