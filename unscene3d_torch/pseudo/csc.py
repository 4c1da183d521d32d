"""CSC (contrastive-scene-context pretrained) 3D feature extraction
(counterpart of unscene3d_tpu/pseudo/csc.py).

Runs Res16UNet34C in the multires call mode, takes the `res_{scale}` feature
map and broadcasts it back to stride 1 down the sparse graph's parent chain
(every stride-1 voxel has one ancestor at every level, so low-res features
are gathered, not nearest-neighbour matched). On the card one scene costs 47
launches of kernel 1 and 8 of kernel 2 (no pools, no segment sum). The
weights come from a converted CSC checkpoint
(`models/torch_convert.py:load_csc_backbone`), from a JAX backbone's
variables (the tests), or else are seeded random ones.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from unscene3d_torch.models.backbone import Res16UNet34C
from unscene3d_torch.models.weights import (init_random_,
                                            load_flax_backbone_variables,
                                            load_state_strict)
from unscene3d_torch.ops.kernel_maps import build_sparse_graph
from unscene3d_torch.ops.sparse_graph import graph_from_levels
from unscene3d_torch.runtime import resolve_device


class CSCFeatureExtractor:
    def __init__(self, variables=None, in_channels: int = 3,
                 resolution_scale: int = 2, num_labels: int = 20,
                 device="cuda", dtype=torch.float32, state_dict=None):
        """resolution_scale: 2^k stride of the feature map to use (res_2 by
        default). state_dict: the port's Res16UNet34C state (a converted
        checkpoint); variables: a stand-alone JAX backbone's `{"params",
        "batch_stats"}` tree; with neither, random weights from seed 0."""
        self.device = resolve_device(device)
        self.resolution_scale = resolution_scale
        self.level = int(np.log2(resolution_scale))
        self.in_channels = in_channels
        self.dtype = dtype
        self.model = Res16UNet34C(out_channels=num_labels,
                                  in_channels=in_channels, dtype=dtype)
        if state_dict is not None:
            load_state_strict(self.model, state_dict, "CSC backbone")
        elif variables is not None:
            load_flax_backbone_variables(self.model, variables)
        else:
            init_random_(self.model, 0)
        self.model.to(self.device).eval()
        # seconds of the last call: the host's graph build, and the upload,
        # forward and download
        self.timings: dict[str, float] = {}

    def __call__(self, coords: np.ndarray, colors: np.ndarray) -> np.ndarray:
        """coords: (N, 3) int voxel coords of one scene; colors: (N, C)
        normalized features. Returns (N, D) f32 per-voxel features of the
        requested resolution, broadcast to stride 1."""
        t0 = time.perf_counter()
        bcoords = np.column_stack([np.zeros(len(coords), np.int32), coords])
        levels = build_sparse_graph(bcoords, num_levels=5)
        t1 = time.perf_counter()
        n0 = len(levels[0]["valid"])
        feats = np.zeros((n0, colors.shape[1]), np.float32)
        feats[:len(coords)] = colors
        graph = graph_from_levels(levels).to(self.device)
        with torch.no_grad():
            _, res = self.model(
                torch.from_numpy(feats).to(self.device, self.dtype), graph,
                multires=True)
        f = res[f"res_{self.resolution_scale}"].float().cpu().numpy()
        self.timings = {"graph": t1 - t0, "forward": time.perf_counter() - t1}
        # broadcast the level's features down the parent chain to stride 1
        idx = np.arange(n0)
        for lv in range(self.level):
            idx = levels[lv]["parent_idx"][idx]
        return f[idx][:len(coords)]
