"""The device half of the eval post-processing (the port of
unscene3d_tpu/train/loop.py:Trainer.build_eval_step_device_post): from the
last decoder's outputs, on the tensors' device, the class probabilities, the
per-query sigmoid mask scores and the binary voxel masks bit-packed 8 rows to
a byte, most significant bit first, exactly as `np.packbits(binary, axis=0)`.
The host then copies back ~2.6 MB for a 200k-voxel scene instead of the (N, Q)
f32 logits (~80 MB) and runs the tail in segment space
(`eval/postprocess.py:eval_scene_predictions_packed`).

The reference computes this in plain XLA with no Pallas kernel, and these
are plain torch ops: softmax, sigmoid, compare, and sums over dims, none of
which uses atomics on the card.
"""

from __future__ import annotations

import torch

# shifts of rows 0..7 within a byte, MSB first (np.packbits' order)
_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)


def pack_eval_outputs(out: dict, valid: torch.Tensor) -> dict:
    """out: Mask3D eval outputs of one scene; valid: (N_pad,) bool, level 0's
    `LevelGraph.valid` (padding rows pack as 0 bits and add nothing to a
    score). Returns dict(probs (Q, C) f32 with the no-object column,
    mask_scores (Q,) f32, packed (ceil(N_pad / 8), Q) uint8), on out's
    device."""
    logits = out["pred_logits"][-1][0]            # (Q, C)
    vox = out["pred_masks_vox"][-1]               # (N_pad, Q)
    probs = torch.softmax(logits.float(), dim=-1)
    binary = (vox > 0) & valid[:, None]
    heat = torch.sigmoid(vox.float())
    pos = binary.sum(0, dtype=torch.float32)
    mask_scores = (heat * binary).sum(0) / (pos + 1e-6)
    n_pad, q = binary.shape
    n8 = (n_pad + 7) // 8
    bits = torch.zeros((n8 * 8, q), dtype=torch.uint8, device=vox.device)
    bits[:n_pad] = binary
    shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.uint8, device=vox.device)
    # the eight shifted bits of a byte are disjoint, so their sum is their OR
    packed = (bits.view(n8, 8, q) << shifts[:, None]).sum(
        1, dtype=torch.uint8)
    return {"probs": probs, "mask_scores": mask_scores, "packed": packed}


def to_host(post: dict) -> dict:
    """The three arrays as numpy (one device-to-host copy each)."""
    return {k: v.cpu().numpy() for k, v in post.items()}
