"""DETR-style set criterion over all L prediction sets at once (counterpart
of unscene3d_tpu/losses/criterion.py:SetCriterion):

  * CE label loss with class weights (eos_coef on the no-object class),
    normalised by the summed weights as torch's weighted cross entropy;
  * per-scene mask BCE and dice over valid segments, normalised by that
    scene's matched-instance count;
  * DropLoss (`use_droploss`): matches whose intersection over sum is below
    the threshold get zero weight;
  * `ignore_mask_idx`: prediction sets whose losses get zero weight;
  * the noise-robust tri-plane projection loss per prediction set
    (`weight_noise_robust`, ops/triplane.py), on the batch's tri-plane maps.

One deliberate difference from the JAX package: a nonzero
`weight_noise_robust` with a batch that carries no tri-plane maps raises
ValueError, where the JAX criterion silently returns zeros
(unscene3d_tpu/losses/criterion.py:66-71).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from unscene3d_torch.data.batch import SceneBatch, Targets
from unscene3d_torch.losses.matcher import HungarianMatcher
from unscene3d_torch.ops.segment_pool import gather_rows
from unscene3d_torch.ops.triplane import (normalized_target_projection,
                                          triplane_losses)


@dataclasses.dataclass
class SetCriterion:
    matcher: HungarianMatcher
    num_classes: int = 3            # model head classes incl. no-object
    eos_coef: float = 0.1
    weight_ce: float = 2.0
    weight_mask: float = 5.0
    weight_dice: float = 2.0
    weight_noise_robust: float = 0.0
    use_droploss: bool = False
    droploss_iou_thresh: float = 0.1
    ignore_label: int = 253
    ignore_mask_idx: tuple = ()

    def __call__(self, outputs: dict, batch: SceneBatch) -> dict:
        """Returns loss_ce / loss_mask / loss_dice / loss_noise_robust (L,),
        total (), num_masks () and matched_q (L, B, T) (-1 for padding)."""
        targets = batch.target
        pred_logits = outputs["pred_logits"]          # (L, B, Q, C)
        pred_masks = outputs["pred_masks_seg"]        # (L, B, S, Q)
        L = pred_logits.shape[0]
        matched_q = self.matcher(pred_logits, pred_masks, targets,
                                 batch.seg_valid)
        losses = {"loss_ce": self._loss_labels(pred_logits, targets,
                                               matched_q)}
        losses.update(self._loss_masks(pred_masks, targets, matched_q,
                                       batch.seg_valid))
        if self.weight_noise_robust != 0.0:
            losses["loss_noise_robust"] = self._loss_noise_robust(
                pred_masks, targets, matched_q, batch)
        else:
            losses["loss_noise_robust"] = torch.zeros(
                L, dtype=torch.float32, device=pred_logits.device)
        per_set = (self.weight_ce * losses["loss_ce"]
                   + self.weight_mask * losses["loss_mask"]
                   + self.weight_dice * losses["loss_dice"]
                   + self.weight_noise_robust * losses["loss_noise_robust"])
        if self.ignore_mask_idx:
            keep = torch.ones(L, dtype=torch.float32, device=per_set.device)
            keep[list(self.ignore_mask_idx)] = 0.0
            per_set = per_set * keep
        losses["total"] = per_set.sum()
        losses["num_masks"] = targets.valid.sum().float()
        losses["matched_q"] = matched_q
        return losses

    def _loss_labels(self, pred_logits, targets: Targets, matched_q):
        L, B, Q, C = pred_logits.shape
        dev = pred_logits.device
        no_object = C - 1
        empty_weight = torch.ones(C, dtype=torch.float32, device=dev)
        empty_weight[-1] = self.eos_coef
        # scatter matched target labels onto queries; padding targets land
        # in a trash slot so they never clobber a real query's class
        t_valid = targets.valid[None] & (matched_q >= 0)
        flat_lb = (torch.arange(L, device=dev)[:, None, None] * B
                   + torch.arange(B, device=dev)[None, :, None])
        flat_idx = flat_lb * Q + torch.clamp_min(matched_q, 0)
        labels_b = targets.labels[None].long().expand(matched_q.shape)
        upd = torch.where(t_valid, labels_b, no_object)
        trash = L * B * Q
        target_classes = torch.full((L * B * Q + 1,), no_object,
                                    dtype=torch.long, device=dev)
        sidx = torch.where(t_valid, flat_idx, trash).reshape(-1)
        target_classes = target_classes.scatter(0, sidx, upd.reshape(-1))
        target_classes = target_classes[:-1].reshape(L, B, Q)

        logp = F.log_softmax(pred_logits.float(), dim=-1)
        nll = -torch.take_along_dim(logp, target_classes[..., None],
                                    dim=-1)[..., 0]
        w = empty_weight[target_classes]
        w = w * (target_classes != self.ignore_label).to(torch.float32)
        return ((nll * w).reshape(L, -1).sum(-1)
                / torch.clamp_min(w.reshape(L, -1).sum(-1), 1e-8))

    def _loss_masks(self, pred_masks, targets: Targets, matched_q,
                    seg_valid):
        L, B, S, Q = pred_masks.shape
        T = targets.labels.shape[1]
        seg_valid = seg_valid.to(torch.float32)                   # (B, S)
        t_valid = (targets.valid[None] & (matched_q >= 0)).to(torch.float32)

        # matched prediction logits per target: (L, B, T, S)
        pm = pred_masks.transpose(2, 3)                           # (L,B,Q,S)
        mq = torch.clamp_min(matched_q, 0)
        x = torch.take_along_dim(pm, mq[..., None], dim=2)
        t = targets.seg_masks[None].to(torch.float32).expand(L, B, T, S)
        sv = seg_valid[None, :, None, :]

        if self.use_droploss:
            pred_fg = (x > 0).to(torch.float32) * sv
            inter = (pred_fg * t).sum(-1)
            ssum = (pred_fg + t * sv).sum(-1)
            iou = inter / torch.clamp_min(ssum, 1e-8)
            w = (iou >= self.droploss_iou_thresh).to(torch.float32)
        else:
            w = torch.ones(L, B, T, dtype=torch.float32, device=x.device)
        w = w * t_valid

        num_masks = torch.clamp_min(t_valid.sum(-1), 1.0)         # (L, B)
        n_seg = torch.clamp_min(seg_valid.sum(-1), 1.0)[None, :, None]

        xf = x.float()
        bce = (F.softplus(-xf) * t + F.softplus(xf) * (1.0 - t)) * sv
        # per instance: mean over the scene's segments; per scene: weighted
        # sum over matched instances / matched count; summed over scenes
        loss_mask = (((bce.sum(-1) / n_seg) * w).sum(-1) / num_masks).sum(-1)

        sig = torch.sigmoid(xf) * sv
        numerator = 2.0 * (sig * t).sum(-1)
        denominator = sig.sum(-1) + (t * sv).sum(-1)
        dice = w * (1.0 - (numerator + 1.0) / (denominator + 1.0))
        loss_dice = (dice.sum(-1) / num_masks).sum(-1)
        return {"loss_mask": loss_mask, "loss_dice": loss_dice}

    def _loss_noise_robust(self, pred_masks, targets: Targets, matched_q,
                           batch: SceneBatch):
        """(L,) tri-plane loss of each set (unscene3d_tpu/losses/
        criterion.py:165-190). The JAX criterion reads the voxel logits of
        every set (`return_aux_vox`, (L, N0, Q)); those are an exact take
        of the segment logits, so the matched columns are gathered from
        the segment logits here, their sigmoids taken per segment and
        spread to the voxels (`gather_rows`: its backward is kernel 3 over
        the segment order), and the (L, N0, Q) stack is never built. The
        target projection and the counts are the same for every set and
        computed once."""
        tri = batch.triplane
        if tri is None:
            raise ValueError("weight_noise_robust != 0 needs the batch's "
                             "tri-plane maps (FreeMaskCollator("
                             "build_triplane=True))")
        L, B, S, Q = pred_masks.shape
        T = matched_q.shape[-1]
        valid = batch.valid
        mq = torch.clamp_min(matched_q, 0)[:, :, None, :].expand(L, B, S, T)
        sig = torch.sigmoid(torch.take_along_dim(pred_masks, mq, dim=3)
                            .float())                           # (L,B,S,T)
        seg_flat = batch.batch_idx.long() * S + batch.point2segment.long()
        pred = gather_rows(sig.permute(1, 2, 0, 3).reshape(B * S, L * T),
                           seg_flat, valid, batch.seg_order,
                           batch.seg_offsets, batch.seg_pieces)
        t_norm = normalized_target_projection(targets.vox_masks, tri, valid)
        t_valid = targets.valid[None] & (matched_q >= 0)
        return triplane_losses(pred.reshape(-1, L, T), t_norm, tri, valid,
                               t_valid)


class CrossEntropyLoss:
    """Plain semantic-segmentation cross entropy with an ignore index
    (unscene3d_tpu/losses/criterion.py:CrossEntropyLoss, reference
    conf/loss/cross_entropy.yaml -> torch.nn.CrossEntropyLoss): the
    criterion of the MinkUNet / ResNet semantic baselines. The log-softmax
    in f32, the mean over the labels that are not `ignore_index` (0 when
    every label is)."""

    def __init__(self, ignore_index: int = 255):
        self.ignore_index = int(ignore_index)

    def __call__(self, logits, labels):
        logp = F.log_softmax(logits.float(), dim=-1)
        valid = labels != self.ignore_index
        safe = torch.clamp(labels.long(), 0, logits.shape[-1] - 1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        return nll.sum() / torch.clamp_min(valid.sum(), 1)
