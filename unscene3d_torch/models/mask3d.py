"""Mask3D: sparse UNet backbone + the iterative mask decoder (counterpart of
unscene3d_tpu/models/mask3d.py).

Host FPS query seeds (`batch.fps_idx`), the attention block mask read out of
avg-pooled mask features, and the plain loop over decoder rounds. Eval
(`model.eval()`): sampling is the identity, so the per-level attention
inputs are computed once and reused by every round. Training
(`model.train()`): each round samples each scene's points per level
(`_sample_level`, uniform scores from a torch.Generator, top-k), with the
gradient stopped through the pooled block-mask readout as the JAX model
stops it. The random / learned query modes raise NotImplementedError.

Shapes: Q queries, S padded segments per scene, C classes, L =
num_decoders * len(hlevels) + 1 prediction sets.
"""

from __future__ import annotations

import torch
from torch import nn

from unscene3d_torch.data.batch import SceneBatch
from unscene3d_torch.models.position_embedding import PositionEmbeddingCoordsSine
from unscene3d_torch.models.transformer_layers import (CrossAttentionLayer,
                                                       Dense, FFNLayer,
                                                       LayerNorm,
                                                       SelfAttentionLayer)
from unscene3d_torch.ops import conv_ops
from unscene3d_torch.ops.segment_pool import segment_sum


def _sample_level(batch: SceneBatch, hlevel: int, sample_size: int,
                  generator: torch.Generator | None = None, scores=None):
    """Per-scene point subsampling at aux level `hlevel`
    (unscene3d_tpu/models/mask3d.py:_sample_level). Returns (flat row indices
    (B, P), validity (B, P)): the identity when the level's scene table is
    no wider than `sample_size`, else the top `sample_size` of uniform
    scores over valid rows. `scores` (B, n_max) f32, if given, replaces the
    draw from `generator` (tests feed both packages the same numbers)."""
    glevel = 4 - hlevel
    scene_idx = batch.scene_idx[glevel]
    scene_valid = batch.scene_valid[glevel]
    if scene_idx.shape[1] <= sample_size:
        return scene_idx, scene_valid
    if scores is None:
        dev = generator.device if generator is not None else scene_idx.device
        scores = torch.rand(scene_valid.shape, generator=generator,
                            device=dev)
    scores = torch.where(scene_valid, scores.to(scene_valid.device),
                         torch.tensor(float("-inf"),
                                      device=scene_valid.device))
    sel = torch.topk(scores, sample_size, dim=1).indices
    return (torch.gather(scene_idx, 1, sel),
            torch.gather(scene_valid, 1, sel))


def _attend_level(layers, queries, query_pos, blocked, sel_valid, src,
                  batched_pe):
    """One masked cross-attn + self-attn + FFN step. blocked: (B, P, Q) True
    = the query does not attend to the point."""
    cross, self_attn, ffn = layers
    # un-mask queries that mask out every sampled point
    all_blocked = blocked.sum(dim=1) == blocked.shape[1]
    blocked = blocked & ~all_blocked[:, None, :]
    blocked = blocked | ~sel_valid[..., None]
    q = cross(queries, src, block_mask=blocked.transpose(1, 2),
              pos=batched_pe, query_pos=query_pos)
    q = self_attn(q, query_pos=query_pos)
    return ffn(q)


class Mask3D(nn.Module):
    """Under bf16 `dtype` the backbone and the transformer layers run in
    bf16, while Mask3D's own Dense heads (query projection, mask features,
    mask embedding, class head, squeeze) carry no dtype and compute in f32,
    as flax promotes them."""

    def __init__(self, backbone: nn.Module, num_classes: int = 2,
                 hidden_dim: int = 128, num_queries: int = 100,
                 num_heads: int = 8, dim_feedforward: int = 1024,
                 num_decoders: int = 3, shared_decoder: bool = True,
                 hlevels: tuple = (0, 1, 2, 3),
                 sample_sizes: tuple = (200, 800, 3200, 12800, 51200),
                 non_parametric_queries: bool = True,
                 normalize_pos_enc: bool = True,
                 positional_encoding_type: str = "fourier",
                 gauss_scale: float = 1.0, scatter_type: str = "mean",
                 use_level_embed: bool = False, use_np_features: bool = False,
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        if not non_parametric_queries:
            raise NotImplementedError(
                "only non-parametric (FPS) queries are ported")
        if use_level_embed or use_np_features or scatter_type != "mean":
            raise NotImplementedError(
                "level embeddings, np features and max scatter are not ported")
        if dropout != 0.0:
            raise NotImplementedError("decoder dropout is not ported "
                                      "(conf/model/mask3d.yaml sets 0.0)")
        D = hidden_dim
        self.backbone = backbone
        self.num_classes = num_classes
        self.hidden_dim = D
        self.num_queries = num_queries
        self.num_decoders = num_decoders
        self.shared_decoder = shared_decoder
        self.hlevels = tuple(hlevels)
        self.sample_sizes = tuple(sample_sizes)
        self.dtype = dtype
        self.pos_enc = PositionEmbeddingCoordsSine(
            d_pos=D, gauss_scale=gauss_scale, normalize=normalize_pos_enc,
            pos_type=positional_encoding_type, dtype=dtype)
        self.query_projection = nn.ModuleList([Dense(D, D) for _ in range(2)])
        fpn_dims = self._fpn_dims(backbone)
        self.mask_features_head = Dense(fpn_dims[-1], D)
        self.mask_embed_head = nn.ModuleList([Dense(D, D) for _ in range(2)])
        self.class_embed_head = Dense(D, num_classes)
        self.decoder_norm = LayerNorm(D)
        n_sets = 1 if shared_decoder else num_decoders
        nl = len(self.hlevels)
        self.cross_attention = nn.ModuleList([nn.ModuleList([
            CrossAttentionLayer(D, num_heads, dtype) for _ in range(nl)])
            for _ in range(n_sets)])
        self.self_attention = nn.ModuleList([nn.ModuleList([
            SelfAttentionLayer(D, num_heads, dtype) for _ in range(nl)])
            for _ in range(n_sets)])
        self.ffn = nn.ModuleList([nn.ModuleList([
            FFNLayer(D, dim_feedforward, dtype) for _ in range(nl)])
            for _ in range(n_sets)])
        self.lin_squeeze = nn.ModuleList([nn.ModuleList([
            Dense(fpn_dims[h], D) for h in self.hlevels])
            for _ in range(n_sets)])

    @staticmethod
    def _fpn_dims(backbone) -> list[int]:
        """Channel widths of the FPN list [stride 16, 8, 4, 2, 1]."""
        p = backbone.planes
        return [p[3], p[4], p[5], p[6], p[7]]

    def _mask_module(self, queries, mask_segments, seg_valid):
        """(class logits (B,Q,C), segment mask logits (B,S,Q), mask
        embedding (B,Q,D))."""
        q = self.decoder_norm(queries)
        me = torch.relu(self.mask_embed_head[0](q))
        me = self.mask_embed_head[1](me)
        outputs_class = self.class_embed_head(q)
        seg_logits = torch.einsum("bsd,bqd->bsq", mask_segments, me)
        seg_logits = seg_logits * seg_valid[..., None].to(seg_logits.dtype)
        return outputs_class, seg_logits, me

    @staticmethod
    def _vox_from_seg(seg_logits, seg_flat, valid):
        B, S, Q = seg_logits.shape
        return (seg_logits.reshape(B * S, Q)[seg_flat]
                * valid[:, None].to(seg_logits.dtype))

    def forward(self, batch: SceneBatch,
                generator: torch.Generator | None = None) -> dict:
        """Returns pred_logits (L,B,Q,C), pred_masks_seg (L,B,S,Q),
        pred_masks_vox (1,N0,Q) for the final set, sampled_coords (B,Q,3),
        backbone_features and mask_features. Eval runs without autograd;
        training draws the point samples from `generator`."""
        if not self.training:
            with torch.no_grad():
                return self._forward(batch, None)
        return self._forward(batch, generator)

    def _forward(self, batch: SceneBatch, generator) -> dict:
        B = batch.batch_size
        S = batch.num_segments_padded
        D = self.hidden_dim
        levels = batch.graph.levels
        valid0 = levels[0].valid

        pcd_features, fpn, _final = self.backbone(batch.features, batch.graph)

        with torch.no_grad():
            # coordinate pyramid by repeated average pooling of the raw
            # coords, and per-level positional encodings normalised by the
            # host level bounds: no parameter reaches either
            coords_by_level = [batch.raw_coords]
            for lv in range(1, 5):
                coords_by_level.append(
                    conv_ops.avg_pool2(coords_by_level[-1], levels[lv]))
            pe_by_level = []
            for lv in range(5):
                bidx = levels[lv].coords[:, 0].long()
                mn = batch.level_bounds[:, lv, 0][bidx]
                mx = batch.level_bounds[:, lv, 1][bidx]
                pe = self.pos_enc(coords_by_level[lv][None], mn[None],
                                  mx[None])[0]
                pe_by_level.append(pe * levels[lv].valid[:, None].to(pe.dtype))

        # mask features + segment mean-pool (kernel 3)
        mask_features = self.mask_features_head(pcd_features)
        mask_features = mask_features * valid0[:, None].to(mask_features.dtype)
        seg_flat = (batch.batch_idx.long() * S
                    + batch.point2segment.long())
        s = segment_sum(mask_features, seg_flat, B * S, valid0,
                        order=batch.seg_order, offsets=batch.seg_offsets)
        mask_segments = (s / torch.clamp_min(batch.seg_counts, 1.0)
                         .to(s.dtype)[:, None]).reshape(B, S, D)

        # FPS queries from the host seeds
        scene0 = batch.scene_idx[0].long()
        raw_by_scene = batch.raw_coords[scene0]                    # (B, n0, 3)
        fps = batch.fps_idx.long()
        sampled_coords = torch.gather(
            raw_by_scene, 1, fps[..., None].expand(-1, -1, 3))     # (B, Q, 3)
        mn = batch.level_bounds[:, 0, 0]
        mx = batch.level_bounds[:, 0, 1]
        query_pos = self.pos_enc(sampled_coords, mn[:, None], mx[:, None])
        for layer in self.query_projection:
            query_pos = torch.relu(layer(query_pos))
        queries = torch.zeros_like(query_pos)

        # pooled mask features per level: the block mask at level g is a
        # linear readout of these with each round's mask embedding, under a
        # stopped gradient (mask3d.py:385-388), so no pool needs a backward
        with torch.no_grad():
            vox_feats = mask_segments.reshape(B * S, D)[seg_flat]
            vox_feats = vox_feats * valid0[:, None].to(vox_feats.dtype)
            pooled_feats = [vox_feats]
            for lv in range(1, 5):
                pooled_feats.append(conv_ops.avg_pool2(pooled_feats[-1],
                                                       levels[lv]))

        def level_inputs(dd, i, sel_flat, sel_valid):
            glevel = 4 - self.hlevels[i]
            sel = sel_flat.long()
            return dict(
                sel_valid=sel_valid, pe=pe_by_level[glevel][sel],
                pooled=pooled_feats[glevel][sel],
                src=self.lin_squeeze[dd][i](
                    fpn[self.hlevels[i]][sel].to(self.dtype)))

        if not self.training:
            # sampling is the identity: the per-level attention inputs are
            # the same in every round
            cached = [[level_inputs(dd, i, batch.scene_idx[4 - h],
                                    batch.scene_valid[4 - h])
                       for i, h in enumerate(self.hlevels)]
                      for dd in range(len(self.lin_squeeze))]

        predictions_class, predictions_seg = [], []
        for d in range(self.num_decoders):
            dd = 0 if self.shared_decoder else d
            for i, hlevel in enumerate(self.hlevels):
                out_class, seg_logits, me = self._mask_module(
                    queries, mask_segments, batch.seg_valid)
                predictions_class.append(out_class)
                predictions_seg.append(seg_logits)
                if not self.training:
                    c = cached[dd][i]
                else:
                    c = level_inputs(dd, i, *_sample_level(
                        batch, hlevel, self.sample_sizes[hlevel], generator))
                blk = torch.einsum("bpd,bqd->bpq", c["pooled"],
                                   me.detach().to(c["pooled"].dtype))
                blocked = torch.sigmoid(blk) < 0.5
                layers = (self.cross_attention[dd][i],
                          self.self_attention[dd][i], self.ffn[dd][i])
                queries = _attend_level(layers, queries, query_pos, blocked,
                                        c["sel_valid"], c["src"], c["pe"])

        out_class, seg_logits, _ = self._mask_module(queries, mask_segments,
                                                     batch.seg_valid)
        predictions_class.append(out_class)
        predictions_seg.append(seg_logits)
        vox = self._vox_from_seg(seg_logits, seg_flat, valid0)
        return {
            "pred_logits": torch.stack(predictions_class),
            "pred_masks_seg": torch.stack(predictions_seg),
            "pred_masks_vox": vox[None],
            "sampled_coords": sampled_coords,
            "backbone_features": pcd_features,
            "mask_features": mask_features,
        }
