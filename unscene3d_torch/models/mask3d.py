"""Mask3D: sparse UNet backbone + the iterative mask decoder (counterpart of
unscene3d_tpu/models/mask3d.py).

Host FPS query seeds (`batch.fps_idx`), the attention block mask read out of
avg-pooled mask features, and the plain loop over decoder rounds. Eval
(`model.eval()`): sampling is the identity, so the per-level attention
inputs are computed once and reused by every round. Training
(`model.train()`): each round samples each scene's points per level
(`_sample_level`, uniform scores from a torch.Generator, top-k), with the
gradient stopped through the pooled block-mask readout as the JAX model
stops it; `max_sample_size` keeps every point in training too.

The query modes of conf/model/mask3d.yaml: FPS queries
(`non_parametric_queries`, the default) with zero or projected backbone
features (`use_np_features`) as contents, random positions
(`random_queries`), random positions and contents (`random_query_both`,
uniform or `random_normal`), or learned ones (`query_feat`, `query_pos`).
Random queries are drawn from the forward's generator, or taken from
`query_draw` (tests feed both packages the same numbers). Also
`use_level_embed`, `scatter_type="max"` segment pooling, and the decoder
layers' `pre_norm` and `dropout` (models/transformer_layers.py, masks from
the forward's generator in training). Only `train_on_segments=False`
raises: the JAX model never reads it.

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
from unscene3d_torch.ops.segment_ops import segment_max
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
                  batched_pe, level_embed=None, generator=None):
    """One masked cross-attn + self-attn + FFN step. blocked: (B, P, Q) True
    = the query does not attend to the point; level_embed (D,) is added to
    the level's features; generator draws the dropout masks."""
    cross, self_attn, ffn = layers
    # un-mask queries that mask out every sampled point
    all_blocked = blocked.sum(dim=1) == blocked.shape[1]
    blocked = blocked & ~all_blocked[:, None, :]
    blocked = blocked | ~sel_valid[..., None]
    if level_embed is not None:
        src = src + level_embed
    q = cross(queries, src, block_mask=blocked.transpose(1, 2),
              pos=batched_pe, query_pos=query_pos, generator=generator)
    q = self_attn(q, query_pos=query_pos, generator=generator)
    return ffn(q, generator=generator)


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
                 dropout: float = 0.0, pre_norm: bool = False,
                 random_queries: bool = False,
                 random_query_both: bool = False,
                 random_normal: bool = False, max_sample_size: bool = False,
                 train_on_segments: bool = True, voxel_size: float = 0.02,
                 dtype=torch.float32):
        super().__init__()
        # conf/model/mask3d.yaml's keys: the one value the port does not
        # implement raises here, at construction
        if not train_on_segments:
            raise NotImplementedError(
                "only segment-space masks are ported (train_on_segments: "
                "true, as every script of the self-training round sets; the "
                "JAX model never reads the key)")
        if scatter_type not in ("mean", "max"):
            raise ValueError(f"scatter_type {scatter_type!r}: mean or max")
        D = hidden_dim
        self.backbone = backbone
        self.num_classes = num_classes
        self.hidden_dim = D
        self.num_queries = num_queries
        self.num_decoders = num_decoders
        self.shared_decoder = shared_decoder
        self.hlevels = tuple(hlevels)
        self.sample_sizes = tuple(sample_sizes)
        self.max_sample_size = bool(max_sample_size)
        self.non_parametric_queries = bool(non_parametric_queries)
        self.random_queries = bool(random_queries)
        self.random_query_both = bool(random_query_both)
        self.random_normal = bool(random_normal)
        self.use_np_features = bool(use_np_features)
        self.scatter_type = scatter_type
        self.voxel_size = float(voxel_size)
        self.dtype = dtype
        self.pos_enc = PositionEmbeddingCoordsSine(
            d_pos=D, gauss_scale=gauss_scale, normalize=normalize_pos_enc,
            pos_type=positional_encoding_type, dtype=dtype)
        fpn_dims = self._fpn_dims(backbone)
        # the JAX model creates a module's params only where it calls it:
        # the query projection only for FPS queries (random_query_both
        # declares a 2D-wide one and never calls it)
        if self.non_parametric_queries:
            self.query_projection = nn.ModuleList([Dense(D, D)
                                                   for _ in range(2)])
            if self.use_np_features:
                self.np_feature_projection = nn.ModuleList([
                    Dense(fpn_dims[-1], D), Dense(D, D)])
        elif not (self.random_queries or self.random_query_both):
            self.query_feat = nn.Parameter(torch.zeros(num_queries, D))
            self.query_pos = nn.Parameter(torch.zeros(num_queries, D))
        self.level_embed = (nn.Parameter(torch.zeros(len(self.hlevels), D))
                            if use_level_embed else None)
        self.mask_features_head = Dense(fpn_dims[-1], D)
        self.mask_embed_head = nn.ModuleList([Dense(D, D) for _ in range(2)])
        self.class_embed_head = Dense(D, num_classes)
        self.decoder_norm = LayerNorm(D)
        n_sets = 1 if shared_decoder else num_decoders
        nl = len(self.hlevels)
        layer = dict(dtype=dtype, pre_norm=pre_norm, dropout=dropout)
        self.cross_attention = nn.ModuleList([nn.ModuleList([
            CrossAttentionLayer(D, num_heads, **layer) for _ in range(nl)])
            for _ in range(n_sets)])
        self.self_attention = nn.ModuleList([nn.ModuleList([
            SelfAttentionLayer(D, num_heads, **layer) for _ in range(nl)])
            for _ in range(n_sets)])
        self.ffn = nn.ModuleList([nn.ModuleList([
            FFNLayer(D, dim_feedforward, **layer) for _ in range(nl)])
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
                generator: torch.Generator | None = None,
                return_aux_vox: bool = False, query_draw=None) -> dict:
        """Returns pred_logits (L,B,Q,C), pred_masks_seg (L,B,S,Q),
        pred_masks_vox (1,N0,Q) for the final set, or (L,N0,Q) for every
        set with return_aux_vox, sampled_coords (B,Q,3) (None unless the
        queries are FPS seeds), backbone_features and mask_features. Eval
        runs without autograd; training draws the point samples and the
        dropout masks from `generator`. Random queries are drawn from
        `generator` (the default generator when None), or taken from
        `query_draw`: (B, Q, D) uniform [0, 1) numbers for random_queries,
        (B, Q, 2D) uniform or, with random_normal, normal ones for
        random_query_both."""
        if not self.training:
            with torch.no_grad():
                return self._forward(batch, generator, return_aux_vox,
                                     query_draw)
        return self._forward(batch, generator, return_aux_vox, query_draw)

    def _queries(self, batch, pcd_features, generator, query_draw):
        """(queries, query_pos, sampled_coords) of the configured mode
        (unscene3d_tpu/models/mask3d.py:291-351)."""
        B, Q, D = batch.batch_size, self.num_queries, self.hidden_dim
        dev = pcd_features.device
        if self.non_parametric_queries:
            # FPS queries from the host seeds
            scene0 = batch.scene_idx[0].long()
            fps = batch.fps_idx.long()
            raw_by_scene = batch.raw_coords[scene0]                # (B,n0,3)
            sampled_coords = torch.gather(
                raw_by_scene, 1, fps[..., None].expand(-1, -1, 3))  # (B,Q,3)
            mn = batch.level_bounds[:, 0, 0]
            mx = batch.level_bounds[:, 0, 1]
            query_pos = self.pos_enc(sampled_coords, mn[:, None], mx[:, None])
            for layer in self.query_projection:
                query_pos = torch.relu(layer(query_pos))
            if not self.use_np_features:
                return torch.zeros_like(query_pos), query_pos, sampled_coords
            feats = pcd_features[scene0]                          # (B,n0,F)
            queries = torch.gather(
                feats, 1, fps[..., None].expand(-1, -1, feats.shape[-1]))
            proj0, proj1 = self.np_feature_projection
            return proj1(torch.relu(proj0(queries))), query_pos, \
                sampled_coords
        if self.random_queries or self.random_query_both:
            width = 2 * D if self.random_query_both else D
            if query_draw is None:
                gdev = generator.device if generator is not None else dev
                draw = torch.randn if self.random_normal and \
                    self.random_query_both else torch.rand
                query_draw = draw((B, Q, width), generator=generator,
                                  device=gdev)
            if tuple(query_draw.shape) != (B, Q, width):
                raise ValueError(f"query_draw: shape {tuple(query_draw.shape)}"
                                 f", expected {(B, Q, width)}")
            qpf = query_draw.to(dev, self.dtype)
            if not (self.random_query_both and self.random_normal):
                qpf = qpf - 0.5
            if self.random_queries:
                return torch.zeros_like(qpf), qpf, None
            return qpf[..., :D], qpf[..., D:], None
        return (self.query_feat[None].expand(B, -1, -1),
                self.query_pos[None].expand(B, -1, -1), None)

    def _forward(self, batch: SceneBatch, generator, return_aux_vox,
                 query_draw) -> dict:
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

        # mask features + segment pool: the mean through kernel 3, or the
        # max (scatter_type="max", scatter_reduce amax: order-independent)
        mask_features = self.mask_features_head(pcd_features)
        mask_features = mask_features * valid0[:, None].to(mask_features.dtype)
        seg_flat = (batch.batch_idx.long() * S
                    + batch.point2segment.long())
        if self.scatter_type == "mean":
            s = segment_sum(mask_features, seg_flat, B * S, valid0,
                            order=batch.seg_order, offsets=batch.seg_offsets,
                            pieces=batch.seg_pieces)
            s = s / torch.clamp_min(batch.seg_counts, 1.0).to(s.dtype)[:, None]
        else:
            s = segment_max(mask_features, seg_flat, B * S, valid0,
                            counts=batch.seg_counts)
        mask_segments = s.reshape(B, S, D)

        queries, query_pos, sampled_coords = self._queries(
            batch, pcd_features, generator, query_draw)

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

        cached = None
        if not self.training or self.max_sample_size:
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
                if cached is not None:
                    c = cached[dd][i]
                else:
                    c = level_inputs(dd, i, *_sample_level(
                        batch, hlevel, self.sample_sizes[hlevel], generator))
                blk = torch.einsum("bpd,bqd->bpq", c["pooled"],
                                   me.detach().to(c["pooled"].dtype))
                blocked = torch.sigmoid(blk) < 0.5
                layers = (self.cross_attention[dd][i],
                          self.self_attention[dd][i], self.ffn[dd][i])
                level_embed = (None if self.level_embed is None
                               else self.level_embed[i])
                queries = _attend_level(layers, queries, query_pos, blocked,
                                        c["sel_valid"], c["src"], c["pe"],
                                        level_embed, generator)

        out_class, seg_logits, _ = self._mask_module(queries, mask_segments,
                                                     batch.seg_valid)
        predictions_class.append(out_class)
        predictions_seg.append(seg_logits)
        vox_sets = predictions_seg if return_aux_vox else predictions_seg[-1:]
        return {
            "pred_logits": torch.stack(predictions_class),
            "pred_masks_seg": torch.stack(predictions_seg),
            "pred_masks_vox": torch.stack([
                self._vox_from_seg(v, seg_flat, valid0) for v in vox_sets]),
            "sampled_coords": sampled_coords,
            "backbone_features": pcd_features,
            "mask_features": mask_features,
        }
