"""Plain PyTorch Mask3D over Res16UNet34C, for training in f32.

The sparse convolutions are per-offset row gathers and matmuls with their
gradients written out (dx is the conv of the masked output gradient with
flip-transposed weights, dW one gathered GEMM per offset), so that the
autograd graph saves one (N, C) input per conv and not 27. The decoder is
plain `torch` layers. Parameter and buffer names match the port's
`Mask3D(Res16UNet34C)`, so one state dict loads into both.

A frozen copy of the port's plain twins (conv, kernel-2 gather, segment
sum) and of its model code, trimmed to `conf/model/mask3d.yaml` with FPS
queries, mean segment pooling and no dropout. It imports nothing of the
program.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_NEG = torch.finfo(torch.float32).min / 2


def _gather(x, idx):
    """x[idx] with the table's miss row (x's last) read as zeros."""
    idx = idx.long()
    return x[idx] * (idx != x.shape[0] - 1)[:, None].to(x.dtype)


def conv_rows(x, w, table, out_valid):
    """out[i] = out_valid[i] * sum_k x[table[k, i]] @ w[k], in f32."""
    acc = torch.zeros(table.shape[1], w.shape[-1], dtype=torch.float32,
                      device=x.device)
    for k in range(table.shape[0]):
        acc = acc + _gather(x, table[k]) @ w[k]
    return acc * out_valid[:, None].to(torch.float32)


def gathered_dw(x, gm, table):
    """dW[k] = x[table[k]]^T gm, (K, Cin, Cout) f32."""
    return torch.stack([_gather(x, table[k]).T @ gm
                        for k in range(table.shape[0])])


class _Conv3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, level):
        ctx.save_for_backward(x, w)
        ctx.level = level
        return conv_rows(x, w, level.nbr_idx, level.valid)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        lv = ctx.level
        gm = g * lv.valid[:, None].to(g.dtype)
        dx = None
        if ctx.needs_input_grad[0]:
            wt = torch.flip(w, dims=(0,)).transpose(1, 2)
            dx = conv_rows(gm, wt, lv.nbr_idx, lv.valid)
        return dx, gathered_dw(x, gm, lv.nbr_idx), None


def _k2_dw(x_rows, gm, fine):
    return torch.stack([
        (x_rows * ((fine.parent_offset == k) & fine.valid)[:, None]
         .to(x_rows.dtype)).T @ gm for k in range(8)])


class _Down2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, coarse, fine):
        ctx.save_for_backward(x, w)
        ctx.levels = (coarse, fine)
        return conv_rows(x, w, coarse.child_idx, coarse.valid)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        coarse, fine = ctx.levels
        gm = g * coarse.valid[:, None].to(g.dtype)
        dx = conv_rows(gm, w.transpose(1, 2), fine.up_idx, fine.valid)
        g_par = gm[fine.parent_idx.long()] * fine.valid[:, None].to(g.dtype)
        return dx, _k2_dw(x, g_par, fine), None, None


class _Up2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, fine, coarse):
        ctx.save_for_backward(x, w)
        ctx.levels = (fine, coarse)
        return conv_rows(x, w, fine.up_idx, fine.valid)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        fine, coarse = ctx.levels
        gm = g * fine.valid[:, None].to(g.dtype)
        dx = conv_rows(gm, w.transpose(1, 2), coarse.child_idx, coarse.valid)
        x_par = x[fine.parent_idx.long()] * fine.valid[:, None].to(x.dtype)
        return dx, _k2_dw(x_par, gm, fine), None, None


def avg_pool2(x, coarse):
    """Mean over each coarse row's valid children (no gradient needed)."""
    cnt = coarse.child_valid.sum(dim=0).to(x.dtype)
    acc = None
    for k in range(8):
        g = _gather(x, coarse.child_idx[k])
        acc = g if acc is None else acc + g
    s = acc * coarse.valid[:, None].to(x.dtype)
    out = s / torch.clamp_min(cnt, 1.0)[:, None]
    return out * coarse.valid[:, None].to(x.dtype)


def segment_sum(x, ids, num_segments, valid):
    """Sum of x's valid rows by segment id, with a gather as its backward."""
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_segments) & valid
    ids = torch.where(ok, ids, torch.full_like(ids, num_segments))
    out = torch.zeros(num_segments + 1, x.shape[1], dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, ids, x)[:num_segments]


class SparseConv(nn.Module):
    _K = {"k3": 27, "down2": 8, "up2": 8}

    def __init__(self, cin, cout, kind="k3", use_bias=False):
        super().__init__()
        self.kind = kind
        shape = (cin, cout) if kind == "k1" else (self._K[kind], cin, cout)
        self.kernel = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x, level, other=None):
        if self.kind == "k1":
            out = x @ self.kernel
            if self.bias is not None:
                out = out + self.bias
            return out * level.valid[:, None].to(out.dtype)
        if self.kind == "k3":
            return _Conv3.apply(x, self.kernel, level)
        if self.kind == "down2":
            return _Down2.apply(x, self.kernel, level, other)
        return _Up2.apply(x, self.kernel, level, other)


class SparseBatchNorm(nn.Module):
    """Batch statistics of the valid rows (biased variance); the running
    statistics move by momentum m to the unbiased ones after each step."""

    def __init__(self, features, epsilon=1e-5, momentum=0.02):
        super().__init__()
        self.epsilon, self.momentum = epsilon, momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.batch_stats = None

    def forward(self, x, valid):
        w = valid.to(torch.float32)
        cnt = torch.clamp_min(w.sum(), 1.0)
        mean = (x * w[:, None]).sum(0) / cnt
        var = (torch.square(x - mean) * w[:, None]).sum(0) / cnt
        self.batch_stats = (mean.detach(), (var * cnt / torch.clamp_min(
            cnt - 1.0, 1.0)).detach())
        y = (x - mean) * torch.rsqrt(var + self.epsilon) * self.scale \
            + self.bias
        return y * w[:, None]

    @torch.no_grad()
    def update_running_stats(self):
        mean, unbiased = self.batch_stats
        m = self.momentum
        self.mean.copy_((1 - m) * self.mean + m * mean)
        self.var.copy_((1 - m) * self.var + m * unbiased)
        self.batch_stats = None


class BasicBlock(nn.Module):
    def __init__(self, inplanes, planes):
        super().__init__()
        self.conv1 = SparseConv(inplanes, planes)
        self.norm1 = SparseBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes)
        self.norm2 = SparseBatchNorm(planes)
        if inplanes != planes:
            self.downsample_conv = SparseConv(inplanes, planes, "k1")
            self.downsample_norm = SparseBatchNorm(planes)
        else:
            self.downsample_conv = self.downsample_norm = None

    def forward(self, x, level):
        out = torch.relu(self.norm1(self.conv1(x, level), level.valid))
        out = self.norm2(self.conv2(out, level), level.valid)
        res = x
        if self.downsample_conv is not None:
            res = self.downsample_norm(self.downsample_conv(x, level),
                                       level.valid)
        return torch.relu(out + res)


class Res16UNet34C(nn.Module):
    planes = (32, 64, 128, 256, 256, 128, 96, 96)
    layers = (2, 3, 4, 6, 2, 2, 2, 2)

    def __init__(self, out_channels=2, in_channels=3, init_dim=32):
        super().__init__()
        p, L = self.planes, self.layers
        self._conv_bn("conv0p1s1", in_channels, init_dim, "k3")
        inp = init_dim
        for s in range(4):
            self._conv_bn(f"conv{s + 1}p{2 ** s}s2", inp, inp, "down2")
            inp = self._blocks(f"block{s + 1}", inp, p[s], L[s])
        skips = [p[2], p[1], p[0], init_dim]
        for u in range(4):
            self._conv_bn(f"convtr{u + 4}p{2 ** (4 - u)}s2", inp, p[4 + u],
                          "up2")
            inp = self._blocks(f"block{u + 5}", p[4 + u] + skips[u], p[4 + u],
                               L[4 + u])
        self.final = SparseConv(inp, out_channels, "k1", use_bias=True)

    def _conv_bn(self, name, cin, cout, kind):
        self.add_module(f"{name}_conv", SparseConv(cin, cout, kind))
        self.add_module(f"{name}_bn", SparseBatchNorm(cout))

    def _blocks(self, name, cin, planes, n):
        for bi in range(n):
            self.add_module(f"{name}_{bi}", BasicBlock(cin, planes))
            cin = planes
        return planes

    def _conv_bn_relu(self, name, x, level, other=None):
        conv, bn = getattr(self, f"{name}_conv"), getattr(self, f"{name}_bn")
        return torch.relu(bn(conv(x, level, other), level.valid))

    def forward(self, features, levels):
        out_p1 = self._conv_bn_relu("conv0p1s1", features, levels[0])
        out, skips = out_p1, []
        for s in range(4):
            out = self._conv_bn_relu(f"conv{s + 1}p{2 ** s}s2", out,
                                     levels[s + 1], levels[s])
            for bi in range(self.layers[s]):
                out = getattr(self, f"block{s + 1}_{bi}")(out, levels[s + 1])
            skips.append(out)
        fpn = [out]
        for u in range(4):
            lv = 3 - u
            out = self._conv_bn_relu(f"convtr{u + 4}p{2 ** (4 - u)}s2", out,
                                     levels[lv], levels[lv + 1])
            out = torch.cat([out, skips[lv - 1] if lv > 0 else out_p1], -1)
            for bi in range(self.layers[4 + u]):
                out = getattr(self, f"block{u + 5}_{bi}")(out, levels[lv])
            fpn.append(out)
        # `final` (the k1 head) lies outside Mask3D's loss: not run
        return out, fpn


class PositionEmbeddingCoordsSine(nn.Module):
    """Fourier features of coords normalised to [0, 1] per scene."""

    def __init__(self, d_pos=128):
        super().__init__()
        self.register_buffer("gauss_B", torch.zeros(3, d_pos // 2))

    def forward(self, xyz, mn, mx):
        x = (xyz - mn) / torch.clamp_min(mx - mn, 1e-12)
        proj = torch.matmul(x * (2.0 * math.pi), self.gauss_B)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class LayerNorm(nn.LayerNorm):
    def __init__(self, features):
        super().__init__(features, eps=1e-6)


class MultiheadAttention(nn.Module):
    def __init__(self, d_model, num_heads):
        super().__init__()
        self.num_heads, self.d_head = num_heads, d_model // num_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, block_mask=None):
        B, Q, _ = q.shape
        P = k.shape[1]
        H, dh = self.num_heads, self.d_head
        qh = self.q_proj(q).view(B, Q, H, dh)
        kh = self.k_proj(k).view(B, P, H, dh)
        vh = self.v_proj(v).view(B, P, H, dh)
        logits = torch.einsum("bqhd,bphd->bhqp", qh, kh) * (1.0 / dh ** 0.5)
        if block_mask is not None:
            logits = logits.masked_fill(block_mask[:, None], _NEG)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqp,bphd->bqhd", attn, vh)
        return self.out_proj(out.reshape(B, Q, H * dh))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d_model, num_heads):
        super().__init__()
        self.norm = LayerNorm(d_model)
        self.attn = MultiheadAttention(d_model, num_heads)

    def forward(self, tgt, memory, block_mask, pos, query_pos):
        return self.norm(tgt + self.attn(tgt + query_pos, memory + pos,
                                         memory, block_mask))


class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model, num_heads):
        super().__init__()
        self.norm = LayerNorm(d_model)
        self.attn = MultiheadAttention(d_model, num_heads)

    def forward(self, tgt, query_pos):
        q = tgt + query_pos
        return self.norm(tgt + self.attn(q, q, tgt))


class FFNLayer(nn.Module):
    def __init__(self, d_model, dim_feedforward):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm = LayerNorm(d_model)

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(torch.relu(self.linear1(tgt))))


def sample_level(batch, glevel, sample_size, generator):
    """Each scene's rows at a level: all of them where the scene table is
    no wider than `sample_size`, else the top `sample_size` of uniform
    scores drawn from `generator` over the valid rows."""
    scene_idx, scene_valid = batch.scene_idx[glevel], batch.scene_valid[glevel]
    if scene_idx.shape[1] <= sample_size:
        return scene_idx, scene_valid
    scores = torch.rand(scene_valid.shape, generator=generator,
                        device=generator.device)
    scores = torch.where(scene_valid, scores.to(scene_valid.device),
                         torch.tensor(float("-inf"),
                                      device=scene_valid.device))
    sel = torch.topk(scores, sample_size, dim=1).indices
    return torch.gather(scene_idx, 1, sel), torch.gather(scene_valid, 1, sel)


class Mask3D(nn.Module):
    def __init__(self, num_classes=3, hidden_dim=128, num_queries=100,
                 num_heads=8, dim_feedforward=1024, num_decoders=3,
                 hlevels=(0, 1, 2, 3),
                 sample_sizes=(200, 800, 3200, 12800, 51200)):
        super().__init__()
        D = hidden_dim
        self.backbone = Res16UNet34C()
        self.hidden_dim, self.num_queries = D, num_queries
        self.num_decoders, self.hlevels = num_decoders, tuple(hlevels)
        self.sample_sizes = tuple(sample_sizes)
        self.pos_enc = PositionEmbeddingCoordsSine(D)
        p = self.backbone.planes
        fpn_dims = [p[3], p[4], p[5], p[6], p[7]]
        self.query_projection = nn.ModuleList([nn.Linear(D, D)
                                               for _ in range(2)])
        self.mask_features_head = nn.Linear(fpn_dims[-1], D)
        self.mask_embed_head = nn.ModuleList([nn.Linear(D, D)
                                              for _ in range(2)])
        self.class_embed_head = nn.Linear(D, num_classes)
        self.decoder_norm = LayerNorm(D)
        nl = len(self.hlevels)
        self.cross_attention = nn.ModuleList([nn.ModuleList([
            CrossAttentionLayer(D, num_heads) for _ in range(nl)])])
        self.self_attention = nn.ModuleList([nn.ModuleList([
            SelfAttentionLayer(D, num_heads) for _ in range(nl)])])
        self.ffn = nn.ModuleList([nn.ModuleList([
            FFNLayer(D, dim_feedforward) for _ in range(nl)])])
        self.lin_squeeze = nn.ModuleList([nn.ModuleList([
            nn.Linear(fpn_dims[h], D) for h in self.hlevels])])

    def _mask_module(self, queries, mask_segments, seg_valid):
        q = self.decoder_norm(queries)
        me = self.mask_embed_head[1](torch.relu(self.mask_embed_head[0](q)))
        seg_logits = torch.einsum("bsd,bqd->bsq", mask_segments, me)
        seg_logits = seg_logits * seg_valid[..., None].to(seg_logits.dtype)
        return self.class_embed_head(q), seg_logits, me

    def forward(self, batch, generator, decisions=None):
        """(pred_logits (L, B, Q, C), pred_masks_seg (L, B, S, Q)).
        `decisions.block(blk)` gives each round's block mask from its
        readout logits (B, P, Q): True where the query does not attend."""
        B, S = batch.batch_size, batch.seg_valid.shape[1]
        levels = batch.levels
        valid0 = levels[0].valid
        pcd, fpn = self.backbone(batch.features, levels)
        with torch.no_grad():
            coords = [batch.raw_coords]
            for lv in range(1, 5):
                coords.append(avg_pool2(coords[-1], levels[lv]))
            pe_by_level = []
            for lv in range(5):
                bidx = levels[lv].coords[:, 0].long()
                mn = batch.level_bounds[:, lv, 0][bidx]
                mx = batch.level_bounds[:, lv, 1][bidx]
                pe = self.pos_enc(coords[lv], mn, mx)
                pe_by_level.append(pe * levels[lv].valid[:, None].to(pe.dtype))

        mask_features = self.mask_features_head(pcd) * valid0[:, None]
        seg_flat = levels[0].coords[:, 0].long() * S \
            + batch.point2segment.long()
        s = segment_sum(mask_features, seg_flat, B * S, valid0)
        s = s / torch.clamp_min(batch.seg_counts, 1.0)[:, None]
        mask_segments = s.reshape(B, S, -1)

        scene0 = batch.scene_idx[0].long()
        fps = batch.fps_idx.long()
        sampled = torch.gather(batch.raw_coords[scene0], 1,
                               fps[..., None].expand(-1, -1, 3))
        query_pos = self.pos_enc(sampled, batch.level_bounds[:, 0, 0][:, None],
                                 batch.level_bounds[:, 0, 1][:, None])
        for layer in self.query_projection:
            query_pos = torch.relu(layer(query_pos))
        queries = torch.zeros_like(query_pos)

        with torch.no_grad():
            vox = mask_segments.reshape(B * S, -1)[seg_flat] * valid0[:, None]
            pooled = [vox]
            for lv in range(1, 5):
                pooled.append(avg_pool2(pooled[-1], levels[lv]))

        preds_class, preds_seg = [], []
        for _ in range(self.num_decoders):
            for i, h in enumerate(self.hlevels):
                out_class, seg_logits, me = self._mask_module(
                    queries, mask_segments, batch.seg_valid)
                preds_class.append(out_class)
                preds_seg.append(seg_logits)
                glevel = 4 - h
                sel, sel_valid = sample_level(batch, glevel,
                                              self.sample_sizes[h], generator)
                sel = sel.long()
                src = self.lin_squeeze[0][i](fpn[h][sel])
                blk = torch.einsum("bpd,bqd->bpq", pooled[glevel][sel],
                                   me.detach())
                blocked = (torch.sigmoid(blk) < 0.5 if decisions is None
                           else decisions.block(blk))
                all_blocked = blocked.sum(dim=1) == blocked.shape[1]
                blocked = (blocked & ~all_blocked[:, None, :]) \
                    | ~sel_valid[..., None]
                q = self.cross_attention[0][i](
                    queries, src, blocked.transpose(1, 2),
                    pe_by_level[glevel][sel], query_pos)
                q = self.self_attention[0][i](q, query_pos)
                queries = self.ffn[0][i](q)
        out_class, seg_logits, _ = self._mask_module(queries, mask_segments,
                                                     batch.seg_valid)
        preds_class.append(out_class)
        preds_seg.append(seg_logits)
        return torch.stack(preds_class), torch.stack(preds_seg)
