"""Post-norm transformer layers of the mask decoder (counterpart of
unscene3d_tpu/models/transformer_layers.py; XLA there, plain torch here).

Dtype semantics follow flax: `Dense(dtype=None)` computes in the promotion of
its input and f32 params (so f32), `Dense(dtype=bf16)` computes in bf16,
its params cast to bf16 at every call; `LayerNorm` normalises in f32 with
epsilon 1e-6 and returns `dtype`, or the input/param promotion when `dtype`
is None. Dropout is 0 (conf/model/mask3d.yaml) and has no layer here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_NEG = torch.finfo(torch.float32).min / 2   # masked logit (not -inf)


class Dense(nn.Linear):
    """nn.Linear with flax Dense's compute-dtype rule: x, weight and bias are
    cast to `dtype` (f32 when None) at every call. The params are stored in
    `dtype` by construction (an eval model: rounded once at load to the
    values flax rounds its f32 params to at every call, so the cast is a
    no-op); a training model stores f32 masters (`model.float()`)."""

    def __init__(self, in_features: int, out_features: int, dtype=None):
        super().__init__(in_features, out_features, dtype=dtype)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or torch.float32
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with flax LayerNorm's epsilon (1e-6) and dtype rule."""

    def __init__(self, features: int, dtype=None):
        super().__init__(features, eps=1e-6)
        self.dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.dtype or torch.float32)


class MultiheadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.d_head = d_model // num_heads
        self.dtype = dtype
        self.q_proj = Dense(d_model, d_model, dtype)
        self.k_proj = Dense(d_model, d_model, dtype)
        self.v_proj = Dense(d_model, d_model, dtype)
        self.out_proj = Dense(d_model, d_model, dtype)

    def forward(self, q, k, v, block_mask=None):
        """q: (B, Q, D), k/v: (B, P, D), block_mask: (B, Q, P) True = do NOT
        attend. A fully masked row becomes the uniform average (finite
        negative fill, not -inf)."""
        B, Q, _ = q.shape
        P = k.shape[1]
        H, dh = self.num_heads, self.d_head
        qh = self.q_proj(q).view(B, Q, H, dh)
        kh = self.k_proj(k).view(B, P, H, dh)
        vh = self.v_proj(v).view(B, P, H, dh)
        inv_sqrt = torch.tensor(1.0 / dh ** 0.5, dtype=torch.float32
                                ).to(qh.dtype)
        logits = torch.einsum("bqhd,bphd->bhqp", qh, kh) * inv_sqrt
        if block_mask is not None:
            logits = logits.masked_fill(block_mask[:, None], _NEG)
        attn = torch.softmax(logits.float(), dim=-1).to(qh.dtype)
        out = torch.einsum("bhqp,bphd->bqhd", attn, vh)
        return self.out_proj(out.reshape(B, Q, H * dh))


class CrossAttentionLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(d_model, dtype)
        self.attn = MultiheadAttention(d_model, num_heads, dtype)

    def forward(self, tgt, memory, block_mask=None, pos=None, query_pos=None):
        q = tgt if query_pos is None else tgt + query_pos
        k = memory if pos is None else memory + pos
        return self.norm(tgt + self.attn(q, k, memory, block_mask))


class SelfAttentionLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(d_model, dtype)
        self.attn = MultiheadAttention(d_model, num_heads, dtype)

    def forward(self, tgt, query_pos=None):
        q = tgt if query_pos is None else tgt + query_pos
        return self.norm(tgt + self.attn(q, q, tgt))


class FFNLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int = 1024,
                 dtype=torch.float32):
        super().__init__()
        self.linear1 = Dense(d_model, dim_feedforward, dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype)
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, tgt):
        h = self.linear2(torch.relu(self.linear1(tgt)))
        return self.norm(tgt + h)
