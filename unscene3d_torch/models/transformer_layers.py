"""Transformer layers of the mask decoder (counterpart of
unscene3d_tpu/models/transformer_layers.py; XLA there, plain torch here),
post-norm, or pre-norm with `pre_norm=True`.

Dtype semantics follow flax: `Dense(dtype=None)` computes in the promotion of
its input and f32 params (so f32), `Dense(dtype=bf16)` computes in bf16,
its params cast to bf16 at every call; `LayerNorm` normalises in f32 with
epsilon 1e-6 and returns `dtype`, or the input/param promotion when `dtype`
is None. Dropout (`dropout` > 0, conf/model/mask3d.yaml sets 0.0) sits
where the JAX layers put it: on the attention weights, on each residual
branch and on the FFN's hidden activations; it is active under
`.train()` only, its masks drawn from the `generator` that the forward
is given (the trainer's, which also draws the point samples). The JAX
package's chunked (flash) attention for long key sets, which it takes only
at dropout 0, has no counterpart: the port computes every attention in one
pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_NEG = torch.finfo(torch.float32).min / 2   # masked logit (not -inf)


def dropout(x, p: float, training: bool, generator=None):
    """flax nn.Dropout: in training each entry is kept where a uniform draw
    from `generator` lies below 1 - p and scaled by 1 / (1 - p), else
    zeroed; the identity in eval or at p = 0."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


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
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = float(dropout)
        self.num_heads = num_heads
        self.d_head = d_model // num_heads
        self.dtype = dtype
        self.q_proj = Dense(d_model, d_model, dtype)
        self.k_proj = Dense(d_model, d_model, dtype)
        self.v_proj = Dense(d_model, d_model, dtype)
        self.out_proj = Dense(d_model, d_model, dtype)

    def forward(self, q, k, v, block_mask=None, generator=None):
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
        attn = dropout(attn, self.dropout, self.training, generator)
        out = torch.einsum("bhqp,bphd->bqhd", attn, vh)
        return self.out_proj(out.reshape(B, Q, H * dh))


class _Layer(nn.Module):
    """A residual decoder layer: its LayerNorm `norm` (set by the subclass;
    before the branch with pre_norm, after the residual add without) and
    its dropout."""

    def __init__(self, pre_norm: bool, dropout: float):
        super().__init__()
        self.pre_norm = bool(pre_norm)
        self.dropout = float(dropout)

    def _drop(self, x, generator):
        return dropout(x, self.dropout, self.training, generator)

    def _residual(self, tgt, branch):
        if self.pre_norm:
            return tgt + branch
        return self.norm(tgt + branch)


class CrossAttentionLayer(_Layer):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 pre_norm: bool = False, dropout: float = 0.0):
        super().__init__(pre_norm, dropout)
        self.norm = LayerNorm(d_model, dtype)
        self.attn = MultiheadAttention(d_model, num_heads, dtype, dropout)

    def forward(self, tgt, memory, block_mask=None, pos=None, query_pos=None,
                generator=None):
        src = self.norm(tgt) if self.pre_norm else tgt
        q = src if query_pos is None else src + query_pos
        k = memory if pos is None else memory + pos
        tgt2 = self.attn(q, k, memory, block_mask, generator)
        return self._residual(tgt, self._drop(tgt2, generator))


class SelfAttentionLayer(_Layer):
    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32,
                 pre_norm: bool = False, dropout: float = 0.0):
        super().__init__(pre_norm, dropout)
        self.norm = LayerNorm(d_model, dtype)
        self.attn = MultiheadAttention(d_model, num_heads, dtype, dropout)

    def forward(self, tgt, query_pos=None, generator=None):
        src = self.norm(tgt) if self.pre_norm else tgt
        q = src if query_pos is None else src + query_pos
        tgt2 = self.attn(q, q, src, generator=generator)
        return self._residual(tgt, self._drop(tgt2, generator))


class FFNLayer(_Layer):
    def __init__(self, d_model: int, dim_feedforward: int = 1024,
                 dtype=torch.float32, pre_norm: bool = False,
                 dropout: float = 0.0):
        super().__init__(pre_norm, dropout)
        self.linear1 = Dense(d_model, dim_feedforward, dtype)
        self.linear2 = Dense(dim_feedforward, d_model, dtype)
        self.norm = LayerNorm(d_model, dtype)

    def forward(self, tgt, generator=None):
        src = self.norm(tgt) if self.pre_norm else tgt
        h = self._drop(torch.relu(self.linear1(src)), generator)
        h = self._drop(self.linear2(h), generator)
        return self._residual(tgt, h)
