"""Modules of the PyTorch port against their JAX counterparts, each on the
same numpy inputs with the JAX init's weights carried across by
models/weights.py: BasicBlock (eval, fused epilogue), the Res16UNet
backbone, the conv ops, the positional encodings, each transformer layer
and the segment ops.

f32 tolerance rtol 2e-4 / atol 2e-5 (tests/test_scan_decoder.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_batch
from unscene3d_tpu.models import backbone as jax_backbone
from unscene3d_tpu.models import position_embedding as jax_pe
from unscene3d_tpu.models import sparse_modules as jax_sm
from unscene3d_tpu.models import transformer_layers as jax_tl
from unscene3d_tpu.ops import conv_ops as jax_conv_ops
from unscene3d_tpu.ops import segment_ops as jax_seg
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.models import backbone as torch_backbone
from unscene3d_torch.models import position_embedding as torch_pe
from unscene3d_torch.models import sparse_modules as torch_sm
from unscene3d_torch.models import transformer_layers as torch_tl
from unscene3d_torch.models.weights import load_flax_variables
from unscene3d_torch.ops import conv_ops as torch_conv_ops
from unscene3d_torch.ops import segment_ops as torch_seg

from tests._torch_jax import np_tree, random_bn

RTOL, ATOL = 2e-4, 2e-5
KEY = jax.random.PRNGKey(0)


class _Holder(nn.Module):
    """Puts a sparse module under `backbone`, where the weight bridge copies
    sparse-conv kernels as they are."""

    def __init__(self, mod):
        super().__init__()
        self.backbone = mod


def _load_sparse(mod, variables):
    """Load the JAX variables; returns the module in eval mode (folded BN),
    the branch these tests hold against the JAX eval modules."""
    load_flax_variables(_Holder(mod), {
        c: {"backbone": variables[c]} for c in ("params", "batch_stats")})
    return mod.eval()


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def batches():
    scenes = make_batch(2, num_points=1500)
    jb, _ = JaxCollator(voxel_size=0.12, fps_queries=8)(scenes)
    tb, _ = FreeMaskCollator(voxel_size=0.12, fps_queries=8)(scenes)
    return jb, tb


# ---------------------------------------------------------- sparse modules
@pytest.mark.parametrize("cin,planes", [(32, 32), (48, 32)])
def test_basic_block_eval(batches, cin, planes):
    jb, tb = batches
    lv = 1
    jl, tl = jb.graph.levels[lv], tb.graph.levels[lv]
    rng = np.random.RandomState(cin)
    x = (rng.randn(jl.num_padded, cin) * np.asarray(jl.valid)[:, None]
         ).astype(np.float32)
    block = jax_sm.BasicBlock(planes)
    v = random_bn(block.init(KEY, jnp.asarray(x), jl, False))
    ref = block.apply(v, jnp.asarray(x), jl, False)
    mod = _load_sparse(torch_sm.BasicBlock(cin, planes), v)
    with torch.no_grad():     # the fused epilogue is forward only
        _close(mod(torch.from_numpy(x), tl), ref)


def test_backbone_eval(batches):
    jb, tb = batches
    model = jax_backbone.Res16UNet14A(out_channels=2)
    v = random_bn(jax.jit(lambda f, g: model.init(
        KEY, f, g, train=False))(jb.features, jb.graph))
    res1, fpn, final = jax.jit(lambda v, f, g: model.apply(
        v, f, g, train=False))(v, jb.features, jb.graph)
    mod = _load_sparse(torch_backbone.Res16UNet14A(out_channels=2), v)
    with torch.no_grad():
        t_res1, t_fpn, t_final = mod(tb.features, tb.graph)
    _close(t_res1, res1)
    assert len(t_fpn) == len(fpn) == 5
    for a, b in zip(t_fpn, fpn):
        _close(a, b)
    _close(t_final, final)


@pytest.mark.parametrize("op", ["down2", "up2", "avg_pool2"])
def test_conv_ops_match_jax(batches, op):
    """The k2 ops through kernel 2 (its twin here) against the JAX ops'
    gather formulations."""
    jb, tb = batches
    J, T = jb.graph.levels, tb.graph.levels
    rng = np.random.RandomState(1)
    if op == "down2":
        x = rng.randn(J[0].num_padded, 16).astype(np.float32)
        w = (rng.randn(8, 16, 24) * 0.2).astype(np.float32)
        b = rng.randn(24).astype(np.float32)
        ref = jax_conv_ops.sparse_conv_down2(jnp.asarray(x), jnp.asarray(w),
                                             J[1], jnp.asarray(b))
        got = torch_conv_ops.sparse_conv_down2(
            torch.from_numpy(x), torch.from_numpy(w), T[1],
            torch.from_numpy(b))
    elif op == "up2":
        x = rng.randn(J[1].num_padded, 16).astype(np.float32)
        w = (rng.randn(8, 16, 24) * 0.2).astype(np.float32)
        b = rng.randn(24).astype(np.float32)
        ref = jax_conv_ops.sparse_conv_up2(jnp.asarray(x), jnp.asarray(w),
                                           J[0], jnp.asarray(b))
        got = torch_conv_ops.sparse_conv_up2(
            torch.from_numpy(x), torch.from_numpy(w), T[0],
            torch.from_numpy(b))
    else:
        x = rng.randn(J[0].num_padded, 3).astype(np.float32)
        ref = jax_conv_ops.avg_pool2(jnp.asarray(x), J[1])
        got = torch_conv_ops.avg_pool2(torch.from_numpy(x), T[1])
    _close(got, ref)


# -------------------------------------------------------- decoder modules
@pytest.mark.parametrize("pos_type", ["fourier", "sine", "legacy"])
def test_position_embedding(pos_type):
    rng = np.random.RandomState(0)
    xyz = (rng.rand(2, 50, 3) * 4).astype(np.float32)
    mn = xyz.min(1, keepdims=True)
    mx = xyz.max(1, keepdims=True)
    mod = jax_pe.PositionEmbeddingCoordsSine(d_pos=32, pos_type=pos_type)
    args = tuple(jnp.asarray(a) for a in (xyz, mn, mx))
    v = np_tree(mod.init(KEY, *args))
    ref = mod.apply(v, *args)
    tmod = torch_pe.PositionEmbeddingCoordsSine(d_pos=32, pos_type=pos_type)
    if pos_type == "fourier":
        load_flax_variables(tmod, v)
    _close(tmod(*(torch.from_numpy(a) for a in (xyz, mn, mx))), ref)


def _block_mask(rng, B, Q, P):
    m = rng.rand(B, Q, P) > 0.6
    m[0, 1] = True            # a fully masked query: uniform average
    return m


@pytest.mark.parametrize("P", [64, 16384])   # 16384 takes JAX's flash path
def test_cross_attention_layer(P):
    rng = np.random.RandomState(P)
    B, Q, D, H = 1, 4, 16, 2
    tgt, qpos = (rng.randn(2, B, Q, D)).astype(np.float32)
    mem, pos = (rng.randn(2, B, P, D)).astype(np.float32)
    mask = _block_mask(rng, B, Q, P)
    mod = jax_tl.CrossAttentionLayer(D, H)
    args = [jnp.asarray(a) for a in (tgt, mem, mask)]
    kw = dict(pos=jnp.asarray(pos), query_pos=jnp.asarray(qpos))
    v = np_tree(mod.init(KEY, *args, **kw))
    ref = mod.apply(v, *args, **kw)
    tmod = torch_tl.CrossAttentionLayer(D, H)
    load_flax_variables(tmod, v)
    t = torch.from_numpy
    _close(tmod(t(tgt), t(mem), block_mask=t(mask), pos=t(pos),
                query_pos=t(qpos)), ref)


def test_self_attention_and_ffn_layers():
    rng = np.random.RandomState(2)
    B, Q, D, H = 2, 8, 32, 4
    tgt, qpos = rng.randn(2, B, Q, D).astype(np.float32)
    sa = jax_tl.SelfAttentionLayer(D, H)
    v = np_tree(sa.init(KEY, jnp.asarray(tgt), query_pos=jnp.asarray(qpos)))
    ref = sa.apply(v, jnp.asarray(tgt), query_pos=jnp.asarray(qpos))
    tsa = torch_tl.SelfAttentionLayer(D, H)
    load_flax_variables(tsa, v)
    _close(tsa(torch.from_numpy(tgt), query_pos=torch.from_numpy(qpos)), ref)

    ffn = jax_tl.FFNLayer(D, 64)
    v = np_tree(ffn.init(KEY, jnp.asarray(tgt)))
    ref = ffn.apply(v, jnp.asarray(tgt))
    tffn = torch_tl.FFNLayer(D, 64)
    load_flax_variables(tffn, v)
    _close(tffn(torch.from_numpy(tgt)), ref)


# ------------------------------------------------------------ segment ops
@pytest.mark.parametrize("name", ["segment_count", "segment_mean",
                                  "segment_max"])
def test_segment_ops(name):
    rng = np.random.RandomState(4)
    n, s = 300, 12
    x = rng.randn(n, 5).astype(np.float32)
    ids = rng.randint(0, s - 2, n).astype(np.int32)    # last 2 stay empty
    valid = rng.rand(n) > 0.2
    if name == "segment_count":
        ref = jax_seg.segment_count(jnp.asarray(ids), s, jnp.asarray(valid))
        got = torch_seg.segment_count(torch.from_numpy(ids), s,
                                      torch.from_numpy(valid))
    else:
        ref = getattr(jax_seg, name)(jnp.asarray(x), jnp.asarray(ids), s,
                                     jnp.asarray(valid))
        got = getattr(torch_seg, name)(torch.from_numpy(x),
                                       torch.from_numpy(ids), s,
                                       torch.from_numpy(valid))
    _close(got, ref)
