"""The port's noise-robust tri-plane loss (unscene3d_torch/ops/triplane.py
and the criterion's `_loss_noise_robust`) against the JAX package's.

  * `build_triplane_maps` bitwise the JAX function on collated batches
    (three seeds) and on raw coords with padding rows; the host tables of
    kernel 3 (one order holding every valid voxel once per plane, the
    per-pixel counts, the per-scene pixel counts) against the JAX maps;
  * the loss and its gradient against `unscene3d_tpu.ops.triplane.
    triplane_projection_loss` and against the numpy oracle of
    tests/test_triplane.py; several sets in one call equal one call per
    set;
  * `gather_rows` (the criterion's segment-to-voxel spread, whose backward
    is kernel 3 on the card) against autograd's gather;
  * the criterion at `weight_noise_robust=1.0` against the JAX criterion
    fed the voxel logits of every set (`return_aux_vox`'s layout): every
    term of every set, and the gradient of the total.

Tolerances: the sums run in another order than XLA's (kernel 3's order,
or index_add_ on the CPU), so the loss agrees to rtol 1e-5, and gradients
to 1e-6 absolute plus 1e-5 of the largest entry; maps, orders and counts
are integers and equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_jax import one_torch_thread  # noqa: F401
from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_batch
from unscene3d_tpu.losses.criterion import SetCriterion as JaxCriterion
from unscene3d_tpu.losses.matcher import HungarianMatcher as JaxMatcher
from unscene3d_tpu.ops import triplane as jax_tri
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.losses.criterion import SetCriterion
from unscene3d_torch.losses.matcher import HungarianMatcher
from unscene3d_torch.ops import triplane as tri_ops
from unscene3d_torch.ops.segment_pool import gather_rows

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5
VOXEL = 0.12


def _t(a):
    return torch.from_numpy(np.array(a))


def _grad_close(got, ref, msg=""):
    ref = np.asarray(ref, np.float32)
    err = np.abs(got.detach().numpy() - ref).max()
    assert err <= GRAD_ATOL + GRAD_RTOL * np.abs(ref).max(), (msg, err)


@pytest.fixture(scope="module", params=[0, 1, 2])
def batches(request):
    scenes = make_batch(2, num_points=1500, seed=request.param)
    jb, _ = JaxCollator(voxel_size=VOXEL, fps_queries=8,
                        build_triplane=True)(scenes)
    tb, _ = FreeMaskCollator(voxel_size=VOXEL, fps_queries=8,
                             build_triplane=True)(scenes)
    return jb, tb


def test_maps_equal_jax_bitwise(batches):
    jb, tb = batches
    jt, tt = jb.triplane, tb.triplane
    for name in ("pixel_id", "pix_scene", "pix_valid"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)


def test_kernel_tables_against_the_maps(batches):
    """The order holds each valid row once per plane, sorted by pixel;
    the counts are the JAX function's segment counts summed over planes;
    each scene's pixel count is its occupied pixels."""
    jb, tb = batches
    tt = tb.triplane
    valid = np.asarray(jb.valid)
    pid = np.asarray(jb.triplane.pixel_id)
    n_pix = tt.num_pixels
    want = sum(np.bincount(pid[d][valid], minlength=n_pix) for d in range(3))
    np.testing.assert_array_equal(tt.counts.numpy(), want)
    offsets = tt.offsets.numpy()
    np.testing.assert_array_equal(np.diff(offsets), want)
    order = tt.order.numpy()
    assert len(order) == 3 * valid.sum()
    for p in np.random.RandomState(0).choice(int(want.astype(bool).sum()),
                                             20):
        rows = order[offsets[p]:offsets[p + 1]]
        assert np.all(np.diff(rows) > 0)
        assert all(p in pid[:, r] for r in rows)
    pv, ps = np.asarray(jb.triplane.pix_valid), np.asarray(jb.triplane.pix_scene)
    np.testing.assert_array_equal(
        tt.npix_scene.numpy(), np.bincount(ps[pv & (want > 0)], minlength=2))


def test_maps_with_padding_rows_equal_jax():
    r = np.random.RandomState(1)
    coords = np.unique(np.column_stack([r.randint(0, 3, 300),
                                        r.randint(-4, 9, (300, 3))]), axis=0)
    n = len(coords)
    coords_p = np.zeros((n + 7, 4), np.int64)
    coords_p[:n] = coords
    valid = np.arange(n + 7) < n
    for pad in (None, 2048):
        ref = jax_tri.build_triplane_maps(coords_p, valid, 3, n_pix_pad=pad)
        got = tri_ops.build_triplane_maps(coords_p, valid, 3, n_pix_pad=pad)
        for name in ("pixel_id", "pix_scene", "pix_valid"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)))


def _inputs(batch, seed, t_drop=True):
    rng = np.random.RandomState(seed)
    n0 = batch.target.vox_masks.shape[0]
    T = batch.target.vox_masks.shape[1]
    logits = (rng.randn(n0, T) * 2).astype(np.float32)
    t_valid = np.asarray(batch.target.valid).copy()
    if t_drop:
        t_valid[0, 0] = False
    return logits, t_valid


def test_loss_and_gradient_match_jax(batches):
    jb, tb = batches
    logits, t_valid = _inputs(jb, 5)
    target = np.asarray(jb.target.vox_masks, np.float32)

    def jax_loss(x):
        return jax_tri.triplane_projection_loss(
            jax.nn.sigmoid(x), jnp.asarray(target), jb.triplane, jb.valid,
            jnp.asarray(t_valid), 2)

    ref, ref_g = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    got = tri_ops.triplane_projection_loss(
        torch.sigmoid(x), _t(target), tb.triplane, tb.valid, _t(t_valid))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=LOSS_RTOL)
    _grad_close(x.grad, ref_g)
    assert not x.grad[~tb.valid].any()


def test_several_sets_in_one_call_equal_one_call_per_set(batches):
    _, tb = batches
    rng = np.random.RandomState(6)
    target = tb.target.vox_masks.float()
    n0, T = target.shape
    pred = torch.sigmoid(torch.from_numpy(rng.randn(n0, 3, T)
                                          .astype(np.float32)))
    t_valid = tb.target.valid[None].repeat(3, 1, 1)
    t_valid[1, 1, :2] = False
    t_norm = tri_ops.normalized_target_projection(target, tb.triplane,
                                                  tb.valid)
    got = tri_ops.triplane_losses(pred, t_norm, tb.triplane, tb.valid,
                                  t_valid)
    for l in range(3):
        one = tri_ops.triplane_projection_loss(
            pred[:, l], target, tb.triplane, tb.valid, t_valid[l])
        np.testing.assert_allclose(got[l].item(), one.item(), rtol=1e-6)


def test_loss_matches_the_numpy_oracle():
    """tests/test_triplane.py's oracle: dense per-scene plane projections
    of random coords with padding rows."""
    r = np.random.RandomState(0)
    n, t, b = 60, 3, 2
    coords = np.unique(np.column_stack([r.randint(0, b, n),
                                        r.randint(0, 6, (n, 3))]), axis=0)
    n = len(coords)
    coords_p = np.zeros((n + 4, 4), np.int64)
    coords_p[:n] = coords
    valid = np.arange(n + 4) < n
    pred = r.rand(n + 4, t).astype(np.float32).clip(0.05, 0.95)
    tgt = (r.rand(n + 4, t) > 0.5).astype(np.float32)
    pred[~valid] = 0
    tgt[~valid] = 0
    tri = tri_ops.build_triplane_maps(coords_p, valid, b)
    loss = tri_ops.triplane_projection_loss(
        _t(pred), _t(tgt), tri, _t(valid), torch.ones(b, t, dtype=bool))
    expected = 0.0
    for sb in range(b):
        rows = np.nonzero(valid & (coords_p[:, 0] == sb))[0]
        scene_loss, npix = 0.0, 0
        for a, c in ((1, 2), (1, 3), (2, 3)):
            keys = {}
            for i in rows:
                keys.setdefault((coords_p[i, a], coords_p[i, c]), []).append(i)
            npix += len(keys)
            for members in keys.values():
                p = np.clip(pred[members].mean(0), 1e-7, 1 - 1e-7)
                q = tgt[members].mean(0)
                scene_loss += float((-(q * np.log(p)
                                       + (1 - q) * np.log(1 - p))).sum())
        expected += scene_loss / (t * npix)
    np.testing.assert_allclose(loss.item(), expected, rtol=LOSS_RTOL)


def test_gather_rows_matches_autograd_gather(batches):
    _, tb = batches
    S = tb.batch_size * tb.num_segments_padded
    seg_flat = tb.batch_idx.long() * tb.num_segments_padded \
        + tb.point2segment.long()
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(S, 5).astype(np.float32))
    g = torch.from_numpy(rng.randn(len(seg_flat), 5).astype(np.float32))
    a = x.clone().requires_grad_()
    out = gather_rows(a, seg_flat, tb.valid, tb.seg_order, tb.seg_offsets,
                      tb.seg_pieces)
    (out * g).sum().backward()
    b = x.clone().requires_grad_()
    ref = b[seg_flat] * tb.valid[:, None].float()
    (ref * g).sum().backward()
    assert torch.equal(out, ref)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("droploss", [False, True])
def test_criterion_noise_robust_matches_jax(batches, droploss):
    """Every term of every set and the gradient of the total through the
    segment logits: JAX reads them as voxel logits of every set (the
    layout of `return_aux_vox`), the port from the segment logits."""
    jb, tb = batches
    rng = np.random.RandomState(8)
    L, Q, C = 3, 8, 3
    B, S = np.asarray(jb.seg_valid).shape
    logits = (rng.randn(L, B, Q, C) * 2).astype(np.float32)
    masks = (rng.randn(L, B, S, Q) * 3).astype(np.float32)
    kw = dict(num_classes=C, weight_noise_robust=1.0, use_droploss=droploss,
              droploss_iou_thresh=0.3)
    seg_flat = jb.batch_idx * S + jb.point2segment
    crit_j = JaxCriterion(matcher=JaxMatcher(solver="scipy"), **kw)

    def jax_total(m):
        vox = jnp.take(m.reshape(L, B * S, Q), seg_flat, axis=1) \
            * jb.valid[None, :, None].astype(m.dtype)
        out = crit_j({"pred_logits": jnp.asarray(logits),
                      "pred_masks_seg": m, "pred_masks_vox": vox}, jb,
                     triplane=jb.triplane)
        return out["total"], out

    (_, ref), ref_g = jax.value_and_grad(jax_total, has_aux=True)(
        jnp.asarray(masks))
    m = _t(masks).requires_grad_()
    got = SetCriterion(matcher=HungarianMatcher(solver="scipy"), **kw)(
        {"pred_logits": _t(logits), "pred_masks_seg": m}, tb)
    got["total"].backward()
    assert float(np.min(ref["loss_noise_robust"])) > 0
    for key in ("loss_ce", "loss_mask", "loss_dice", "loss_noise_robust",
                "total"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(ref[key]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=key)
    _grad_close(m.grad, ref_g)
