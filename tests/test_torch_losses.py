"""The PyTorch port's matcher and set criterion against the JAX package's.

Inputs are random prediction logits from a numpy seed over the targets of a
collated scene pair (both collators build the same targets,
tests/test_torch_collate.py). The cost matrices agree to rtol 1e-5 / atol
1e-5 (f32 softplus / sigmoid / einsum in other orders); the auction solver
fed JAX's own cost tensor returns JAX's indices exactly (the same f32
bids, prices and first-maximum ties), and so does the scipy solver; the
criterion's terms per prediction set agree to rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_batch
from unscene3d_tpu.losses.criterion import SetCriterion as JaxCriterion
from unscene3d_tpu.losses.matcher import HungarianMatcher as JaxMatcher
from unscene3d_tpu.losses.matcher import _host_lsap
from unscene3d_tpu.losses.matcher import solve_lsap_auction as jax_auction
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.losses.criterion import SetCriterion
from unscene3d_torch.losses.matcher import (HungarianMatcher, solve_lsap,
                                            solve_lsap_auction)

RTOL = 1e-5
L, Q, C = 5, 10, 3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def batches():
    scenes = make_batch(2, num_points=1500)
    # a scene with 11 instances pads the targets to 16: padded columns
    scenes[1]["masks"] = np.concatenate(
        [scenes[1]["masks"], scenes[0]["masks"][:, :3]], axis=1)
    jb, _ = JaxCollator(voxel_size=0.12, fps_queries=Q)(scenes)
    tb, _ = FreeMaskCollator(voxel_size=0.12, fps_queries=Q)(scenes)
    return jb, tb


def _preds(batch, seed):
    rng = np.random.RandomState(seed)
    B, S = np.asarray(batch.seg_valid).shape
    logits = (rng.randn(L, B, Q, C) * 2).astype(np.float32)
    masks = (rng.randn(L, B, S, Q) * 3).astype(np.float32)
    return logits, masks


def _jax_cost(jb, logits, masks, labels=None):
    t = jb.target
    labels = t.labels if labels is None else labels
    return JaxMatcher().cost_matrix(
        jnp.asarray(logits), jnp.asarray(masks),
        jnp.asarray(labels)[None].repeat(L, 0),
        t.seg_masks[None].astype(jnp.float32).repeat(L, 0),
        t.valid[None].repeat(L, 0), jb.seg_valid[None].repeat(L, 0))


@pytest.mark.parametrize("ignore", [False, True])
def test_cost_matrix_matches_jax(batches, ignore):
    jb, tb = batches
    logits, masks = _preds(jb, 0)
    labels = np.array(jb.target.labels)
    if ignore:
        labels[0, 1] = 253                      # the matcher's ignore label
    ref = _jax_cost(jb, logits, masks, labels)
    t = tb.target
    got = HungarianMatcher().cost_matrix(
        _t(logits), _t(masks), _t(labels)[None].repeat(L, 1, 1),
        t.seg_masks[None].float().repeat(L, 1, 1, 1),
        t.valid[None].repeat(L, 1, 1), tb.seg_valid[None].repeat(L, 1, 1))
    assert got.shape == (L, 2, Q, labels.shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auction_on_jax_costs_gives_jax_indices(batches, seed):
    jb, tb = batches
    logits, masks = _preds(jb, seed)
    cost = _jax_cost(jb, logits, masks)
    valid = jb.target.valid[None].repeat(L, 0)
    ref = np.asarray(jax_auction(cost, valid))
    got = solve_lsap_auction(_t(cost), tb.target.valid[None].repeat(L, 1, 1))
    np.testing.assert_array_equal(got.numpy(), ref)
    # a dense random cost with every target real (the eps of the auction is
    # then small, and bids contend for queries)
    rng = np.random.RandomState(seed)
    dense = rng.rand(6, Q, 8).astype(np.float32)
    np.testing.assert_array_equal(
        solve_lsap_auction(_t(dense)).numpy(),
        np.asarray(jax_auction(jnp.asarray(dense))))


def test_scipy_solver_matches_jax_host_lsap(batches):
    jb, _ = batches
    cost = np.asarray(_jax_cost(jb, *_preds(jb, 3)))
    np.testing.assert_array_equal(solve_lsap(_t(cost)).numpy(),
                                  _host_lsap(cost))


@pytest.mark.parametrize("droploss,ignore_idx", [(False, ()), (True, ()),
                                                 (False, (0, 3))])
def test_criterion_terms_match_jax(batches, droploss, ignore_idx):
    jb, tb = batches
    logits, masks = _preds(jb, 4)
    kw = dict(num_classes=C, use_droploss=droploss, droploss_iou_thresh=0.3,
              ignore_mask_idx=ignore_idx)
    ref = JaxCriterion(matcher=JaxMatcher(), **kw)(
        {"pred_logits": jnp.asarray(logits),
         "pred_masks_seg": jnp.asarray(masks)}, jb)
    got = SetCriterion(matcher=HungarianMatcher(), **kw)(
        {"pred_logits": _t(logits), "pred_masks_seg": _t(masks)}, tb)
    for key in ("loss_ce", "loss_mask", "loss_dice", "loss_noise_robust",
                "total", "num_masks"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=RTOL, atol=1e-7, err_msg=key)


def test_noise_robust_loss_is_not_ported():
    with pytest.raises(NotImplementedError, match="tri-plane"):
        SetCriterion(matcher=HungarianMatcher(), weight_noise_robust=1.0)
