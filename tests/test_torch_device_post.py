"""The device half of the port's eval post-processing and its segment-space
tail against the JAX package.

- `eval/device_post.py:pack_eval_outputs` against the JAX package's
  `Trainer.build_eval_step_device_post`: on the tiny model of
  tests/test_torch_mask3d.py (Res16UNet14A, hidden 32, 8 queries, voxel
  0.12) with the JAX init's weights bridged, probs and mask scores to that
  file's f32 forward tolerance (rtol 2e-4, atol 2e-5), the packed masks of
  the two forwards bitwise; on the same voxel logits (the JAX step run over
  a model that returns given outputs) the packed masks bitwise and the
  scores to f32 rounding (rtol 1e-6).
- The whole `Predictor` (device-post route) against the JAX step plus
  `eval_scene_predictions_packed`: masks and classes equal, scores to the
  forward tolerance.
- The port's `eval_scene_predictions_packed` against the JAX function of the
  same name, exactly equal outputs, and against the port's host route to
  the reference's contract (tests/test_eval.py:99): masks and classes
  exactly equal, scores rtol 1e-5 (f32 sigmoid sums on the device, f64 on
  the host).
- `dbscan_split_queries` (scipy) against the JAX function (scikit-learn),
  min_points 1 and 3, equal masks and logits; `dbscan_labels` against
  sklearn's labels on clustered, uniform and flat point sets.

The JAX model is jitted once for the module.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN

from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.eval import postprocess as jax_post
from unscene3d_tpu.losses.criterion import SetCriterion as JaxCriterion
from unscene3d_tpu.losses.matcher import HungarianMatcher as JaxMatcher
from unscene3d_tpu.train.loop import Trainer as JaxTrainer
from unscene3d_tpu.train.loop import TrainState
from unscene3d_tpu.train.loop import make_optimizer as jax_make_optimizer
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.eval import postprocess as port_post
from unscene3d_torch.eval.device_post import pack_eval_outputs, to_host
from unscene3d_torch.inference import EVAL_DEFAULTS, Predictor

from tests._torch_jax import one_torch_thread, random_bn  # noqa: F401
from tests.test_torch_mask3d import VOXEL, jax_model, torch_model

RTOL, ATOL = 2e-4, 2e-5      # the f32 forward's (tests/test_torch_mask3d.py)
ROUTE_RTOL = 1e-5            # device route vs host route, same forward


def _state(variables):
    return TrainState(step=jnp.zeros((), jnp.int32),
                      params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      buffers=variables.get("buffers", {}), opt_state=None)


class _GivenOutputs:
    """A stand-in model whose outputs are read from its params, so that the
    JAX step packs given voxel logits."""

    def apply(self, variables, batch, train=False, is_eval=True):
        p = variables["params"]
        return {"pred_logits": [p["logits"][None]],
                "pred_masks_vox": [p["vox"]]}


@pytest.fixture(scope="module")
def scene():
    return make_scene(num_points=1500, seed=5)


@pytest.fixture(scope="module")
def jax_side(scene):
    """The JAX model's variables (random BN state) and the device-post step
    of a JAX Trainer over it, on the scene."""
    jbatch, jmeta = JaxCollator(voxel_size=VOXEL, fps_queries=8)([scene])
    model = jax_model()
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        b, train=False, is_eval=True))(jbatch)
    variables = random_bn(variables)
    trainer = JaxTrainer(model, JaxCriterion(matcher=JaxMatcher(
        solver="scipy"), num_classes=3), jax_make_optimizer(lr=1e-4))
    post = trainer.build_eval_step_device_post()(_state(variables), jbatch)
    return variables, jbatch, jmeta, jax.tree.map(np.asarray, post)


@pytest.fixture(scope="module")
def port_side(scene, jax_side):
    variables = jax_side[0]
    model = torch_model(variables)
    batch, meta = FreeMaskCollator(voxel_size=VOXEL, fps_queries=8)([scene])
    out = model(batch)
    return model, batch, meta, out


def _jax_pack(logits, vox, jbatch):
    """The JAX package's device-post step over given outputs."""
    step = JaxTrainer.build_eval_step_device_post(
        types.SimpleNamespace(model=_GivenOutputs()))
    state = _state({"params": {"logits": jnp.asarray(logits),
                               "vox": jnp.asarray(vox)},
                    "batch_stats": {}})
    return jax.tree.map(np.asarray, step(state, jbatch))


def test_pack_eval_outputs_matches_jax_device_post(jax_side, port_side):
    _, _, _, ref = jax_side
    _, batch, _, out = port_side
    got = to_host(pack_eval_outputs(out, batch.graph.levels[0].valid))
    assert got["probs"].dtype == np.float32
    assert got["mask_scores"].dtype == np.float32
    assert got["packed"].dtype == np.uint8
    for key in ("probs", "mask_scores"):
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    assert got["packed"].shape == ref["packed"].shape
    flips = int(np.unpackbits(got["packed"] ^ ref["packed"]).sum())
    assert flips == 0, f"{flips} mask bits differ"


def test_pack_is_bitwise_the_jax_pack_on_the_same_logits(jax_side,
                                                         port_side):
    """The port's voxel logits through both packings; the level's padding
    rows (valid False) hold positive logits and must pack as 0 bits."""
    _, jbatch, _, _ = jax_side
    _, batch, _, out = port_side
    valid = batch.graph.levels[0].valid
    vox = out["pred_masks_vox"][-1].detach().clone()
    vox[~valid] = 1.0
    assert (~valid).any()
    logits = out["pred_logits"][-1][0].detach()
    got = to_host(pack_eval_outputs({"pred_logits": [logits[None]],
                                     "pred_masks_vox": [vox]}, valid))
    ref = _jax_pack(logits.numpy(), vox.numpy(), jbatch)
    np.testing.assert_array_equal(got["packed"], ref["packed"])
    binary = (vox.numpy() > 0) & valid.numpy()[:, None]
    np.testing.assert_array_equal(got["packed"], np.packbits(binary, axis=0))
    for key in ("probs", "mask_scores"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=0,
                                   err_msg=key)


def test_pack_pads_a_row_count_that_is_no_multiple_of_8():
    rng = np.random.RandomState(3)
    n_pad, q = 21, 5
    vox = torch.from_numpy(rng.randn(n_pad, q).astype(np.float32))
    valid = torch.arange(n_pad) < 17
    logits = torch.from_numpy(rng.randn(1, q, 3).astype(np.float32))
    got = to_host(pack_eval_outputs({"pred_logits": [logits],
                                     "pred_masks_vox": [vox]}, valid))
    binary = (vox.numpy() > 0) & valid.numpy()[:, None]
    assert got["packed"].shape == (3, q)
    np.testing.assert_array_equal(got["packed"], np.packbits(binary, axis=0))
    pos = binary.sum(0)
    heat = 1.0 / (1.0 + np.exp(-vox.numpy().astype(np.float64)))
    np.testing.assert_allclose(got["mask_scores"],
                               (heat * binary).sum(0) / (pos + 1e-6),
                               rtol=1e-6)


def test_predictor_matches_jax_device_post_and_packed_tail(scene, jax_side,
                                                           port_side):
    _, _, jmeta, jpost = jax_side
    model = port_side[0]
    ref = jax_post.eval_scene_predictions_packed(
        jpost["probs"], jpost["mask_scores"], jpost["packed"],
        jmeta.num_voxels[0], inverse_map=jmeta.inverse_maps[0],
        point2segment_full=jmeta.original_segments[0],
        segment_connectivity=jmeta.segment_connectivity[0], **EVAL_DEFAULTS)
    got = Predictor(model, "cpu", voxel_size=VOXEL, fine_buckets=False)(scene)
    assert got["masks"].shape == ref["masks"].shape == (len(scene["xyz"]), 8)
    assert got["masks"].dtype == bool
    np.testing.assert_array_equal(got["masks"], ref["masks"])
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=RTOL,
                               atol=1e-6)


OPTIONS = {
    "defaults": EVAL_DEFAULTS,
    "filter": dict(EVAL_DEFAULTS, filter_instances=True, iou_threshold=0.6,
                   scores_threshold=0.1),
    "separate": dict(EVAL_DEFAULTS, filter_instances=True, iou_threshold=0.6,
                     separate_instances=True),
}


def _packed_case(seed=0):
    """Seeded voxel logits over a padded level, points, segments and their
    connectivity (the inputs of tests/test_torch_mask3d.py's post test)."""
    rng = np.random.RandomState(seed)
    n_pts, n_vox, n_pad, n_seg, q = 3000, 900, 1030, 40, 12
    logits = rng.randn(q, 3).astype(np.float32)
    vox = (rng.randn(n_pad, q) * 2).astype(np.float32)
    inverse_map = rng.randint(0, n_vox, n_pts)
    inverse_map[:n_vox] = np.arange(n_vox)
    p2s = np.sort(rng.randint(0, n_seg, n_pts))
    p2s[:n_seg] = np.arange(n_seg)
    conn = rng.randint(0, n_seg, (60, 2))
    valid = np.arange(n_pad) < n_vox
    return logits, vox, valid, n_vox, dict(
        inverse_map=inverse_map, point2segment_full=p2s,
        segment_connectivity=conn)


@pytest.mark.parametrize("options", OPTIONS.values(), ids=OPTIONS.keys())
def test_packed_eval_equals_the_jax_function(options):
    logits, vox, valid, n_vox, kw = _packed_case()
    post = to_host(pack_eval_outputs(
        {"pred_logits": [torch.from_numpy(logits)[None]],
         "pred_masks_vox": [torch.from_numpy(vox)]}, torch.from_numpy(valid)))
    args = (post["probs"], post["mask_scores"], post["packed"], n_vox)
    ref = jax_post.eval_scene_predictions_packed(*args, **kw, **options)
    got = port_post.eval_scene_predictions_packed(*args, **kw, **options)
    sv = port_post.SegmentVote(kw["inverse_map"], kw["point2segment_full"])
    again = port_post.eval_scene_predictions_packed(*args, seg_vote=sv, **kw,
                                                    **options)
    assert set(got) == set(ref) == {"masks", "classes", "scores"}
    assert ref["masks"].shape[1] > 0
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(again[key], ref[key], err_msg=key)


@pytest.mark.parametrize("options", OPTIONS.values(), ids=OPTIONS.keys())
def test_packed_route_matches_the_host_route(options):
    logits, vox, valid, n_vox, kw = _packed_case(seed=1)
    want = port_post.eval_scene_predictions(logits, vox[:n_vox], **kw,
                                            **options)
    post = to_host(pack_eval_outputs(
        {"pred_logits": [torch.from_numpy(logits)[None]],
         "pred_masks_vox": [torch.from_numpy(vox)]}, torch.from_numpy(valid)))
    got = port_post.eval_scene_predictions_packed(
        post["probs"], post["mask_scores"], post["packed"], n_vox, **kw,
        **options)
    assert want["masks"].shape[1] > 0
    np.testing.assert_array_equal(got["masks"], want["masks"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"],
                               rtol=ROUTE_RTOL)


@pytest.mark.parametrize("min_points", [1, 3])
def test_dbscan_split_matches_jax(min_points):
    """Coords in a 4 m box, eps 0.3: each query's positive voxels break into
    several clusters (and, at min_points 3, border and noise points)."""
    rng = np.random.RandomState(min_points)
    n, q = 1200, 6
    coords = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    vox = rng.randn(n, q).astype(np.float32)
    vox[:, 0] = -1.0                       # a query with no positive voxel
    logits = rng.randn(q, 3).astype(np.float32)
    ref = jax_post.dbscan_split_queries(vox, logits, coords, 0.3, min_points)
    got = port_post.dbscan_split_queries(vox, logits, coords, 0.3, min_points)
    assert ref[0].shape[1] > 2 * q
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def _points(kind, rng, n):
    if kind == "blobs":
        centres = rng.uniform(0, 6, (5, 3))
        return centres[rng.randint(0, 5, n)] + rng.randn(n, 3) * 0.3
    if kind == "uniform":
        return rng.uniform(0, 4, (n, 3))
    return np.column_stack([rng.uniform(0, 8, n), rng.uniform(0, 8, n),
                            rng.uniform(0, 0.05, n)])   # a floor


@pytest.mark.parametrize("min_points", [1, 3, 10])
@pytest.mark.parametrize("kind", ["blobs", "uniform", "floor"])
def test_dbscan_labels_match_sklearn(kind, min_points):
    rng = np.random.RandomState(min_points)
    x = _points(kind, rng, 1500).astype(np.float32)
    for eps in (0.1, 0.3, 0.95):
        ref = DBSCAN(eps=eps, min_samples=min_points).fit(x).labels_
        got = port_post.dbscan_labels(x, eps, min_points)
        np.testing.assert_array_equal(got, ref, err_msg=f"eps {eps}")
