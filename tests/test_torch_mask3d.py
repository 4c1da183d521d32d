"""The whole Mask3D eval forward of the PyTorch port against the JAX model,
in f32 and at bf16, and the port's inference entry point (device-post route
and DBSCAN route) and its own copy of the host post-processing against the
JAX package's.

Small sizes, as tests/test_scan_decoder.py: Res16UNet14A, hidden 32, 8
queries, 2 heads, voxel 0.12, 2 scenes of 1,500 points. Inputs come from a
numpy seed; weights from the JAX init (with random BatchNorm statistics, so
the folded epilogues do real work), carried across by models/weights.py.
f32 tolerance rtol 2e-4 / atol 2e-5 (test_scan_decoder.py). At bf16 the
port is held to JAX at `jnp.bfloat16` within BF16_FACTOR times JAX's own
bf16-vs-f32 spread on each output, measured in the test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_batch, make_scene
from unscene3d_tpu.eval.postprocess import eval_scene_predictions
from unscene3d_tpu.models.backbone import Res16UNet14A
from unscene3d_tpu.models.mask3d import Mask3D as JaxMask3D
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.eval import postprocess as port_post
from unscene3d_torch.inference import EVAL_DEFAULTS, Predictor, build_mask3d
from unscene3d_torch.models.sparse_modules import SparseConv
from unscene3d_torch.models.transformer_layers import Dense
from unscene3d_torch.models.weights import load_flax_variables

from tests._torch_jax import one_torch_thread, random_bn  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
# port bf16 vs JAX bf16, as a multiple of max|JAX bf16 - JAX f32| per output:
# both round the same f32 math to bf16 at other points (the port's kernels
# sum in f32 and round once; XLA's CPU fusions round elsewhere), so each sits
# about one bf16 spread from the other. Measured 0.7-1.4 (ROADMAP Queue 3).
BF16_FACTOR = 2.0
SMALL = dict(num_classes=3, hidden_dim=32, num_queries=8, num_heads=2,
             dim_feedforward=64, num_decoders=2)
VOXEL = 0.12


def jax_model(dtype=jnp.float32):
    return JaxMask3D(backbone=Res16UNet14A(out_channels=2, dtype=dtype),
                     scan_decoder=False, dtype=dtype, **SMALL)


@pytest.fixture(scope="module")
def scenes():
    return make_batch(2, num_points=1500)


@pytest.fixture(scope="module")
def jax_f32(scenes):
    batch, _ = JaxCollator(voxel_size=VOXEL, fps_queries=8)(scenes)
    model = jax_model()
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        b, train=False, is_eval=True))(batch)
    variables = random_bn(variables)
    apply = jax.jit(lambda v, b: model.apply(v, b, train=False, is_eval=True))
    out = apply(variables, batch)
    return variables, apply, jax.tree.map(np.asarray, {
        k: out[k] for k in ("pred_logits", "pred_masks_seg",
                            "pred_masks_vox", "backbone_features",
                            "mask_features", "sampled_coords")})


def torch_model(variables, dtype=torch.float32):
    model = build_mask3d(dtype, backbone="Res16UNet14A", seed=None, **SMALL)
    load_flax_variables(model, variables)
    return model


def test_mask3d_eval_forward_matches_jax(scenes, jax_f32):
    variables, _, ref = jax_f32
    model = torch_model(variables)
    batch, _ = FreeMaskCollator(voxel_size=VOXEL, fps_queries=8)(scenes)
    out = model(batch)
    for key in ("backbone_features", "mask_features", "sampled_coords",
                "pred_logits", "pred_masks_seg", "pred_masks_vox"):
        got = out[key].numpy()
        assert got.shape == ref[key].shape, key
        np.testing.assert_allclose(got, ref[key], rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_inference_instances_match_jax_postprocess(jax_f32):
    variables, apply, _ = jax_f32
    scene = make_scene(num_points=1500, seed=5)
    jbatch, jmeta = JaxCollator(voxel_size=VOXEL, fps_queries=8)([scene])
    jout = apply(variables, jbatch)
    n_vox = jmeta.num_voxels[0]
    ref = eval_scene_predictions(
        np.asarray(jout["pred_logits"][-1][0]),
        np.asarray(jout["pred_masks_vox"][-1][:n_vox]),
        inverse_map=jmeta.inverse_maps[0],
        point2segment_full=jmeta.original_segments[0],
        segment_connectivity=jmeta.segment_connectivity[0], **EVAL_DEFAULTS)
    got = Predictor(torch_model(variables), "cpu", voxel_size=VOXEL,
                    fine_buckets=False)(scene)
    assert got["masks"].shape == ref["masks"].shape
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-4,
                               atol=1e-6)
    # masks threshold logits at 0: report flips rather than hide them
    flips = int((got["masks"] != ref["masks"]).sum())
    assert flips == 0, f"{flips} mask bits differ"


def test_inference_dbscan_instances_match_jax_postprocess(jax_f32):
    """Predictor(use_dbscan=True) against the JAX package's host route with
    the DBSCAN split over the batch's raw voxel coords
    (experiment.py:853-862): eps 0.25 and min_points 3 split the queries
    into clusters with border and noise points."""
    variables, apply, _ = jax_f32
    scene = make_scene(num_points=1500, seed=5)
    jbatch, jmeta = JaxCollator(voxel_size=VOXEL, fps_queries=8)([scene])
    jout = apply(variables, jbatch)
    n_vox = jmeta.num_voxels[0]
    dbscan = dict(dbscan_eps=0.25, dbscan_min_points=3)
    ref = eval_scene_predictions(
        np.asarray(jout["pred_logits"][-1][0]),
        np.asarray(jout["pred_masks_vox"][-1][:n_vox]),
        inverse_map=jmeta.inverse_maps[0],
        point2segment_full=jmeta.original_segments[0],
        segment_connectivity=jmeta.segment_connectivity[0], use_dbscan=True,
        vox_coords=np.asarray(jbatch.raw_coords[:n_vox]), **dbscan,
        **EVAL_DEFAULTS)
    got = Predictor(torch_model(variables), "cpu", voxel_size=VOXEL,
                    fine_buckets=False, use_dbscan=True, **dbscan)(scene)
    assert got["masks"].shape == ref["masks"].shape
    assert ref["masks"].shape[1] > SMALL["num_queries"]
    np.testing.assert_array_equal(got["classes"], ref["classes"])
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-4,
                               atol=1e-6)
    flips = int((got["masks"] != ref["masks"]).sum())
    assert flips == 0, f"{flips} mask bits differ"


@pytest.mark.parametrize("options", [
    EVAL_DEFAULTS,
    dict(EVAL_DEFAULTS, filter_instances=True, iou_threshold=0.6,
         scores_threshold=0.1),
    dict(EVAL_DEFAULTS, filter_instances=True, iou_threshold=0.6,
         separate_instances=True),
    dict(EVAL_DEFAULTS, eval_on_segments=False, topk_per_image=7),
], ids=["defaults", "filter", "separate", "points-topk"])
def test_postprocess_copy_equals_the_original(options):
    """unscene3d_torch/eval/postprocess.py against
    unscene3d_tpu/eval/postprocess.py on the same numpy-seeded inputs:
    masks, classes and scores equal exactly."""
    rng = np.random.RandomState(0)
    n_pts, n_vox, n_seg, q = 3000, 900, 40, 12
    logits = rng.randn(q, 3).astype(np.float32)
    vox_masks = (rng.randn(n_vox, q) * 2).astype(np.float32)
    inverse_map = rng.randint(0, n_vox, n_pts)
    inverse_map[:n_vox] = np.arange(n_vox)
    p2s = np.sort(rng.randint(0, n_seg, n_pts))
    p2s[:n_seg] = np.arange(n_seg)
    conn = rng.randint(0, n_seg, (60, 2))
    kw = dict(inverse_map=inverse_map, point2segment_full=p2s,
              segment_connectivity=conn, **options)
    ref = eval_scene_predictions(logits, vox_masks, **kw)
    got = port_post.eval_scene_predictions(logits, vox_masks, **kw)
    assert set(got) == set(ref) == {"masks", "classes", "scores"}
    assert ref["masks"].shape[1] > 0
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_bf16_forward_mirrors_jax_dtypes(scenes, jax_f32):
    """Under bf16 the backbone and transformer layers run in bf16, Mask3D's
    own Dense heads in f32 (flax promotion); outputs are finite."""
    variables, _, ref32 = jax_f32
    model = torch_model(variables, torch.bfloat16)
    batch, _ = FreeMaskCollator(voxel_size=VOXEL, fps_queries=8)(scenes)
    out = model(batch)
    assert out["backbone_features"].dtype == torch.bfloat16
    for key in ("mask_features", "pred_logits", "pred_masks_seg",
                "pred_masks_vox"):
        assert out[key].dtype == torch.float32, key
        assert torch.isfinite(out[key]).all(), key
    # the bf16 backbone stays near the f32 reference (bf16 has 8 bits)
    got = out["backbone_features"].float().numpy()
    ref = ref32["backbone_features"]
    assert np.abs(got - ref).max() <= 0.05 * np.abs(ref).max()


def test_bf16_forward_matches_jax_bf16(scenes, jax_f32):
    """The port's bf16 eval forward against the JAX module at jnp.bfloat16,
    same weights and batch: per output, max|port - JAX bf16| within
    BF16_FACTOR x max|JAX bf16 - JAX f32|."""
    variables, _, ref32 = jax_f32
    jbatch, _ = JaxCollator(voxel_size=VOXEL, fps_queries=8)(scenes)
    model16 = jax_model(jnp.bfloat16)
    ref16 = jax.jit(lambda v, b: model16.apply(v, b, train=False,
                                               is_eval=True))(variables, jbatch)
    batch, _ = FreeMaskCollator(voxel_size=VOXEL, fps_queries=8)(scenes)
    out = torch_model(variables, torch.bfloat16)(batch)
    for key in ("backbone_features", "mask_features", "pred_logits",
                "pred_masks_seg", "pred_masks_vox"):
        r16 = np.asarray(ref16[key], np.float32)
        got = out[key].float().numpy()
        assert got.shape == r16.shape, key
        spread = np.abs(r16 - ref32[key]).max()
        err = np.abs(got - r16).max()
        assert 0 < spread and np.isfinite(err), key
        assert err <= BF16_FACTOR * spread, (key, err, spread)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weights_stored_in_compute_dtype(jax_f32, dtype):
    """Sparse-conv kernels and Dense params are stored in their module's
    compute dtype, rounded once at load to what flax rounds its f32 params
    to at every call; Mask3D's own heads, the f32 `final` conv, conv biases,
    BatchNorm and LayerNorm params stay f32."""
    variables, _, _ = jax_f32
    model, ref = torch_model(variables, dtype), torch_model(variables)
    ref_params = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        mod_name, leaf = name.rsplit(".", 1)
        mod = model.get_submodule(mod_name)
        want = torch.float32
        if isinstance(mod, Dense) or (isinstance(mod, SparseConv)
                                      and leaf == "kernel"):
            want = mod.dtype or torch.float32
        assert p.dtype == want, name
        assert torch.equal(p, ref_params[name].to(p.dtype)), name
    low = [n for n, p in model.named_parameters() if p.dtype == dtype]
    assert any(n.startswith("backbone.") for n in low)
    assert any(n.startswith("cross_attention.") for n in low)
