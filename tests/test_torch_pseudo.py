"""The pseudo-mask half of the PyTorch port against the JAX package on the
CPU, in stages, because NCut is a chain of thresholds (`a > tau`, `vec >
mean`, `frac > 0.8`, the IoU gate): a last-bit difference in an affinity
entry that sits at tau flips an edge. Inputs come from a numpy seed; the JAX
side runs as the JAX package's own tests run it.

Tolerances:
  * affinity before the threshold: 1e-6 absolute (values in [0, 1]; the two
    f32 matmuls and reductions differ in the last bit);
  * binarized affinity: equal, on inputs checked to hold no entry within
    1e-4 of tau;
  * eigenvectors: |cos| >= 1 - 1e-4 per scene for `eigh` and `cholinv`,
    unimodal and multimodal (the canonical sign makes the sign equal too);
  * masks of `BatchedNCut`: exactly equal, whole trajectories, on the
    unique-Fiedler fixtures (the two-cluster scenes of
    tests/test_ncut_reference_oracle.py), device loop and host loop, all
    four separation modes, both solvers, unimodal and multimodal. On a graph
    with three or more weakly coupled components the second eigenvalue is
    near-degenerate and the chosen vector depends on the LAPACK build and
    on the last bit ("full-trajectory equality is NOT well-posed in
    general", tests/test_ncut_reference_oracle.py:199): on the
    multi-cluster scenes of tests/test_ncut.py and of the oracle file the
    port is held to what the JAX package's own tests hold there (cluster
    purity, no overlap, planted-object recovery, device loop == host loop);
  * 8 bench-like scenes (400 segments x 96 features, `make_segment_scene`:
    connected tau-graphs with planted objects): masks exactly equal over
    the first three greedy iterations, both solvers; over all 20 iterations
    mean matched IoU >= 0.75 and equal planted-object recovery within 0.10
    (measured 0.84 / 0.91 IoU for cholinv / eigh and equal recovery; the
    JAX package's own cholinv-vs-eigh IoU on these scenes is 0.59: late
    iterations cut a painted-out, near-degenerate remainder). bench.py's own
    pseudo row draws normal random features, whose tau-graph is the
    identity (400 edges, the diagonal): every vector is an eigenvector, so
    its masks carry no signal to compare and it serves as a timing row;
  * `aggregate_features`, `project_2d_features`: rtol 1e-6 / atol 1e-6 (f32
    sums in another order); `freemask_query_masks`, `matrix_nms`: masks
    equal, scores 1e-6;
  * the multires backbone and `CSCFeatureExtractor`: rtol 2e-4 / atol 2e-5
    (as tests/test_torch_mask3d.py: ~50 f32 convs in another summation
    order); the whole `PseudoMaskPipeline.process_scenes`: masks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_ncut as jt_ncut
import tests.test_ncut_reference_oracle as jt_oracle
import tests.test_pseudo_pipeline as jt_pipeline
from tests._torch_jax import np_tree, random_bn
from benchmarks.ncut_solver_agreement import object_recovery
from unscene3d_tpu.data.synthetic import \
    make_segment_scene as jax_make_segment_scene
from unscene3d_tpu.eval.nms import matrix_nms as jax_matrix_nms
from unscene3d_tpu.models.backbone import Res16UNet14A as JaxRes16UNet14A
from unscene3d_tpu.ops.kernel_maps import build_sparse_graph as jax_graph
from unscene3d_tpu.pseudo import features as jfeatures
from unscene3d_tpu.pseudo import freemask_query as jquery
from unscene3d_tpu.pseudo import ncut as jncut
from unscene3d_tpu.pseudo import pipeline as jpipeline
from unscene3d_tpu.pseudo import projection as jprojection
from unscene3d_torch.bench.pseudo import (bench_pseudo, make_pseudo_scenes,
                                          matched_iou)
from unscene3d_torch.bench.pseudo import \
    object_recovery as port_object_recovery
from unscene3d_torch.data.synthetic import make_segment_scene
from unscene3d_torch.eval.nms import matrix_nms
from unscene3d_torch.models.encoders_2d import load_2d_model
from unscene3d_torch.models.backbone import Res16UNet14A
from unscene3d_torch.models.weights import load_flax_backbone_variables
from unscene3d_torch.ops.kernel_maps import build_sparse_graph
from unscene3d_torch.ops.sparse_graph import graph_from_levels
from unscene3d_torch.pseudo import ncut
from unscene3d_torch.pseudo.csc import CSCFeatureExtractor
from unscene3d_torch.pseudo.features import aggregate_features
from unscene3d_torch.pseudo.freemask_query import (cosine_sim,
                                                   freemask_query_masks)
from unscene3d_torch.pseudo.pipeline import PseudoMaskPipeline
from unscene3d_torch.ops.segment_pool import (device_segment_order,
                                              segment_order, segment_pieces)
from unscene3d_torch.pseudo.projection import (
    project_2d_features, render_voxels_to_image,
    render_voxels_to_image_interpolate)

TAU = 0.7
CFG = dict(affinity_tau=TAU, min_segment_size=2, max_number_of_instances=6)
MODES = ("max", "avg", "largest", "all")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_pool():
    """The suite runs several workers at once. On top of them, the thread
    pools of torch and of the OpenBLAS behind JAX's CPU LAPACK only spin:
    one batched eigh of this file took 17 minutes in a whole run and 8 s
    alone. One thread each while this module runs."""
    import threadpoolctl

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _as_scene(feats, uniq, conn, seg_ids, coords):
    return dict(features=feats, unique_segments=uniq, connectivity=conn,
                segment_ids=seg_ids, coords=coords)


@pytest.fixture(scope="module")
def scenes():
    """Eight constructed scenes in one batch: three of tests/test_ncut.py
    (three clusters), four of tests/test_ncut_reference_oracle.py (two
    multi-cluster, two two-cluster), and a two-segment scene."""
    out = [_as_scene(*jt_ncut.clustered_scene(seed=s)) for s in (0, 3, 5)]
    out += [_as_scene(*jt_oracle._scene(seed=s)) for s in (0, 1)]
    out += [_as_scene(*jt_oracle._two_cluster_scene(seed=s)) for s in (0, 1)]
    r = np.random.RandomState(0)
    out.append(_as_scene(r.rand(2, 12).astype(np.float32), np.arange(2),
                         np.zeros((0, 2), int), np.repeat(np.arange(2), 3),
                         r.rand(6, 3).astype(np.float32)))
    # one feature width per batch: pad the 8-wide clustered scenes to 12
    for s in out:
        f = s["features"]
        s["features"] = np.pad(f, ((0, 0), (0, 12 - f.shape[1])))
    return out


def _padded(scenes, second=False):
    """(fa, fb, painting, invalid) as BatchedNCut pads them, S = 64; fb is a
    perturbed copy (the second modality) when asked for."""
    B, S = len(scenes), 64
    fa = np.zeros((B, S, 12), np.float32)
    invalid = np.ones((B, S), bool)
    for b, s in enumerate(scenes):
        n = len(s["unique_segments"])
        fa[b, :n] = s["features"]
        invalid[b, :n] = False
    rng = np.random.RandomState(1)
    fb = (fa + rng.normal(0, 0.02, fa.shape).astype(np.float32)
          * ~invalid[..., None]) if second else fa
    painting = np.zeros((B, S), np.float32)
    painting[:, 1] = 1.0          # one painted segment per scene
    return fa, fb, painting, invalid


@pytest.mark.parametrize("multimodal", [False, True])
def test_affinity_stages_match_jax(scenes, multimodal):
    fa, fb, painting, invalid = _padded(scenes, second=multimodal)

    def jax_affinity(fa, fb, paint, inv):
        if multimodal:
            return (jncut._affinity_from_feats(fa, paint, ~inv, False)
                    + jncut._affinity_from_feats(fb, paint, ~inv, False)) / 2
        return jncut._affinity_from_feats(fa, paint, ~inv, True)

    ref = np.asarray(jax.vmap(jax_affinity)(*map(jnp.asarray, (
        fa, fb, painting, invalid))))
    t = torch.from_numpy
    got = ncut.affinity_matrix(t(fa), t(fb), t(painting), t(invalid),
                               multimodal)
    valid2 = ~invalid[:, :, None] & ~invalid[:, None, :]
    assert np.abs(got.numpy() - ref)[valid2].max() <= 1e-6
    # no entry sits at the threshold: the binarized graphs must be equal
    assert np.abs(ref - TAU)[valid2].min() > 1e-4
    for sym in (False, True):
        ref_bin = np.where(ref > TAU, 1.0, 1e-5)
        dead = (painting > 0) | invalid
        ref_bin = np.where(dead[:, :, None] | dead[:, None, :], 1e-5, ref_bin)
        if sym:
            ref_bin = (ref_bin + ref_bin.transpose(0, 2, 1)) * 0.5
        got_bin = ncut.binarized_affinity(got, t(painting), t(invalid), TAU,
                                          1e-5, sym)
        np.testing.assert_array_equal(got_bin.numpy(),
                                      ref_bin.astype(np.float32))


@pytest.fixture(scope="module")
def gapped_scenes():
    """Scenes whose second eigenvector is unique: exactly two feature
    clusters, weakly coupled by the eps fill (on a graph of three or more
    components the Fiedler direction is degenerate and two LAPACK builds
    may return different vectors of the same subspace)."""
    return [_as_scene(*jt_oracle._two_cluster_scene(seed=s))
            for s in range(8)]


@pytest.mark.parametrize("solver", ["eigh", "cholinv"])
@pytest.mark.parametrize("multimodal", [False, True])
def test_eigenvectors_match_jax(gapped_scenes, multimodal, solver):
    fa, fb, painting, invalid = _padded(gapped_scenes, second=multimodal)
    kw = dict(tau=TAU, eps=1e-5, multimodal=multimodal, solver=solver,
              iters=16, block=16)
    ref = np.asarray(jncut.ncut_eigenvectors(*map(jnp.asarray, (
        fa, fb, painting, invalid)), **kw))
    got = ncut.ncut_eigenvectors(*map(torch.from_numpy, (
        fa, fb, painting, invalid)), **kw).numpy()
    assert np.isfinite(got).all()
    for b, s in enumerate(gapped_scenes):
        n = len(s["unique_segments"])
        g, r = got[b, :n], ref[b, :n]
        cos = g @ r / (np.linalg.norm(g) * np.linalg.norm(r))
        assert cos >= 1 - 1e-4, (b, cos)      # the canonical sign included


def test_solver_defaults_and_the_retired_solver():
    cfg = ncut.NCutConfig()
    assert (cfg.solver, cfg.solver_iters, cfg.solver_block) == (
        "cholinv", 16, 16)
    import inspect
    sig = inspect.signature(ncut.ncut_eigenvectors).parameters
    assert (sig["solver"].default, sig["iters"].default,
            sig["block"].default) == ("cholinv", 16, 16)
    z = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="never converges"):
        ncut.ncut_eigenvectors(z, z, torch.zeros(1, 4),
                               torch.zeros(1, 4, dtype=torch.bool),
                               solver="subspace")
    with pytest.raises(ValueError, match="never converges"):
        ncut.BatchedNCut(ncut.NCutConfig(solver="subspace"), "cpu")
    with pytest.raises(ValueError):
        ncut.BatchedNCut(ncut.NCutConfig(solver="lanczos"), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ncut.BatchedNCut()          # the default device is the card


def test_a_dead_scene_does_not_abort_the_batch(gapped_scenes):
    """An operator that does not factor (NaN) gives NaN for its scene alone
    (JAX returns NaN from its Cholesky; torch.linalg.cholesky would raise
    for the whole batch)."""
    fa, fb, painting, invalid = map(torch.from_numpy,
                                    _padded(gapped_scenes[:4]))
    a = ncut.binarized_affinity(
        ncut.affinity_matrix(fa, fb, painting, invalid, False), painting,
        invalid, TAU, 1e-5, True)
    sym, d = ncut.normalized_laplacian(a)
    want = ncut._second_vec_cholinv(sym, torch.sqrt(d), 16, 16)
    sym[1] = float("nan")
    vec = ncut._second_vec_cholinv(sym, torch.sqrt(d), 16, 16)
    assert torch.isnan(vec[1]).all()
    assert torch.isfinite(vec[[0, 2, 3]]).all()
    assert torch.equal(vec[[0, 2, 3]], want[[0, 2, 3]])


@pytest.mark.parametrize("device_loop", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_masks_equal_jax_on_unique_fiedler_scenes(gapped_scenes, mode,
                                                  device_loop):
    """Whole trajectories, with a two-segment scene in the batch."""
    r = np.random.RandomState(0)
    tiny = _as_scene(r.rand(2, 12).astype(np.float32), np.arange(2),
                     np.zeros((0, 2), int), np.repeat(np.arange(2), 3),
                     r.rand(6, 3).astype(np.float32))
    batch = gapped_scenes[:7] + [tiny]
    kw = dict(CFG, separation_mode=mode, device_loop=device_loop)
    want = jncut.BatchedNCut(jncut.NCutConfig(**kw)).run(
        [dict(s) for s in batch])
    got = ncut.BatchedNCut(ncut.NCutConfig(**kw), "cpu").run(
        [dict(s) for s in batch])
    assert len(got) == len(want) == len(batch)
    for b, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == bool and g.shape == w.shape, (mode, b)
        np.testing.assert_array_equal(g, w, err_msg=f"{mode} scene {b}")
    assert got[-1].shape == (1, 2) and got[-1].all()     # the tiny scene
    assert sum(len(g) for g in got) >= 8


@pytest.mark.parametrize("solver,multimodal", [("eigh", False),
                                               ("eigh", True),
                                               ("cholinv", True)])
def test_masks_equal_jax_eigh_and_multimodal(gapped_scenes, solver,
                                             multimodal):
    batch = [dict(s) for s in gapped_scenes]
    if multimodal:
        rng = np.random.RandomState(1)
        for s in batch:
            f = s["features"]
            s["features"] = (f, f + rng.normal(0, 0.02, f.shape).astype(
                np.float32))
    cfg = dict(CFG, solver=solver)
    want = jncut.BatchedNCut(jncut.NCutConfig(**cfg)).run(
        [dict(s) for s in batch])
    got = ncut.BatchedNCut(ncut.NCutConfig(**cfg), "cpu").run(batch)
    for b, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"scene {b}")


@pytest.mark.parametrize("solver", ["cholinv", "eigh"])
def test_multi_cluster_scenes_hold_the_reference_properties(scenes, solver):
    """What tests/test_ncut.py and tests/test_ncut_reference_oracle.py hold
    of the JAX package where trajectories are not well-posed: every mask of
    a clustered scene is one cluster, masks do not overlap, at least two of
    three clusters and three of four planted objects are found."""
    cfg = ncut.NCutConfig(affinity_tau=0.8, min_segment_size=2,
                          max_number_of_instances=6, solver=solver)
    got = ncut.BatchedNCut(cfg, "cpu").run([dict(s) for s in scenes])
    for masks in got[:3]:                    # clustered_scene: 3 x 6
        assert masks.shape[1] == 18 and masks.shape[0] >= 2
        for m in masks:
            assert len(set(np.nonzero(m)[0] // 6)) == 1
        assert (masks.sum(0) <= 1).all()
    cfg = ncut.NCutConfig(affinity_tau=0.65, solver=solver)
    got = ncut.BatchedNCut(cfg, "cpu").run([dict(s) for s in scenes[3:5]])
    for masks in got:                        # _scene: 4 objects of 5
        assert len(jt_oracle._planted_object_masks(masks)) >= 3


@pytest.mark.parametrize("mode", ["max", "avg", "largest"])
def test_device_loop_matches_host_loop(mode):
    """tests/test_ncut.py::test_device_loop_matches_host_loop on the port:
    four random scenes of 40-61 segments, exact solver."""
    r = np.random.RandomState(0)
    batch = []
    for i in range(4):
        s = 40 + 7 * i
        uniq = np.arange(s)
        conn = np.column_stack([np.arange(s - 1), np.arange(1, s)])
        batch.append(_as_scene(
            r.randn(s, 16).astype(np.float32), uniq,
            np.vstack([conn, conn[:, ::-1]]), np.repeat(uniq, 3),
            r.rand(3 * s, 3).astype(np.float32) * 5))
    cfg = ncut.NCutConfig(separation_mode=mode, solver="eigh")
    got = ncut.BatchedNCut(cfg, "cpu").run([dict(s) for s in batch])
    cfg.device_loop = False
    want = ncut.BatchedNCut(cfg, "cpu").run([dict(s) for s in batch])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=mode)


def test_generate_scene_masks_and_batch_independence(gapped_scenes):
    """One scene alone equals the scene inside the batch (CPU, both
    solvers), as tests/test_ncut.py holds of the JAX package."""
    for solver in ("eigh", "cholinv"):
        cfg = ncut.NCutConfig(**CFG, solver=solver)
        batched = ncut.BatchedNCut(cfg, "cpu").run(
            [dict(s) for s in gapped_scenes])
        s = gapped_scenes[3]
        single = ncut.generate_scene_masks(
            s["features"], s["unique_segments"], s["connectivity"],
            s["segment_ids"], s["coords"], cfg, device="cpu")
        np.testing.assert_array_equal(single, batched[3])


@pytest.fixture(scope="module")
def segment_scenes():
    batch = [make_segment_scene(seed=i, num_segments=400) for i in range(8)]
    ref = jax_make_segment_scene(seed=3, num_segments=400, multimodal=True)
    got = make_segment_scene(seed=3, num_segments=400, multimodal=True)
    for k in ("unique_segments", "connectivity", "segment_ids", "coords"):
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(got["features"][1], ref["features"][1])
    assert got["objects"] == ref["objects"]
    return batch


@pytest.mark.parametrize("solver", ["cholinv", "eigh"])
def test_bench_like_scenes_against_jax(segment_scenes, solver):
    kw = dict(affinity_tau=0.6, solver=solver)
    first = dict(kw, max_number_of_instances=3)
    want = jncut.BatchedNCut(jncut.NCutConfig(**first)).run(
        [dict(s) for s in segment_scenes])
    got = ncut.BatchedNCut(ncut.NCutConfig(**first), "cpu").run(
        [dict(s) for s in segment_scenes])
    for b, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"scene {b}")
    assert sum(len(g) for g in got) >= 16
    want = jncut.BatchedNCut(jncut.NCutConfig(**kw)).run(
        [dict(s) for s in segment_scenes])
    res = bench_pseudo("cpu", cfg=ncut.NCutConfig(**kw), runs=0,
                       scenes=[dict(s) for s in segment_scenes],
                       log=lambda m: None)
    got = res["masks"]
    assert all(len(g) >= 1 for g in got)
    ious = [matched_iou(g, w) for g, w in zip(got, want)]
    assert np.mean(ious) >= 0.75, ious
    rec = [np.mean([object_recovery(m[i], s["objects"])
                    for i, s in enumerate(segment_scenes)])
           for m in (got, want)]
    assert abs(rec[0] - rec[1]) <= 0.10 and rec[0] >= 0.15, rec
    assert all(port_object_recovery(m, s["objects"])
               == object_recovery(m, s["objects"])
               for m, s in zip(got, segment_scenes))


def test_bench_row_graph_is_the_identity():
    """bench.py's pseudo row: normal random features leave no edge above tau
    but the diagonal, so the row times the solver and carries no masks to
    compare."""
    batch = make_pseudo_scenes(2, 400, seed=0)
    fa = torch.from_numpy(np.stack([s["features"] for s in batch]))
    zeros = torch.zeros(2, 400)
    a = ncut.affinity_matrix(fa, fa, zeros, zeros.bool(), False)
    assert torch.equal(a > 0.65, torch.eye(400, dtype=torch.bool).expand(
        2, 400, 400))
    res = bench_pseudo("cpu", runs=1, scenes=batch, log=lambda m: None)
    assert len(res["runs_ms"]) == 1 and all(len(m) >= 1 for m in res["masks"])
    assert matched_iou([], []) == 1.0
    assert matched_iou([np.ones(4, bool)], []) == 0.0


def test_label_propagation_first_max_breaks_ties_low():
    sizes = torch.tensor([[2, 5, 5, 1], [0, 0, 0, 0], [1, 2, 3, 3]])
    np.testing.assert_array_equal(ncut._first_max(sizes, 4).numpy(),
                                  [1, 0, 2])


# ------------------------------------------------------------- features etc.
@pytest.mark.parametrize("mode", ["mean", "max"])
def test_aggregate_features_matches_jax(mode):
    rng = np.random.RandomState(0)
    p, d = 600, 7
    feats = rng.randn(p, d).astype(np.float32)
    seg_ids = rng.randint(0, 25, p) * 3 + 10
    feats[seg_ids == 13] = 0.0            # a zero segment with neighbours
    feats[seg_ids == 40] = 0.0            # a zero segment without any
    feats[rng.rand(p) < 0.1] = 0.0        # zero voxels are skipped
    conn = np.array([[13, 16], [16, 13], [13, 19], [19, 13], [13, 40],
                     [40, 13], [13, 999], [999, 13]])
    want, wu = jfeatures.aggregate_features(feats, seg_ids, conn, mode)
    got, gu = aggregate_features(feats, seg_ids, conn, mode)
    np.testing.assert_array_equal(gu, wu)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got[list(gu).index(13)]).max() > 0      # infilled
    # tests/test_ncut.py's infill case
    f = np.zeros((9, 4), np.float32)
    f[0:3], f[3:6] = 1.0, 2.0
    seg, uniq = aggregate_features(
        f, np.repeat([10, 20, 30], 3),
        np.array([[30, 20], [20, 30], [10, 20], [20, 10]]), mode)
    np.testing.assert_allclose(seg, [[1.0] * 4, [2.0] * 4, [2.0] * 4])


def test_freemask_query_and_nms_match_jax():
    r = np.random.RandomState(0)
    s = 16
    feats = np.zeros((s, 6), np.float32)
    feats[:8, 0] = 10 + r.rand(8)
    feats[8:, 1] = 10 + r.rand(8)
    uniq = np.arange(s)
    conn = np.array([[i, i + 1] for i in range(7)]
                    + [[i + 1, i] for i in range(7)]
                    + [[i, i + 1] for i in range(8, 15)]
                    + [[i + 1, i] for i in range(8, 15)])
    coords = np.zeros((s, 3), np.float32)
    coords[:, 0] = np.arange(s) * 0.1
    kw = dict(scene_extent=np.array([10.0, 10.0, 2.0]),
              nms_maskness_threshold=0.1, min_segments=2)
    wm, ws = jquery.freemask_query_masks(feats, uniq, conn, coords, **kw)
    gm, gs = freemask_query_masks(feats, uniq, conn, coords, **kw)
    assert len(gm) >= 2
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_allclose(gs, ws, atol=1e-6)
    np.testing.assert_allclose(cosine_sim(feats, feats),
                               jquery.cosine_sim(feats, feats), atol=1e-6)
    masks = r.rand(9, 40) > 0.6
    scores = r.rand(9).astype(np.float32)
    for kernel in ("gauss", "linear"):
        np.testing.assert_allclose(
            matrix_nms(masks, scores, kernel), jax_matrix_nms(
                masks, scores, kernel), atol=1e-6)
    # the FPS queries: none drawn at fps_num_samples >= S (the JAX function
    # does not sample there), FPS on the first three feature channels below
    for n_fps in (s, s // 2):
        wm, ws = jquery.freemask_query_masks(
            feats, uniq, conn, coords, use_fps_sampling=True,
            fps_num_samples=n_fps, **kw)
        gm, gs = freemask_query_masks(feats, uniq, conn, coords,
                                      use_fps_sampling=True,
                                      fps_num_samples=n_fps, **kw)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_allclose(gs, ws, atol=1e-6)


@pytest.mark.parametrize("reference_average", [False, True])
def test_project_2d_features_matches_jax(reference_average):
    H = W = 32
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    rng = np.random.RandomState(0)
    xs, ys = np.meshgrid(np.linspace(-0.5, 0.5, 40), np.linspace(-0.5, 0.5, 40))
    near = np.column_stack([xs.ravel(), ys.ravel(), np.full(xs.size, 2.0)])
    far = np.column_stack([rng.uniform(-0.6, 0.6, (200, 2)),
                           rng.uniform(2.5, 5.0, 200)])
    behind = np.array([[0, 0, -2.0], [50.0, 0, 3.0]])
    pts = np.vstack([near, far, behind]).astype(np.float32)
    valid = rng.rand(len(pts)) > 0.05
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[1, 0, 3], poses[2, 1, 3] = 0.2, -0.15      # shifted cameras
    Ks = np.stack([K, K * np.array([[1.1], [1.1], [1.0]], np.float32), K])
    feats = rng.randn(3, H, W, 5).astype(np.float32)
    for intr in (K, Ks):
        want, wc = jprojection.project_2d_features(
            jnp.asarray(feats), jnp.asarray(pts), jnp.asarray(valid),
            jnp.asarray(poses), jnp.asarray(intr), H, W,
            depth_tolerance=0.1, reference_average=reference_average)
        t = torch.from_numpy
        got, gc = project_2d_features(
            t(feats), t(pts), t(valid), t(poses), t(intr), H, W,
            depth_tolerance=0.1, reference_average=reference_average)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        assert gc.dtype == torch.int32 and 0 < (gc.numpy() > 0).sum() < len(pts)
        assert (gc.numpy()[-2:] == 0).all() and not gc.numpy()[~valid].any()


def _render_scene():
    """test_project_2d_features_matches_jax's points: a near wall, far
    points, one behind the camera and one outside the frame."""
    rng = np.random.RandomState(2)
    xs, ys = np.meshgrid(np.linspace(-0.5, 0.5, 40),
                         np.linspace(-0.5, 0.5, 40))
    near = np.column_stack([xs.ravel(), ys.ravel(), np.full(xs.size, 2.0)])
    far = np.column_stack([rng.uniform(-0.6, 0.6, (200, 2)),
                           rng.uniform(2.5, 5.0, 200)])
    pts = np.vstack([near, far, [[0, 0, -2.0], [50.0, 0, 3.0]]])
    valid = rng.rand(len(pts)) > 0.05
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = 0.1
    return (pts.astype(np.float32), valid, pose,
            rng.randn(len(pts), 4).astype(np.float32))


def test_render_voxels_to_image_matches_jax():
    """The nearest-voxel render and its gradient to the features against
    the JAX function and jax.grad: image rtol 1e-6 / atol 1e-6, hit mask
    equal; the device order equals the host's segment_order."""
    H = W = 32
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    pts, valid, pose, vf = _render_scene()
    r = np.random.RandomState(3).randn(H, W, 4).astype(np.float32)

    def jfn(f):
        return jprojection.render_voxels_to_image(
            f, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(pose),
            jnp.asarray(K), H, W)

    want, want_hit = jfn(jnp.asarray(vf))
    want_g = jax.grad(lambda f: (jfn(f)[0] * r).sum())(jnp.asarray(vf))
    t = torch.from_numpy
    f = t(vf).requires_grad_()
    got, hit = render_voxels_to_image(f, t(pts), t(valid), t(pose), t(K),
                                      H, W)
    (got * t(r)).sum().backward()
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want_hit))
    assert 0 < hit.numpy().mean() < 1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-6)
    ids = torch.randint(-2, 12, (500,), generator=torch.Generator()
                        .manual_seed(0))
    ok = torch.rand(500, generator=torch.Generator().manual_seed(1)) > 0.2
    order, offsets, pieces = device_segment_order(ids, 10, ok)
    h_order, h_offsets = segment_order(ids.numpy(), 10, ok.numpy())
    np.testing.assert_array_equal(order.numpy(), h_order)
    np.testing.assert_array_equal(offsets.numpy(), h_offsets)
    np.testing.assert_array_equal(pieces.numpy(), segment_pieces(h_offsets))


def test_render_interpolate_matches_jax_with_its_gradient():
    """tests/test_projection.py's slab scene: the image, the weight image
    and the per-voxel weight sums rtol 1e-6 / atol 1e-6 against the JAX
    function; the gradient of sum(image * r) to the features against
    jax.grad at the same tolerance."""
    D = 12
    coords = np.asarray([[x, y, 5] for x in range(2, 10) for y in range(2, 10)]
                        + [[x, y, 6] for x in range(2, 10)
                           for y in range(2, 10) if (x + y) % 3 == 0],
                        np.int32)
    n = len(coords)
    rng = np.random.RandomState(0)
    feats = rng.rand(n, 4).astype(np.float32)
    H = W = 16
    K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [6.0, 6.0, 0.0]
    r = rng.randn(H, W, 4).astype(np.float32)

    def jfn(f):
        return jprojection.render_voxels_to_image_interpolate(
            f, jnp.asarray(coords), jnp.ones(n, bool), jnp.asarray(pose),
            jnp.asarray(K), H, W, (D, D, D), voxel_size=1.0)

    want = jfn(jnp.asarray(feats))
    want_g = jax.grad(lambda f: (jfn(f)[0] * r).sum())(jnp.asarray(feats))
    t = torch.from_numpy
    f = t(feats).requires_grad_()
    got = render_voxels_to_image_interpolate(
        f, t(coords), torch.ones(n, dtype=torch.bool), t(pose), t(K), H, W,
        (D, D, D), voxel_size=1.0)
    (got[0] * t(r)).sum().backward()
    for g, w, name in zip(got, want, ("image", "weights", "mapping")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert (np.asarray(want[1]) > 0).sum() > 10 and f.grad.abs().sum() > 0
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------ backbone and pipeline
@pytest.fixture(scope="module")
def small_graph():
    rng = np.random.RandomState(0)
    xyz = np.unique(rng.randint(0, 24, (900, 3)), axis=0)
    coords = np.column_stack([np.zeros(len(xyz), np.int32), xyz])
    jgraph = jax_graph(coords, num_levels=5)
    levels = build_sparse_graph(coords, num_levels=5)
    feats = np.zeros((len(levels[0]["valid"]), 3), np.float32)
    feats[:len(xyz)] = rng.randn(len(xyz), 3)
    return jgraph, graph_from_levels(levels), feats


def test_multires_backbone_matches_jax(small_graph):
    jgraph, graph, feats = small_graph
    jmodel = JaxRes16UNet14A(out_channels=5)
    variables = random_bn(jmodel.init(jax.random.PRNGKey(0),
                                      jnp.asarray(feats), jgraph,
                                      train=False, multires=True))
    jfinal, jres = jax.jit(lambda v, f, g: jmodel.apply(
        v, f, g, train=False, multires=True))(variables, jnp.asarray(feats),
                                              jgraph)
    model = Res16UNet14A(out_channels=5).eval()
    load_flax_backbone_variables(model, variables)
    with torch.no_grad():
        final, res = model(torch.from_numpy(feats), graph, multires=True)
        res_1, fpn, final2 = model(torch.from_numpy(feats), graph)
    assert list(res) == ["res_16", "res_8", "res_4", "res_2", "res_1"]
    assert set(res) == set(jres)
    for name, ref in jres.items():
        np.testing.assert_allclose(res[name].numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=2e-4,
                               atol=2e-5)
    assert torch.equal(final, final2) and torch.equal(res["res_1"], res_1)
    assert all(torch.equal(a, b) for a, b in zip(res.values(), fpn))


def test_backbone_bridge_raises_on_missing_and_unused(small_graph):
    jgraph, _, feats = small_graph
    jmodel = JaxRes16UNet14A(out_channels=5)
    variables = np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                                    jgraph, train=False, multires=True))
    model = Res16UNet14A(out_channels=5)
    extra = {k: dict(v) for k, v in variables.items()}
    extra["params"]["stray"] = {"kernel": np.zeros((3, 3), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        load_flax_backbone_variables(model, extra)
    lacking = {k: dict(v) for k, v in variables.items()}
    del lacking["params"]["final"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_backbone_variables(model, lacking)


@pytest.fixture(scope="module")
def pipeline_pair():
    """The JAX pipeline (random CSC init, as tests/test_pseudo_pipeline.py)
    and the port with the bridged weights, two synthetic scenes."""
    scenes = [jt_pipeline.synthetic_pseudo_scene(seed=i) for i in range(2)]
    cfg = dict(affinity_tau=0.5, min_segment_size=2,
               max_number_of_instances=5)
    jpipe = jpipeline.PseudoMaskPipeline(
        modality="geom", voxel_size=0.08, ncut_cfg=jncut.NCutConfig(**cfg))
    jres = jpipe.process_scenes(scenes)
    pipe = PseudoMaskPipeline(
        modality="geom", voxel_size=0.08, ncut_cfg=ncut.NCutConfig(**cfg),
        csc_variables=np_tree(jpipe.csc.variables), device="cpu")
    return scenes, jpipe, jres, pipe


def test_csc_feature_extractor_matches_jax(pipeline_pair):
    scenes, jpipe, _, pipe = pipeline_pair
    s = scenes[0]
    want = jpipe.csc(s["coords"], s["feats"])
    got = pipe.csc(s["coords"], s["feats"])
    assert got.shape == want.shape == (len(s["coords"]), 96)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert isinstance(pipe.csc, CSCFeatureExtractor)
    assert pipe.csc.level == jpipe.csc.level == 1


def test_pipeline_masks_equal_jax_and_saves(pipeline_pair, tmp_path):
    scenes, _, jres, pipe = pipeline_pair
    res = pipe.process_scenes(scenes, save_dir=str(tmp_path))
    assert set(res) == set(jres) == {"synth0000", "synth0001"}
    for name, (cloud, masks) in res.items():
        jcloud, jmasks = jres[name]
        np.testing.assert_array_equal(cloud, jcloud)
        assert masks.dtype == bool and masks.shape == jmasks.shape
        assert masks.shape[0] == cloud.shape[0] and masks.shape[1] >= 1
        np.testing.assert_array_equal(masks, jmasks)
        np.testing.assert_array_equal(
            np.load(tmp_path / f"{name}_masks.npy"), masks)
        np.testing.assert_array_equal(
            np.load(tmp_path / f"{name}_cloud.npy"), cloud)
    assert set(pipe.timings) == {"csc_graph", "csc_forward", "aggregation",
                                 "ncut", "lift_rebase"}
    # idempotent: a second call skips the scenes that exist
    assert pipe.process_scenes(scenes, save_dir=str(tmp_path)) == {}
    assert len(pipe.process_scenes(scenes, save_dir=str(tmp_path),
                                   skip_existing=False)) == 2


def test_pipeline_query_method_matches_jax(pipeline_pair):
    scenes, jpipe, _, pipe = pipeline_pair
    jq = jpipeline.PseudoMaskPipeline(modality="geom", method="query",
                                      voxel_size=0.08)
    jq.csc = jpipe.csc
    qpipe = PseudoMaskPipeline(modality="geom", method="query",
                               voxel_size=0.08, device="cpu",
                               csc_variables=np_tree(jpipe.csc.variables))
    want = jq.process_scenes(scenes[:1])
    got = qpipe.process_scenes(scenes[:1])
    np.testing.assert_array_equal(got["synth0000"][1], want["synth0000"][1])
    assert "query" in qpipe.timings


def test_pipeline_unported_options_raise():
    with pytest.raises(ValueError):
        PseudoMaskPipeline(modality="depth", device="cpu")
    # LSegNet is ported (tests/test_torch_lseg.py): the name resolves
    assert load_2d_model("LSegNet").__name__ == "LSegNet"
    with pytest.raises(KeyError, match="unknown 2d model"):
        load_2d_model("CLIPNet")
    pipe = PseudoMaskPipeline(device="cpu")
    # save_visualizations is ported (tests/test_torch_eval_clis.py)
    assert pipe.process_scenes([], save_visualizations=True) == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            PseudoMaskPipeline()        # the default device is the card


def test_scannet_constants_and_label_map_equal_jax(tmp_path):
    """The label tables are the JAX module's; `load_label_map` reads a
    scannetv2-labels.combined.tsv to the same dicts, rows without an
    integer id skipped."""
    from unscene3d_tpu.data import scannet_constants as jconst
    from unscene3d_torch.data import scannet_constants as const

    for name in ("VALID_CLASS_IDS_20", "CLASS_LABELS_20",
                 "VALID_CLASS_IDS_200", "CLASS_LABELS_200",
                 "FLOOR_WALL_RAW_IDS", "HEAD_CATS_SCANNET_200",
                 "COMMON_CATS_SCANNET_200", "TAIL_CATS_SCANNET_200"):
        assert getattr(const, name) == getattr(jconst, name), name
    assert len(const.CLASS_LABELS_200) == len(const.VALID_CLASS_IDS_200)
    tsv = tmp_path / "scannetv2-labels.combined.tsv"
    tsv.write_text("id\traw_category\tcategory\tnyu40id\n"
                   "1\twall\twall\t1\n2\tchair\tchair\t5\n"
                   "22\tkitchen counter\tcounter\t12\n7\tbox\tbox\t\n")
    for to in ("id", "nyu40id"):
        assert const.load_label_map(str(tsv), to) == \
            jconst.load_label_map(str(tsv), to)
    assert const.load_label_map(str(tsv), "nyu40id") == {
        "wall": 1, "chair": 5, "kitchen counter": 12}
