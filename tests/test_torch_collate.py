"""The PyTorch port's host collate against the JAX FreeMaskCollator: every
table is bitwise equal, the instance targets included. Also: the port,
its train step included, imports neither jax nor flax nor any module of the
JAX package (checked in a subprocess, since this process imported jax
through conftest), the self-training entry point and an Experiment built
from the repository's conf/ and evaluating on the CPU included. With `csr_levels` set every table but the pair tables is
still bitwise equal; tests/test_torch_csr.py holds the pair tables."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_batch as jax_make_batch
from unscene3d_tpu.ops.window_gather import (up_tables_from_parents as
                                             jax_up_tables)
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_batch
from unscene3d_torch.ops.segment_pool import (ROWS_PER_PIECE, segment_order,
                                              segment_pieces)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=[
    dict(voxel_size=0.12, fine_buckets=False, scenes=2, points=1500),
    dict(voxel_size=0.06, fine_buckets=True, scenes=1, points=4000),
    dict(voxel_size=0.06, fine_buckets=False, scenes=2, points=1500,
         csr_levels=(0, 1)),
], ids=["coarse-2scenes", "fine-1scene", "csr01-2scenes"])
def both(request):
    p = request.param
    scenes = make_batch(p["scenes"], num_points=p["points"])
    kw = dict(voxel_size=p["voxel_size"], fine_buckets=p["fine_buckets"],
              fps_queries=8, csr_levels=p.get("csr_levels", ()))
    ref, ref_meta = JaxCollator(**kw)(scenes)
    got, meta = FreeMaskCollator(**kw)(scenes)
    return ref, ref_meta, got, meta


def test_synthetic_scene_copy_is_identical():
    a, b = make_batch(2, num_points=800), jax_make_batch(2, num_points=800)
    for sa, sb in zip(a, b):
        for k in ("xyz", "features", "segments", "masks"):
            np.testing.assert_array_equal(sa[k], sb[k])


def test_graph_tables_bitwise(both):
    ref, _, got, _ = both
    assert len(ref.graph.levels) == len(got.graph.levels) == 5
    for lr, lg in zip(ref.graph.levels, got.graph.levels):
        for name in ("coords", "valid", "nbr_idx", "child_idx", "parent_idx",
                     "parent_offset"):
            r, g = np.asarray(getattr(lr, name)), getattr(lg, name).numpy()
            assert r.dtype == g.dtype, name
            np.testing.assert_array_equal(g, r, err_msg=name)
        assert lr.finer_num_padded == lg.finer_num_padded
        # pair tables at the same levels; those levels padded to 256 rows
        assert (lr.csr is None) == (lg.csr is None)
        if lg.csr is not None:
            assert lg.num_padded % 256 == 0


def test_up_tables_match_jax(both):
    """The collate's one-hot parent tables equal the JAX package's
    up_tables_from_parents over the JAX collator's parent maps."""
    ref, _, got, _ = both
    L, G = ref.graph.levels, got.graph.levels
    for lv in range(4):
        want = jax_up_tables(np.asarray(L[lv].parent_idx),
                             np.asarray(L[lv].parent_offset),
                             np.asarray(L[lv].valid), L[lv + 1].num_padded)
        assert G[lv].up_idx.dtype == torch.int32
        np.testing.assert_array_equal(G[lv].up_idx.numpy(), want)
    assert G[4].up_idx is None


def test_batch_tables_bitwise(both):
    ref, ref_meta, got, meta = both
    for name in ("features", "raw_coords", "point2segment", "seg_valid",
                 "seg_counts", "level_bounds", "fps_idx"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    for lv in range(5):
        np.testing.assert_array_equal(got.scene_idx[lv].numpy(),
                                      np.asarray(ref.scene_idx[lv]))
        np.testing.assert_array_equal(got.scene_valid[lv].numpy(),
                                      np.asarray(ref.scene_valid[lv]))
    assert meta.num_voxels == ref_meta.num_voxels
    for a, b in zip(meta.inverse_maps, ref_meta.inverse_maps):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(meta.original_segments, ref_meta.original_segments):
        np.testing.assert_array_equal(a, b)


def _targets_equal(ref, got):
    for name in ("labels", "valid", "seg_masks", "vox_masks"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name).numpy()
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_targets_bitwise(both):
    ref, _, got, _ = both
    assert got.target is not None
    _targets_equal(ref.target, got.target)
    assert got.target.labels.shape[1] % 8 == 0


def test_targets_with_labels_and_emptied_instances_bitwise():
    """mask_labels carry over for the kept instances; an instance that
    voxelization empties (here: no point at all) is dropped."""
    scenes = make_batch(2, num_points=1500, seed=3)
    for i, s in enumerate(scenes):
        k = s["masks"].shape[1]
        s["masks"] = np.concatenate(
            [s["masks"], np.zeros((len(s["xyz"]), 1), bool)], axis=1)
        s["mask_labels"] = (np.arange(k + 1) % 3 + i).astype(np.int32)
    ref, _ = JaxCollator(voxel_size=0.12, fps_queries=8)(scenes)
    got, _ = FreeMaskCollator(voxel_size=0.12, fps_queries=8)(scenes)
    _targets_equal(ref.target, got.target)
    assert int(got.target.valid.sum()) == sum(
        s["masks"].shape[1] - 1 for s in scenes)
    moved = got.to("cpu")
    assert torch.equal(moved.target.seg_masks, got.target.seg_masks)


def test_segment_order_walks_each_segment_in_row_order(both):
    _, _, got, _ = both
    S = got.num_segments_padded
    seg_flat = (got.batch_idx.numpy().astype(np.int64) * S
                + got.point2segment.numpy())
    valid = got.valid.numpy()
    order, offsets = got.seg_order.numpy(), got.seg_offsets.numpy()
    assert offsets[-1] == valid.sum() == len(order)
    for s in range(got.batch_size * S):
        rows = order[offsets[s]:offsets[s + 1]]
        np.testing.assert_array_equal(
            rows, np.nonzero(valid & (seg_flat == s))[0])
    np.testing.assert_array_equal(np.diff(offsets),
                                  got.seg_counts.numpy().astype(np.int64))


def _check_pieces(pieces, offsets, rows):
    """Segment s's pieces first[s]:first[s + 1] tile its run of the order
    offsets[s]:offsets[s + 1] exactly once, in order, each at most `rows`
    long and all but its last exactly `rows`."""
    s = len(offsets) - 1
    first, bounds = pieces[:s + 1], pieces[s + 1:]
    assert first[0] == 0 and first[-1] == len(bounds) - 1
    assert bounds[-1] == offsets[-1]
    for k in range(s):
        cut = bounds[first[k]:first[k + 1] + 1]
        if offsets[k] == offsets[k + 1]:
            assert first[k] == first[k + 1]
            continue
        assert cut[0] == offsets[k] and cut[-1] == offsets[k + 1]
        sizes = np.diff(cut)
        assert (sizes[:-1] == rows).all() and 0 < sizes[-1] <= rows


def test_segment_pieces_cut_each_segment_in_order(both):
    _, _, got, _ = both
    offsets = got.seg_offsets.numpy()
    pieces = got.seg_pieces.numpy()
    assert got.seg_pieces.dtype == torch.int32
    np.testing.assert_array_equal(pieces, segment_pieces(offsets))
    _check_pieces(pieces, offsets, ROWS_PER_PIECE)
    rng = np.random.RandomState(0)
    counts = rng.choice([0, 1, 5, 16, 17, 100], 40)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for rows in (1, 16, 64):
        _check_pieces(segment_pieces(offsets, rows), offsets, rows)
    np.testing.assert_array_equal(segment_pieces(np.array([0, 0, 0]), 4),
                                  [0, 0, 0, 0])


def test_segment_order_drops_invalid_and_out_of_range():
    ids = np.array([3, -1, 0, 3, 7, 0, 1])
    valid = np.array([1, 1, 1, 0, 1, 1, 1], bool)
    order, offsets = segment_order(ids, 4, valid)
    np.testing.assert_array_equal(order, [2, 5, 6, 0])
    np.testing.assert_array_equal(offsets, [0, 2, 3, 3, 4])


def test_port_imports_no_jax():
    code = (
        "import sys, torch\n"
        "from unscene3d_torch.data.synthetic import make_scene\n"
        "from unscene3d_torch.inference import Predictor, build_mask3d\n"
        "m = build_mask3d(torch.float32, backbone='Res16UNet14A',"
        " hidden_dim=16, num_queries=4, num_heads=2, dim_feedforward=32,"
        " num_decoders=1)\n"
        "scene = make_scene(800, seed=1)\n"
        "res = Predictor(m, 'cpu', voxel_size=0.15)(scene)\n"
        "assert res['masks'].shape[0] == len(scene['xyz'])\n"
        "res = Predictor(m, 'cpu', voxel_size=0.15,"
        " csr_levels=(0, 1))(scene)\n"
        "assert res['masks'].shape[0] == len(scene['xyz'])\n"
        "import unscene3d_torch.ops.brick_engine\n"
        "from unscene3d_torch.data.collate import FreeMaskCollator\n"
        "from unscene3d_torch.train.loop import build_trainer\n"
        "t = build_trainer(torch.float32, backbone='Res16UNet14A',"
        " hidden_dim=16, num_queries=4, num_heads=2, dim_feedforward=32,"
        " num_decoders=1, sample_sizes=(16, 32, 64, 128, 256),"
        " device='cpu')\n"
        "b, _ = FreeMaskCollator(voxel_size=0.15, fps_queries=4)([scene])\n"
        "loss = t.train_step(b, torch.Generator().manual_seed(0))['total']\n"
        "assert torch.isfinite(loss)\n"
        "import numpy as np\n"
        "from unscene3d_torch.bench import proto_brick, proto_win_decompose\n"
        "from unscene3d_torch.bench.pseudo import bench_pseudo\n"
        "from unscene3d_torch.ops.hashing import sparse_quantize\n"
        "from unscene3d_torch.pseudo.ncut import NCutConfig\n"
        "from unscene3d_torch.pseudo.pipeline import PseudoMaskPipeline\n"
        "small = dict(num_points=3000, num_objects=3, extent=2.0, seed=1)\n"
        "quiet = lambda msg: None\n"
        "proto_brick.run('cpu', channels=8, scene=small, voxel_size=0.05,"
        " reps=1, log=quiet)\n"
        "proto_win_decompose.run('cpu', cin=8, group=2, w_sub=256,"
        " scene=small, reps=1, log=quiet)\n"
        "cfg = NCutConfig(max_number_of_instances=2)\n"
        "res = bench_pseudo('cpu', 2, 40, cfg=cfg, runs=1, log=quiet)\n"
        "assert len(res['masks']) == 2\n"
        "vox, umap, _ = sparse_quantize(scene['xyz'], 0.15)\n"
        "seg = scene['segments'][umap]\n"
        "u = np.unique(seg)\n"
        "conn = np.column_stack([u[:-1], u[1:]])\n"
        "pseudo = dict(scene_name='s', coords=vox,"
        " feats=scene['features'][umap], segment_ids=[seg],"
        " segment_connectivity=[np.vstack([conn, conn[:, ::-1]])],"
        " full_coords=scene['xyz'])\n"
        "for method in ('ncut', 'query'):\n"
        "    pipe = PseudoMaskPipeline(device='cpu', voxel_size=0.15,"
        " method=method, ncut_cfg=cfg)\n"
        "    out = pipe.process_scenes([pseudo])\n"
        "    assert out['s'][1].shape[0] == len(scene['xyz'])\n"
        "import tempfile\n"
        "from unscene3d_torch.main_instance_segmentation import ("
        "build_experiment, get_parameters)\n"
        "cfg = get_parameters(['data/datasets=synthetic',"
        " 'data.batch_size=2', 'data.voxel_size=0.15',"
        " 'model.hidden_dim=16', 'model.num_queries=4', 'model.num_heads=2',"
        " 'model.dim_feedforward=32', 'model.num_decoders=1',"
        " 'model.backbone._target_=unscene3d_tpu.models.backbone."
        "Res16UNet14A', 'data.datasets.validation_dataset.num_points=1500',"
        " 'general.device=cpu', 'general.save_dir=' + tempfile.mkdtemp()])\n"
        "exp = build_experiment(cfg)\n"
        "res = exp.evaluate(exp.validation_dataset, max_scenes=1)\n"
        "assert {'all_ap', 'all_ap_50%', 'all_ap_25%'} <= set(res)\n"
        "from unscene3d_torch.data.collate import MergeCollator\n"
        "t = build_trainer(torch.float32, backbone='Res16UNet14A',"
        " hidden_dim=16, num_queries=4, num_heads=2, dim_feedforward=32,"
        " num_decoders=1, sample_sizes=(16, 32, 64, 128, 256),"
        " device='cpu', weight_noise_robust=1.0, dropout=0.1,"
        " pre_norm=True, use_level_embed=True, scatter_type='max')\n"
        "b, _ = MergeCollator(voxel_size=0.15, fps_queries=4,"
        " build_triplane=True)([scene, make_scene(800, seed=2)])\n"
        "nr = t.train_step(b, torch.Generator().manual_seed(0))"
        "['loss_noise_robust']\n"
        "assert torch.isfinite(nr).all() and (nr > 0).all()\n"
        "cfg = get_parameters(['data/datasets=synthetic',"
        " 'data.batch_size=2', 'data.voxel_size=0.15',"
        " 'model.hidden_dim=16', 'model.num_queries=4', 'model.num_heads=2',"
        " 'model.dim_feedforward=32', 'model.num_decoders=1',"
        " 'model.non_parametric_queries=false',"
        " 'model.backbone._target_=unscene3d_tpu.models.backbone."
        "Res16UNet14A', 'data.datasets.validation_dataset.num_points=1500',"
        " 'data/collation_functions=voxelize_collate_merge',"
        " 'data.prefetch_processes=1', 'loss.weight_noise_robust=1.0',"
        " 'general.device=cpu', 'general.save_dir=' + tempfile.mkdtemp()])\n"
        "exp = build_experiment(cfg)\n"
        "res = exp.evaluate(exp.validation_dataset, max_scenes=1)\n"
        "exp.close()\n"
        "assert {'all_ap', 'all_ap_50%', 'all_ap_25%'} <= set(res)\n"
        "from unscene3d_torch import native, pseudo_masks_main\n"
        "from unscene3d_torch.data import ply, scannet_pseudo\n"
        "from unscene3d_torch.data.synthetic import make_mesh_scene\n"
        "from unscene3d_torch.models import torch_convert\n"
        "from unscene3d_torch.models.encoders_2d import load_2d_model\n"
        "mesh = make_mesh_scene(grid=16, num_objects=2)\n"
        "seg, _ = native.segment_mesh(mesh['vertices'], mesh['faces'],"
        " mesh['colors'] / 255.0, 0.005, 5)\n"
        "assert native.calls()['segment_mesh'] == 1\n"
        "state = torch_convert.convert_res16unet("
        "torch_convert.random_me_state_dict())\n"
        "pipe = PseudoMaskPipeline(modality='both', device='cpu',"
        " voxel_size=0.15, ncut_cfg=cfg)\n"
        "pipe.csc.model.load_state_dict(state)\n"
        "f = load_2d_model('DinoNet')(device='cpu')(np.random.rand(1, 24, 32,"
        " 3))\n"
        "assert tuple(f.shape) == (1, 24, 32, 384)\n"
        "from unscene3d_torch import main_instance_segmentation as entry\n"
        "from unscene3d_torch.parallel import distributed, mesh\n"
        "assert distributed.initialize_from_env('cpu') is False\n"
        "assert entry.local_ranks(cfg) == 1\n"
        "from unscene3d_torch import (eval_3duis_performance,"
        " eval_cutler_projection, eval_freemask_gt_performance)\n"
        "from unscene3d_torch.data import (dataset_sets, pseudo_datasets,"
        " pseudo_transforms, semseg_dataset)\n"
        "from unscene3d_torch.eval import html_viewer, metrics, visualize\n"
        "from unscene3d_torch.pseudo.freemask_utils import lidar_3duis\n"
        "lab = lidar_3duis(np.random.RandomState(0).rand(300, 3), 5)\n"
        "assert lab.shape == (300,) and lab.max() >= 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax',"
        " 'jaxlib', 'unscene3d_tpu', 'benchmarks', 'sklearn')]\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "OK" in res.stdout
