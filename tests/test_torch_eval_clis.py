"""The port's evaluation CLIs and what they stand on, on the CPU, against
the repository's JAX CLIs and modules.

  * the three CLIs (`python -m unscene3d_torch.eval_freemask_gt_performance`,
    `...eval_3duis_performance`, `...eval_cutler_projection --device cpu`)
    print the same lines, the AP / AP50 / AP25 line included, as
    eval_freemask_gt_performance.py, eval_3duis_performance.py (HDBSCAN from
    scikit-learn) and eval_cutler_projection.py on one ScanNet-layout
    directory written here: two meshes from `data/synthetic`, their
    scannet200_insseg `.pth` clouds, pseudo masks, and CutLER-style PNG id
    maps rendered from the GT instances with the CLI's own camera;
  * `hdbscan_labels` (pseudo/hdbscan.py) equals scikit-learn 1.9's
    `HDBSCAN(min_cluster_size).fit(x).labels_` exactly: on jittered
    general-position clouds of 200, 700 and 2,000 points at
    min_cluster_size 5 and 20, and also on voxel-grid clouds (points on a
    5 cm lattice, where many mutual-reachability distances tie and the MST
    is not unique: the port follows scikit-learn's tie order, Prim from
    node 0 with the first minimum and the same argsort of the edges, and
    the labels are equal there too); its native Prim equals the numpy one
    bitwise;
  * `dataset_sets`, `cosine_sim`, `l2_sim`, `whiten_feats`: equal;
  * the query generator with FPS queries on both sides of fps_num_samples:
    masks equal, scores 1e-6;
  * `save_scene_visualization`: every file byte-equal to the JAX one's, and
    `PseudoMaskPipeline(save_visualizations=True)` writes them.
"""

import io
import os
import sys
import warnings
from contextlib import redirect_stdout
from unittest import mock

import numpy as np
import pytest
import torch

import eval_3duis_performance as jax_3duis
import eval_cutler_projection as jax_cutler
import eval_freemask_gt_performance as jax_freemask
from tests._torch_jax import one_torch_thread  # noqa: F401
from unscene3d_tpu.data import dataset_sets as jsets
from unscene3d_tpu.eval import visualize as jvis
from unscene3d_tpu.pseudo import freemask_query as jquery
from unscene3d_tpu.pseudo import freemask_utils as jutils
from unscene3d_torch import eval_3duis_performance as port_3duis
from unscene3d_torch import eval_cutler_projection as port_cutler
from unscene3d_torch import eval_freemask_gt_performance as port_freemask
from unscene3d_torch import native
from unscene3d_torch.data import dataset_sets as psets
from unscene3d_torch.data.synthetic import (make_mesh_scene, make_scene,
                                            render_instance_ids, ring_poses,
                                            scannet_color_intrinsics,
                                            write_scannet_scene)
from unscene3d_torch.eval import visualize as pvis
from unscene3d_torch.pseudo import freemask_utils as putils
from unscene3d_torch.pseudo import hdbscan
from unscene3d_torch.pseudo.freemask_query import freemask_query_masks

SCENES = ["scene0000_00", "scene0001_00"]
FRAMES = ("000000", "000020")
IMAGE = (96, 128)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """insseg .pth clouds, scans (meshes, poses, intrinsics), pseudo masks
    (every other point of the cloud, so the CLI's KD-tree match runs) and
    PNG id maps per frame."""
    from PIL import Image

    root = tmp_path_factory.mktemp("scannet")
    ins, scans = str(root / "insseg"), str(root / "scans")
    masks_dir, cutler = root / "masks", root / "cutler"
    masks_dir.mkdir()
    for i, name in enumerate(SCENES):
        mesh = make_mesh_scene(grid=40, num_objects=5, seed=i)
        align = np.eye(4)
        align[:3, 3] = [0.5 * i, -1.0, 0.0]
        poses = ring_poses(mesh["vertices"].mean(0), 2.0, 1.5, len(FRAMES))
        write_scannet_scene(ins, scans, name, mesh, alignment=align,
                            poses=poses, image_resolution=IMAGE, seed=i)
        inst = mesh["instances"]
        r = np.random.RandomState(i)
        ids = np.unique(inst[inst >= 0])
        soft = np.stack([np.where(inst == k, 0.6 + 0.4 * r.rand(len(inst)),
                                  0.4 * r.rand(len(inst))) for k in ids], 1)
        soft[r.rand(len(inst)) < 0.1, 0] = 0.0
        np.save(masks_dir / f"{name}_cloud.npy",
                mesh["vertices"][::2].astype(np.float32))
        np.save(masks_dir / f"{name}_masks.npy", soft[::2])
        # the CLI scales ScanNet's color intrinsics (1296 x 968) to the
        # mask images: write them at that resolution
        K = scannet_color_intrinsics()
        np.savetxt(os.path.join(scans, name, "intrinsic",
                                "intrinsic_color.txt"), K)
        K = K[:3, :3] * np.array([IMAGE[1] / 1296.0, IMAGE[0] / 968.0,
                                  1.0])[:, None]
        (cutler / name).mkdir(parents=True)
        for fr, pose in zip(FRAMES, poses):
            img = render_instance_ids(mesh["vertices"].astype(np.float64),
                                      inst, pose, K, IMAGE)
            Image.fromarray(img).save(cutler / name / f"{fr}.png")
    with open(os.path.join(ins, "val.txt"), "w") as f:
        f.write("\n".join(SCENES) + "\n")
    return dict(ins=ins, scans=scans, masks=str(masks_dir),
                cutler=str(cutler))


def _jax_lines(module, argv):
    out = io.StringIO()
    with mock.patch.object(sys, "argv", ["cli.py"] + argv), \
            redirect_stdout(out), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        module.main()
    return out.getvalue().splitlines()


def _port_lines(module, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        res = module.main(argv)
    return out.getvalue().splitlines(), res


def test_freemask_gt_cli_prints_the_jax_lines(layout):
    argv = ["--masks_dir", layout["masks"], "--gt_dir", layout["ins"]]
    want = _jax_lines(jax_freemask, argv)
    got, res = _port_lines(port_freemask, argv)
    assert got == want and want[-1].startswith("AP ")
    assert res["scenes"] == 2 and res["results"]["all_ap_50%"] > 0


def test_3duis_cli_prints_the_jax_lines(layout):
    argv = ["--gt_dir", layout["ins"], "--min_cluster_size", "20",
            "--voxel_size", "0.05"]
    want = _jax_lines(jax_3duis, argv)
    got, res = _port_lines(port_3duis, argv)
    assert got == want and want[-1].startswith("AP ")
    assert res["scenes"] == 2 and res["hdbscan_seconds"] > 0


def test_cutler_cli_prints_the_jax_lines(layout):
    argv = ["--masks_dir", layout["cutler"], "--gt_dir", layout["ins"],
            "--scans_dir", layout["scans"]]
    want = _jax_lines(jax_cutler, argv)
    got, res = _port_lines(port_cutler, argv + ["--device", "cpu"])
    assert got == want and want[-1].startswith("AP ")
    assert res["frames"] == 4 and res["results"]["all_ap_50%"] > 0
    # the per-frame ids themselves
    scene = SCENES[0]
    ds = port_cutler.ScanNetPseudoDataset(layout["ins"],
                                          scans_path=layout["scans"])
    points = ds.get_full_cloud(scene)[0]
    K = np.loadtxt(os.path.join(layout["scans"], scene, "intrinsic",
                                "intrinsic_color.txt"))[:3, :3]
    K = K * np.array([IMAGE[1] / 1296.0, IMAGE[0] / 968.0, 1.0])[:, None]
    from PIL import Image

    img = np.asarray(Image.open(os.path.join(layout["cutler"], scene,
                                             "000020.png")))
    pose = np.loadtxt(os.path.join(layout["scans"], scene, "pose",
                                   "000020.txt"))
    np.testing.assert_array_equal(
        port_cutler.project_frame_masks(img, points, pose, K, "cpu"),
        jax_cutler.project_frame_masks(img, points, pose, K))
    np.testing.assert_array_equal(res["per_frame"][scene][1],
                                  jax_cutler.project_frame_masks(
                                      img, points, pose, K))


def test_cutler_cli_defaults_to_the_card(layout):
    args = port_cutler.parse_args(["--masks_dir", "m", "--gt_dir", "g",
                                   "--scans_dir", "s"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_cutler.main(["--masks_dir", layout["cutler"], "--gt_dir",
                              layout["ins"], "--scans_dir", layout["scans"]])


def _blobs(n, seed):
    r = np.random.RandomState(seed)
    centres = r.rand(8, 3) * 5
    return centres[r.randint(0, 8, n)] + r.randn(n, 3) * 0.3


def _sklearn_labels(x, m, min_samples=None):
    from sklearn.cluster import HDBSCAN

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return HDBSCAN(min_cluster_size=m, min_samples=min_samples).fit(
            x).labels_


@pytest.mark.parametrize("n", [200, 700, 2000])
@pytest.mark.parametrize("m", [5, 20])
def test_hdbscan_equals_sklearn(n, m):
    x = _blobs(n, n + m)
    want = _sklearn_labels(x, m)
    got = hdbscan.hdbscan_labels(x, m)
    assert want.max() >= 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [5, 20])
def test_hdbscan_equals_sklearn_on_a_voxel_grid(m):
    """Points on a 5 cm lattice (the 3DUIS CLI's voxel centres): many
    equal distances, a non-unique MST, and still the same labels."""
    x = np.unique(np.floor(_blobs(3000, 7) / 0.05), axis=0) * 0.05
    want = _sklearn_labels(x, m)
    np.testing.assert_array_equal(hdbscan.hdbscan_labels(x, m), want)
    np.testing.assert_array_equal(putils.lidar_3duis(x, m), want)


def test_hdbscan_native_prim_and_options():
    x = _blobs(600, 3)
    core = hdbscan.core_distances(x, 10)
    for a, b in zip(hdbscan.prim_mst(x, core),
                    native.hdbscan_prim_mst(x, core)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(
        hdbscan.hdbscan_labels(x, 10, min_samples=4, native=False),
        _sklearn_labels(x, 10, min_samples=4))
    with pytest.raises(ValueError, match="min_samples"):
        hdbscan.hdbscan_labels(x[:5], 10)
    with pytest.raises(ValueError):
        hdbscan.hdbscan_labels(x[:1], 2)


def test_dataset_sets_equal_jax(tmp_path, monkeypatch):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "scannetv2_val.txt").write_text("s1\n\ns2\n")
    (tmp_path / "a" / "train.txt").write_text("t1\nt2\nt3\n")
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "scannetv2_test.txt").write_text("x9\n")
    monkeypatch.setenv("SCANNET_SPLITS_DIR", str(tmp_path / "b"))
    for split in ("train", "val", "test", "nope"):
        assert psets.scene_set(split, str(tmp_path / "a")) == \
            jsets.scene_set(split, str(tmp_path / "a"))
    assert psets.val_scenes(str(tmp_path / "a")) == ("s1", "s2")
    assert psets.train_scenes(str(tmp_path / "a")) == ("t1", "t2", "t3")
    assert psets.scene_set("test", str(tmp_path / "a")) == ("x9",)


def test_similarities_and_whitening_equal_jax():
    r = np.random.RandomState(0)
    a, b = r.randn(30, 8), r.randn(20, 8)
    for fn in ("cosine_sim", "l2_sim"):
        np.testing.assert_array_equal(getattr(putils, fn)(a, b),
                                      getattr(jutils, fn)(a, b))
    f = r.randn(200, 6)
    np.testing.assert_array_equal(putils.whiten_feats(f),
                                  jutils.whiten_feats(f))


@pytest.mark.parametrize("n_fps", [60, 80, 24])
def test_fps_queries_equal_jax(n_fps):
    """FPS on the first three feature channels: no sampling at 60 and 80 (S
    = 60 segments), 24 FPS queries below."""
    r = np.random.RandomState(1)
    s = 60
    groups = np.arange(s) // 12
    feats = np.eye(5)[groups] * 10 + r.rand(s, 5)
    uniq = np.arange(s)
    conn = np.array([[i, i + 1] for i in range(s - 1)]
                    + [[i + 1, i] for i in range(s - 1)])
    coords = np.column_stack([np.arange(s) * 0.05, np.zeros(s),
                              np.zeros(s)]).astype(np.float32)
    kw = dict(scene_extent=np.array([20.0, 20.0, 2.0]),
              nms_maskness_threshold=0.1, min_segments=2,
              use_fps_sampling=True, fps_num_samples=n_fps)
    wm, ws = jquery.freemask_query_masks(feats, uniq, conn, coords, **kw)
    gm, gs = freemask_query_masks(feats, uniq, conn, coords, **kw)
    assert len(wm) >= 3
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_allclose(gs, ws, atol=1e-6)


def test_visualization_files_equal_jax(tmp_path):
    scene = make_scene(900, 4, seed=2)
    feats = np.random.RandomState(0).randn(900, 6).astype(np.float32)
    kw = dict(colors=scene["colors"], segments=scene["segments"],
              masks=scene["masks"], features=feats)
    jvis.save_scene_visualization(str(tmp_path / "jax"), "s", scene["xyz"],
                                  **kw)
    pvis.save_scene_visualization(str(tmp_path / "port"), "s", scene["xyz"],
                                  **kw)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        "s.html", "s_instances.ply", "s_pca.ply", "s_rgb.ply",
        "s_segments.ply"]
    for name in files:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
    np.testing.assert_array_equal(pvis.pca_colors(feats),
                                  jvis.pca_colors(feats))


def test_pseudo_pipeline_saves_visualizations(tmp_path):
    from unscene3d_torch.ops.hashing import sparse_quantize
    from unscene3d_torch.pseudo.ncut import NCutConfig
    from unscene3d_torch.pseudo.pipeline import PseudoMaskPipeline

    scene = make_scene(800, seed=1)
    vox, umap, _ = sparse_quantize(scene["xyz"], 0.15)
    seg = scene["segments"][umap]
    u = np.unique(seg)
    conn = np.column_stack([u[:-1], u[1:]])
    pseudo = dict(scene_name="s", coords=vox, feats=scene["features"][umap],
                  segment_ids=[seg],
                  segment_connectivity=[np.vstack([conn, conn[:, ::-1]])],
                  full_coords=scene["xyz"], full_colors=scene["colors"])
    pipe = PseudoMaskPipeline(device="cpu", voxel_size=0.15, method="query",
                              ncut_cfg=NCutConfig(max_number_of_instances=2))
    out = pipe.process_scenes([pseudo], save_dir=str(tmp_path),
                              save_visualizations=True)
    files = set(os.listdir(tmp_path / "visualizations"))
    assert {"s.html", "s_rgb.ply", "s_segments.ply"} <= files
    assert ("s_instances.ply" in files) == bool(out["s"][1].shape[1])
