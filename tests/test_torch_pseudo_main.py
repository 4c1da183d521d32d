"""The pseudo-mask slice as the paper makes it, on the CPU: DINO ViT-S/8 and
CSC features (`freemask.modality=both`) through the port's entry point
`python -m unscene3d_torch.pseudo_masks_main` against the repository's
`pseudo_masks_main.py`, on one ScanNet-layout directory written here (two
scenes: the scannet200_insseg `.pth` tuples, `_vh_clean_2.ply` meshes with
faces, `axisAlignment` meta files, JPEG frames with poses and intrinsics)
with seeded random CSC (ME format) and DINO (DINO-repo format) `.pth`
checkpoints. Also the stages on the way, against the JAX package: the
ScanNet data set's items, the CSC checkpoint loader's features, the
projected 2D features.

Tolerances:
  * the saved `{scene}_cloud.npy` and `{scene}_masks.npy`, the data set's
    items, the converted checkpoint's structure: equal;
  * the CSC features of a converted checkpoint (Res16UNet34C, res_2):
    rtol 2e-4 / atol 2e-5, as tests/test_torch_pseudo.py holds the
    multires backbone;
  * the per-voxel 2D features (ViT-S, upsample, projection, the pairwise
    mean over frames): 1e-4 of max|JAX|, as the DINO tests hold `DinoNet`.

The scenes are small (60 x 60 vertices at 5 cm, 40 x 56 frames) and NCut
stops at 5 instances, so its greedy iterations have unique Fiedler vectors
and whole trajectories are well posed (tests/test_torch_pseudo.py).
"""

import os
import shutil
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import pseudo_masks_main as jax_main
from tests._torch_jax import one_torch_thread  # noqa: F401
from unscene3d_tpu.data import scannet_pseudo as jdata
from unscene3d_tpu.models.torch_convert import (
    convert_res16unet as jax_convert, load_csc_backbone as jax_load_csc,
    me_offset_permutation as jax_perm)
from unscene3d_tpu.pseudo import pipeline as jpipeline
from unscene3d_tpu.pseudo.csc import CSCFeatureExtractor as JaxCSC
from unscene3d_torch import native
from unscene3d_torch import pseudo_masks_main as port_main
from unscene3d_torch.data import scannet_pseudo
from unscene3d_torch.data.synthetic import (make_mesh_scene, ring_poses,
                                            write_scannet_scene)
from unscene3d_torch.models.encoders_2d.dino import ViTExtractor
from unscene3d_torch.models.torch_convert import (convert_res16unet,
                                                  load_csc_backbone,
                                                  me_offset_permutation,
                                                  random_me_state_dict)
from unscene3d_torch.pseudo.csc import CSCFeatureExtractor
from unscene3d_torch.pseudo.pipeline import PseudoMaskPipeline

SCENES = ["scene0000_00", "scene0001_00"]
FEATURE_TOL = 1e-4


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """The ScanNet-layout directory, the two checkpoints and the overrides
    of scripts/unsupervised/pseudo_dino_2d3d.sh that point at them."""
    root = tmp_path_factory.mktemp("scannet")
    ins, scans = str(root / "insseg"), str(root / "scans")
    for i, name in enumerate(SCENES):
        mesh = make_mesh_scene(grid=60, num_objects=6, seed=i)
        ang = 0.3 + i
        align = np.eye(4)
        align[:2, :2] = [[np.cos(ang), -np.sin(ang)],
                         [np.sin(ang), np.cos(ang)]]
        align[:3, 3] = [1.0, -2.0, 0.0]
        poses = ring_poses(mesh["vertices"].mean(0), 2.5, 1.5, 2)
        write_scannet_scene(ins, scans, name, mesh, alignment=align,
                            poses=poses, image_resolution=(100, 140), seed=i)
    with open(os.path.join(ins, "train.txt"), "w") as f:
        f.write("\n".join(SCENES) + "\n")
    csc = str(root / "CSC_train_Res16UNet34C_2cm.pth")
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v
                               in random_me_state_dict(prefix="model.")
                               .items()}}, csc)
    dino = str(root / "dino_deitsmall8_pretrain.pth")
    torch.save({f"module.{k}": v for k, v
                in ViTExtractor().init_random_(3).state_dict().items()}, dino)
    overrides = [
        "freemask.modality=both", "freemask.affinity_tau=0.6",
        "data.segments_min_vert_nums=[20]", f"data.scannet_path={ins}",
        f"data.scannet_images_path={scans}",
        f"net.weights_for_inner_model={csc}",
        f"image_data.model_checkpoint={dino}",
        "image_data.image_resolution=[100,140]",
        "freemask.max_instance_num=5", "freemask.min_segment_size=2"]
    return dict(root=root, insseg=ins, scans=scans, csc=csc, dino=dino,
                overrides=overrides)


def _dataset(mod, layout, **kw):
    return mod.ScanNetPseudoDataset(
        layout["insseg"], layout["scans"], segments_min_vert_nums=(20,),
        use_images=True, image_resolution=(100, 140), **kw)


@pytest.fixture(scope="module")
def ran(layout):
    """Both entry points on the layout: the port on the CPU, the JAX one
    through its own `main` with sys.argv patched."""
    port_dir, jax_dir = layout["root"] / "port", layout["root"] / "jax"
    native.reset_calls()
    pipe = port_main.main(layout["overrides"] + [
        f"misc.save_dir={port_dir}", "misc.device=cpu"])
    calls = native.calls()["segment_mesh"]
    with mock.patch.object(sys, "argv", ["pseudo_masks_main.py"]
                           + layout["overrides"]
                           + [f"misc.save_dir={jax_dir}"]):
        jax_main.main()
    return port_dir, jax_dir, pipe, calls


@pytest.mark.parametrize("scene", SCENES)
def test_entry_points_write_the_same_npys(ran, scene):
    port_dir, jax_dir, _, _ = ran
    cloud = np.load(port_dir / f"{scene}_cloud.npy")
    masks = np.load(port_dir / f"{scene}_masks.npy")
    np.testing.assert_array_equal(cloud, np.load(jax_dir / f"{scene}_cloud.npy"))
    want = np.load(jax_dir / f"{scene}_masks.npy")
    assert masks.dtype == bool and masks.shape == want.shape
    assert masks.shape[0] == len(cloud) == 3600 and masks.shape[1] >= 1
    np.testing.assert_array_equal(masks, want)


def test_the_run_went_through_its_stages(ran):
    """The native segmentator served each scene; every stage ran; the
    frames hit voxels; a rerun skips the scenes that exist."""
    port_dir, _, pipe, calls = ran
    assert calls == len(SCENES)
    assert set(pipe.timings) == {"dino", "project", "csc_graph",
                                 "csc_forward", "aggregation", "ncut",
                                 "lift_rebase"}
    assert pipe.modality == "both" and pipe.dino is not None


def test_rerun_and_shards_skip_what_exists(layout, ran):
    port_dir = ran[0]
    stamp = {s: os.path.getmtime(port_dir / f"{s}_masks.npy") for s in SCENES}
    pipe = port_main.main(layout["overrides"] + [
        f"misc.save_dir={port_dir}", "misc.device=cpu"])
    assert set(pipe.timings) == {"ncut", "lift_rebase"}   # nothing encoded
    assert stamp == {s: os.path.getmtime(port_dir / f"{s}_masks.npy")
                     for s in SCENES}
    shard = layout["root"] / "shard"
    port_main.main(layout["overrides"] + [
        f"misc.save_dir={shard}", "misc.device=cpu", "misc.num_shards=2",
        "misc.shard=1", "freemask.modality=geom"])
    assert sorted(os.listdir(shard)) == [f"{SCENES[1]}_cloud.npy",
                                         f"{SCENES[1]}_masks.npy"]


def test_entry_point_runs_on_the_card_unless_asked(layout, tmp_path):
    cfg = port_main.load_parameters(layout["overrides"])
    assert cfg.misc.get("device") is None and cfg.freemask.modality == "both"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_main.main(layout["overrides"]
                           + [f"misc.save_dir={tmp_path}"])


@pytest.mark.parametrize("idx", [0, 1])
def test_dataset_items_equal_jax(layout, idx):
    got = _dataset(scannet_pseudo, layout)[idx]
    want = _dataset(jdata, layout)[idx]
    assert set(got) == set(want)
    for key, ref in want.items():
        if key in ("segment_ids", "segment_connectivity"):
            assert len(got[key]) == len(ref) == 1
            np.testing.assert_array_equal(got[key][0], ref[0], err_msg=key)
        elif isinstance(ref, str):
            assert got[key] == ref
        else:
            np.testing.assert_array_equal(got[key], ref, err_msg=key)
            assert np.asarray(got[key]).dtype == np.asarray(ref).dtype, key
    assert got["images"].shape == (2, 40, 56, 3)
    assert len(np.unique(got["segment_ids"][0])) > 10


def test_missing_frames_raise(layout, tmp_path):
    scans = tmp_path / "scans"
    shutil.copytree(layout["scans"], scans)
    shutil.rmtree(scans / SCENES[0] / "color")
    ds = scannet_pseudo.ScanNetPseudoDataset(
        layout["insseg"], str(scans), use_images=True)
    with pytest.raises(FileNotFoundError, match="frame directory"):
        ds[0]
    jds = jdata.ScanNetPseudoDataset(layout["insseg"], str(scans),
                                     use_images=True)
    assert jds[0]["images"] is None          # the JAX package goes on
    with mock.patch.dict(sys.modules, {"PIL": None}):
        with pytest.raises(ImportError, match="PIL"):
            _dataset(scannet_pseudo, layout)[1]


def test_2d_features_match_jax(layout):
    """One scene's per-voxel DINO features, frames projected and averaged
    the reference's way, against the JAX pipeline's `_encode_2d`."""
    scene = _dataset(scannet_pseudo, layout)[0]
    jpipe = jpipeline.PseudoMaskPipeline(modality="color",
                                         dino_weights=layout["dino"])
    want = jpipe._encode_2d(scene)
    pipe = PseudoMaskPipeline(modality="color", dino_weights=layout["dino"],
                              device="cpu")
    got = pipe._encode_2d(scene)
    assert got.shape == want.shape == (len(scene["coords"]), 384)
    hit = np.abs(want).sum(1) > 0
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_array_equal(np.abs(got).sum(1) > 0, hit)
    assert np.abs(got - want).max() <= FEATURE_TOL * np.abs(want).max()


def test_2d_features_mean_over_hit_frames_match_jax(layout):
    """`reference_average=False` on both sides: each voxel's mean over the
    frames that hit it (unscene3d_tpu/pseudo/pipeline.py:88-99), at
    test_2d_features_match_jax's tolerance; it differs from the pairwise
    mean where a voxel is hit more than once."""
    scene = _dataset(scannet_pseudo, layout)[0]
    jpipe = jpipeline.PseudoMaskPipeline(modality="color",
                                         dino_weights=layout["dino"],
                                         reference_average=False)
    want = jpipe._encode_2d(scene)
    pipe = PseudoMaskPipeline(modality="color", dino_weights=layout["dino"],
                              device="cpu", reference_average=False)
    got = pipe._encode_2d(scene)
    hit = np.abs(want).sum(1) > 0
    np.testing.assert_array_equal(np.abs(got).sum(1) > 0, hit)
    assert np.abs(got - want).max() <= FEATURE_TOL * np.abs(want).max()
    pairwise = PseudoMaskPipeline(modality="color", device="cpu",
                                  dino_weights=layout["dino"])._encode_2d(
                                      scene)
    assert np.abs(pairwise - got).max() > FEATURE_TOL * np.abs(want).max()


def test_csc_checkpoint_features_match_jax(layout):
    scene = _dataset(scannet_pseudo, layout)[1]
    want = JaxCSC(variables=jax_load_csc(layout["csc"]))(scene["coords"],
                                                          scene["feats"])
    got = CSCFeatureExtractor(state_dict=load_csc_backbone(layout["csc"]),
                              device="cpu")(scene["coords"], scene["feats"])
    assert got.shape == want.shape == (len(scene["coords"]), 96)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_csc_conversion_structure_and_keys():
    sd = random_me_state_dict(seed=1)
    state = convert_res16unet(sd)
    flax = jax_convert(sd)
    for name, ref in [("conv0p1s1_conv.kernel",
                       flax["params"]["conv0p1s1_conv"]["kernel"]),
                      ("block2_0.downsample_conv.kernel",
                       flax["params"]["block2_0"]["downsample_conv"]["kernel"]),
                      ("convtr4p16s2_bn.mean",
                       flax["batch_stats"]["convtr4p16s2_bn"]["mean"]),
                      ("block8_1.norm2.scale",
                       flax["params"]["block8_1"]["norm2"]["scale"]),
                      ("final.kernel", flax["params"]["final"]["kernel"])]:
        np.testing.assert_array_equal(state[name].numpy(), ref, err_msg=name)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(me_offset_permutation(k),
                                      jax_perm(k))
        np.testing.assert_array_equal(me_offset_permutation(k, "z_fastest"),
                                      jax_perm(k, "z_fastest"))
    for prefix in ("model.", "module.", "backbone."):
        again = convert_res16unet({prefix + k: v for k, v in sd.items()})
        assert all(torch.equal(again[k], state[k]) for k in state)
    with pytest.raises(KeyError, match="unused keys.*stray"):
        convert_res16unet(dict(sd, stray=np.zeros(3, np.float32)))
    lacking = {k: v for k, v in sd.items() if k != "block3.2.conv1.kernel"}
    with pytest.raises(KeyError, match="missing key 'block3.2.conv1.kernel'"):
        convert_res16unet(lacking)
    no_final = {k: v for k, v in sd.items() if not k.startswith("final")}
    with pytest.raises(KeyError, match="missing.*final"):
        CSCFeatureExtractor(state_dict=convert_res16unet(no_final),
                            device="cpu")
