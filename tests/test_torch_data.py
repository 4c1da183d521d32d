"""The port's data side of the self-training round against the JAX package's:
every augmentation bitwise for the same RandomState, `FreeMaskDataset[i]`
bitwise with and without augmentation and with the self-train merge (the
KD-tree case included), the re-draw of a scene left without a mask, the
synthetic data set, `_EpochSampler`'s draws, `make_crops`, and the batches
that `Experiment.fit` draws for one epoch against the JAX Experiment's
`_train_batch_from(ids, pads=None)` (no master pad plan:
`general.static_shapes=false`)."""

import os

import numpy as np
import pytest

from tests._torch_jax import one_torch_thread  # noqa: F401
from tests.test_datasets import write_mask3d_dataset
from unscene3d_tpu.data import augmentations as jax_aug
from unscene3d_tpu.data import freemask_dataset as jax_fd
from unscene3d_tpu.data.collate import make_crops as jax_make_crops
from unscene3d_tpu.train.experiment import _EpochSampler as JaxSampler
from unscene3d_torch.data import augmentations as aug
from unscene3d_torch.data import freemask_dataset as fd
from unscene3d_torch.data.collate import make_crops
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.train.experiment import _EpochSampler

VOL = "conf/augmentation/volumentations_aug.yaml"
IMG = "conf/augmentation/albumentations_aug.yaml"


def _same(got, want, what=""):
    """Equal scene dicts (or arrays): the same keys, dtypes and values."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert got == want, what


def _scene(n=3000, seed=0):
    s = make_scene(num_points=n, num_objects=3, extent=3.0, seed=seed)
    s["normals"] = np.zeros((len(s["xyz"]), 3), np.float32)
    return s


def _db_points(seed):
    src = _scene(seed=seed)
    inst = np.argmax(src["masks"], 1)
    inst[~src["masks"].any(1)] = -1
    return np.column_stack([src["xyz"], src["colors"] * 255,
                            np.zeros((len(src["xyz"]), 3)), src["segments"],
                            src["labels"], inst])


AUG_CASES = {
    "elastic": lambda m, s, r: m.elastic_distortion(
        np.asarray(s["xyz"], np.float64), 0.2, 0.4, r),
    "rotation": lambda m, s, r: m.rotation_matrix(r),
    "flip_in_center": lambda m, s, r: m.flip_in_center(
        np.asarray(s["xyz"], np.float64)),
    "cut_point_regions": lambda m, s, r: m.cut_point_regions(dict(s), r, 500,
                                                             0.4),
    "random_around_points": lambda m, s, r: m.random_around_points(
        dict(s), r, 0.1, 0.0),
    "random_around_points_noise": lambda m, s, r: m.random_around_points(
        dict(s), r, 0.1, 0.3, ignore_label=255),
    "oversample_instances": lambda m, s, r: m.oversample_instances(
        dict(s), [{"seed": i} for i in range(3)],
        lambda e: _db_points(e["seed"]), 1.0, True, r),
    "oversample_uniform": lambda m, s, r: m.oversample_instances(
        dict(s), [{"seed": i} for i in range(3)],
        lambda e: _db_points(e["seed"]), 1.0, False, r),
    "append_unlabeled_scene": lambda m, s, r: m.append_unlabeled_scene(
        dict(s), [{"seed": 9}], lambda e: _db_points(e["seed"]), r, 255),
    "volume_augmentations": lambda m, s, r: m.VolumeAugmentations(VOL)(
        np.asarray(s["xyz"], np.float64).copy(), r),
    "image_augmentations": lambda m, s, r: m.ImageAugmentations(IMG)(
        np.asarray(s["colors"], np.float64), r),
    "train_default": lambda m, s, r: m.TrainAugmentation()(dict(s), r),
    "train_full_surface": lambda m, s, r: m.TrainAugmentation(
        flip_in_center=True, point_per_cut=800, max_cut_region=0.3,
        resample_points=0.1, noise_rate=0.2, color_drop_p=0.5,
        volume_augmentations_path=VOL, image_augmentations_path=IMG)(
            dict(s), r),
}


@pytest.mark.parametrize("case", sorted(AUG_CASES))
@pytest.mark.parametrize("seed", [0, 5])
def test_augmentation_bitwise_for_the_same_random_state(case, seed):
    scene = _scene(seed=seed)
    r_port, r_jax = np.random.RandomState(seed), np.random.RandomState(seed)
    got = AUG_CASES[case](aug, scene, r_port)
    want = AUG_CASES[case](jax_aug, scene, r_jax)
    _same(got, want, case)
    # both consumed the same draws
    assert r_port.randint(1 << 30) == r_jax.randint(1 << 30)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    write_mask3d_dataset(str(d), n_scenes=3, seed=4)
    return str(d)


def _datasets(**kw):
    return fd.FreeMaskDataset(**kw), jax_fd.FreeMaskDataset(**kw)


@pytest.mark.parametrize("augment", [False, True])
def test_freemask_dataset_bitwise(data_dir, augment):
    kw = dict(data_dir=data_dir, mode="train", augment=augment, seed=3,
              volume_augmentations_path=VOL, image_augmentations_path=IMG)
    port, ref = _datasets(**kw)
    for i in (0, 2, 1, 0):
        _same(port[i], ref[i], f"scene {i}")
    assert port.rng.randint(1 << 30) == ref.rng.randint(1 << 30)


def _export(data_dir, out_dir, perturb: bool):
    """A round's export for every scene of `data_dir`: clouds (perturbed and
    shuffled when `perturb`, so the merge goes through its KD-tree) and masks
    covering compact uncovered regions."""
    import yaml

    with open(os.path.join(data_dir, "train_database.yaml")) as f:
        db = yaml.safe_load(f)
    os.makedirs(os.path.join(out_dir, "freemasks"), exist_ok=True)
    rng = np.random.RandomState(1)
    for e in db:
        pts = np.load(e["filepath"])
        covered = np.load(e["filepath"].replace(".npy", "_freemasks.npy")
                          ).any(1)
        cloud = pts[:, :3].copy()
        q = [np.percentile(cloud[:, a], v) for a, v in ((0, 30), (1, 30))]
        masks = np.zeros((len(cloud), 3), bool)
        masks[:, 0] = covered
        masks[:, 1] = ~covered & (cloud[:, 0] < q[0]) & (cloud[:, 1] < q[1])
        masks[:, 2] = ~covered & (cloud[:, 0] > q[0])
        if perturb:
            order = rng.permutation(len(cloud))
            cloud = cloud[order] + rng.randn(*cloud.shape) * 1e-3
            masks = masks[order]
        stem = os.path.splitext(os.path.basename(e["filepath"]))[0]
        np.save(os.path.join(out_dir, "freemasks", f"scene{stem}_cloud.npy"),
                cloud.astype(np.float32))
        np.save(os.path.join(out_dir, "freemasks", f"scene{stem}_masks.npy"),
                masks)


@pytest.mark.parametrize("perturb", [False, True], ids=["same-cloud",
                                                          "kdtree"])
def test_self_train_merge_bitwise(data_dir, tmp_path, perturb):
    _export(data_dir, str(tmp_path), perturb)
    kw = dict(data_dir=data_dir, mode="train", augment=False,
              load_self_train_data=True, self_train_data_dir=str(tmp_path),
              num_self_train_data=5)
    port, ref = _datasets(**kw)
    base = fd.FreeMaskDataset(data_dir=data_dir, mode="train", augment=False)
    for i in range(3):
        got = port[i]
        _same(got, ref[i], f"scene {i}")
        assert got["masks"].shape[1] > base[i]["masks"].shape[1]
    assert len(port.merge_found) == 3 and port.merged_instances >= 3


def test_empty_scene_redraw_shares_the_random_state(tmp_path):
    """A scene whose masks the extent filter empties is re-drawn from the
    data set's RandomState, which the augmentations share: the two
    packages' draws stay equal through it."""
    write_mask3d_dataset(str(tmp_path), n_scenes=3, seed=2)
    path = os.path.join(str(tmp_path), "train", "0001_00_freemasks.npy")
    np.save(path, np.zeros_like(np.load(path)))
    kw = dict(data_dir=str(tmp_path), mode="train", seed=0,
              volume_augmentations_path=VOL)
    port, ref = _datasets(**kw)
    for i in (1, 1, 0, 2, 1):
        _same(port[i], ref[i], f"scene {i}")


def test_synthetic_dataset_bitwise():
    port = fd.SyntheticFreeMaskDataset(mode="train", num_scenes=3,
                                       num_points=2000)
    ref = jax_fd.SyntheticFreeMaskDataset(mode="train", num_scenes=3,
                                          num_points=2000)
    for i in (0, 2):
        _same(port[i], ref[i], f"scene {i}")


@pytest.mark.parametrize("n,k", [(7, 3), (8, 8), (5, 12)])
def test_epoch_sampler_draws_equal(n, k):
    a = _EpochSampler(n, np.random.RandomState(42))
    b = JaxSampler(n, np.random.RandomState(42))
    for _ in range(6):
        assert a.next(k) == b.next(k)


@pytest.mark.parametrize("twice", [False, True])
def test_make_crops_equal(twice):
    rng = np.random.RandomState(0)
    n = 500
    scene = dict(xyz=rng.randn(n, 3).astype(np.float32) * 2,
                 features=rng.rand(n, 3).astype(np.float32),
                 segments=rng.randint(0, 20, n), masks=rng.rand(n, 3) > 0.7,
                 labels=rng.randint(0, 2, n),
                 colors=rng.rand(n, 3).astype(np.float32), name="s0")
    got, want = make_crops([scene]), jax_make_crops([scene])
    if twice:
        got, want = make_crops(got), jax_make_crops(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def _batch_equal(got, ref):
    """The port's SceneBatch against a JAX SceneBatch, table by table."""
    for name in ("features", "raw_coords", "point2segment", "seg_valid",
                 "seg_counts", "level_bounds", "fps_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for lv in range(5):
        np.testing.assert_array_equal(got.scene_idx[lv].numpy(),
                                      np.asarray(ref.scene_idx[lv]))
        for name in ("coords", "valid", "nbr_idx", "child_idx"):
            np.testing.assert_array_equal(
                getattr(got.graph.levels[lv], name).numpy(),
                np.asarray(getattr(ref.graph.levels[lv], name)), name)
    for name in ("labels", "valid", "seg_masks", "vox_masks"):
        np.testing.assert_array_equal(getattr(got.target, name).numpy(),
                                      np.asarray(getattr(ref.target, name)),
                                      name)


@pytest.mark.parametrize("accum", [1, 2])
def test_fit_batches_of_one_epoch_equal_jax(data_dir, tmp_path, accum):
    """The scene ids `fit` draws for one epoch and the batches it builds
    from them (through the prefetcher, 3 worker threads) equal the JAX
    Experiment's draws and `_train_batch_from(ids, pads=None)` run in turn
    on a fresh copy of the same data set. Under gradient accumulation the
    JAX package pads its micro-batches to one plan for stacking; the port
    collates each at its own size, so there each micro-batch is held to the
    JAX collator over the JAX data set's scenes, loaded in the same order."""
    from main_instance_segmentation import build_experiment as jax_build
    from main_instance_segmentation import get_parameters as jax_params
    from unscene3d_torch.main_instance_segmentation import (build_experiment,
                                                            get_parameters)
    from unscene3d_torch.train.experiment import Prefetcher

    over = ["data.batch_size=2", "data.voxel_size=0.12",
            "model.hidden_dim=32", "model.num_queries=8", "model.num_heads=2",
            "model.dim_feedforward=64", "model.num_decoders=1",
            "model.backbone._target_=unscene3d_tpu.models.backbone."
            "Res16UNet14A", "general.static_shapes=false",
            f"general.accumulate_grad_batches={accum}",
            f"general.data_dir={data_dir}", "data.num_workers=3"]
    ref = jax_build(jax_params(over + [f"general.save_dir={tmp_path}/j"]))
    exp = build_experiment(get_parameters(
        over + [f"general.save_dir={tmp_path}/t", "general.device=cpu"]))
    s_ref = JaxSampler(len(ref.train_dataset), np.random.RandomState(7))
    s_got = _EpochSampler(len(exp.train_dataset), np.random.RandomState(7))
    n_steps = 3
    ids_ref = [ref._draw_step_ids(s_ref) for _ in range(n_steps)]
    ids_got = [exp._draw_step_ids(s_got) for _ in range(n_steps)]
    assert ids_got == ids_ref
    got = list(Prefetcher(lambda i: exp._load_scenes(ids_got[i]),
                          exp._collate_step, n_steps, num_workers=3))
    for i in range(n_steps):
        assert len(got[i]) == accum
        if accum == 1:
            _batch_equal(got[i][0], ref._train_batch_from(ids_ref[i],
                                                          pads=None))
            continue
        for m, ids in enumerate(ids_ref[i]):
            scenes = [ref.train_dataset[j] for j in ids]
            _batch_equal(got[i][m], ref.collator(scenes)[0])
    assert exp.train_dataset.rng.randint(1 << 30) == \
        ref.train_dataset.rng.randint(1 << 30)
