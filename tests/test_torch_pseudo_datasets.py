"""The port's pseudo-mask data sets and transforms
(unscene3d_torch/data/pseudo_datasets.py, pseudo_transforms.py) against the
JAX modules, on the fixtures of tests/test_pseudo_datasets.py.

The JAX transforms draw from the global `random` and `np.random` states;
the port's from one `HostRandom`. Each case seeds both globals and the
port's generator alike and expects every array equal, bitwise, dtype
included (loaders at num_workers=0).
"""

import random

import numpy as np
import pytest

import tests.test_pseudo_datasets as jt
from unscene3d_tpu.data import pseudo_datasets as jds
from unscene3d_tpu.data import pseudo_transforms as jtf
from unscene3d_tpu.data.ply import write_ply
from unscene3d_torch.data import pseudo_datasets as pds
from unscene3d_torch.data import pseudo_transforms as ptf


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _equal(a, b, path="item"):
    """Recursive bitwise equality of dicts / sequences / arrays."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        assert np.array_equal(a, b, equal_nan=True), path
    else:
        assert a == b, (path, a, b)


def _cloud(n=600, seed=0):
    r = np.random.RandomState(seed)
    coords = r.rand(n, 3) * np.array([4.0, 3.0, 2.0])
    feats = r.rand(n, 3) * 255
    return coords, feats, np.arange(n)


TRANSFORMS = {
    "ChromaticTranslation": lambda m, **k: m.ChromaticTranslation(0.1, **k),
    "ChromaticAutoContrast": lambda m, **k: m.ChromaticAutoContrast(**k),
    "ChromaticAutoContrast_fixed": lambda m, **k: m.ChromaticAutoContrast(
        randomize_blend_factor=False, **k),
    "ChromaticJitter": lambda m, **k: m.ChromaticJitter(0.05, **k),
    "HueSaturationTranslation": lambda m, **k: m.HueSaturationTranslation(
        0.5, 0.2, **k),
    "RandomDropout": lambda m, **k: m.RandomDropout(0.6, **k),
    "RandomHorizontalFlip": lambda m, **k: m.RandomHorizontalFlip(
        "z", False, **k),
    "ElasticDistortion": lambda m, **k: m.ElasticDistortion(
        ((0.2, 0.4), (0.8, 1.6)), **k),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_equals_jax(name):
    """Ten calls in a row from one seed (the gates fire and miss)."""
    make = TRANSFORMS[name]
    coords, feats, idx = _cloud()
    _seed(7)
    jtr = make(jtf)
    want = [jtr(coords.copy(), feats.copy(), idx.copy()) for _ in range(10)]
    ptr = make(ptf, rng=ptf.HostRandom(7))
    got = [ptr(coords.copy(), feats.copy(), idx.copy()) for _ in range(10)]
    _equal(want, got, name)


def test_hsv_conversions_equal_jax():
    rgb = np.random.RandomState(3).randint(0, 256, (400, 3)).astype(float)
    rgb[:5] = [[0, 0, 0], [255, 255, 255], [10, 10, 10], [255, 0, 0],
               [0, 255, 0]]
    hsv = ptf.rgb_to_hsv(rgb)
    _equal(jtf.rgb_to_hsv(rgb), hsv)
    _equal(jtf.hsv_to_rgb(hsv), ptf.hsv_to_rgb(hsv))


@pytest.mark.parametrize("clip", [None, 1.5, ((-1.0, 1.0), (-1.0, 0.5),
                                              (-2.0, 2.0))])
def test_voxelizer_equals_jax(clip):
    coords, feats, _ = _cloud(900, 1)
    kw = dict(voxel_size=0.05, clip_bound=clip, use_augmentation=True,
              scale_augmentation_bound=(0.9, 1.1),
              rotation_augmentation_bound=((-np.pi / 64, np.pi / 64), None,
                                           (-np.pi, np.pi)),
              translation_augmentation_ratio_bound=((-0.2, 0.2), (-0.2, 0.2),
                                                    (0, 0)))
    _seed(11)
    jv = jtf.Voxelizer(**kw)
    want = [jv.voxelize(coords, feats) for _ in range(3)]
    pv = ptf.Voxelizer(**kw, rng=ptf.HostRandom(11))
    _equal(want, [pv.voxelize(coords, feats) for _ in range(3)])


def _stack(m, rng_kw):
    return dict(
        prevoxel_transform=m.Compose([m.ElasticDistortion(
            ((0.2, 0.4), (0.8, 1.6)), **rng_kw)]),
        input_transform=m.Compose([
            m.RandomDropout(0.2, **rng_kw),
            m.RandomHorizontalFlip("z", False, **rng_kw),
            m.ChromaticAutoContrast(**rng_kw),
            m.ChromaticTranslation(0.1, **rng_kw),
            m.ChromaticJitter(0.05, **rng_kw),
            m.HueSaturationTranslation(0.5, 0.2, **rng_kw)]))


@pytest.mark.parametrize("augment", [False, True])
def test_scene_preparer_equals_jax(augment):
    """The preparer with its camera poses; with augmentation the whole
    transform stack of `initialize_data_loader` on one generator."""
    coords, feats, _ = _cloud(800, 2)
    n = len(coords)
    labels = np.random.RandomState(4).randint(0, 20, n)
    inst = np.random.RandomState(5).randint(-1, 6, n)
    segs = np.random.RandomState(6).randint(0, 30, (n, 2))
    poses = np.stack([np.eye(4)] * 2)
    poses[1, :3, 3] = [0.5, -0.3, 1.0]
    kw = dict(voxel_size=0.05, use_augmentation=augment,
              prevoxelization_voxel_size=0.02 if augment else None,
              label_mapper=(lambda x: x % 7) if augment else None)
    _seed(13)
    jp = jds.ScenePreparer(**kw, **(_stack(jtf, {}) if augment else {}))
    want = [jp(coords, feats, labels, inst, poses, segs) for _ in range(2)]
    rng = ptf.HostRandom(13)
    pp = pds.ScenePreparer(**kw, rng=rng,
                           **(_stack(ptf, {"rng": rng}) if augment else {}))
    _equal(want, [pp(coords, feats, labels, inst, poses, segs)
                  for _ in range(2)])


@pytest.mark.parametrize("oracle", [False, True])
def test_scannet_free_dataset_equals_jax(tmp_path, oracle):
    masks_dir, insseg = jt._make_freemask_fixture(tmp_path)
    kw = dict(masks_path=masks_dir, scannet_insseg_path=insseg,
              phase="train", oracle_mode=oracle)
    jd = jds.ScanNetFreeDataset(**kw, preparer=jds.ScenePreparer(
        voxel_size=0.05))
    pd = pds.ScanNetFreeDataset(**kw, preparer=pds.ScenePreparer(
        voxel_size=0.05))
    _equal(jd.load_unsupervised_scene("scene0000_00"),
           pd.load_unsupervised_scene("scene0000_00"))
    _equal(jd[0], pd[0])
    # the SOLO-style grid targets over the scene's own points
    coords, _, labels, inst, _ = jd.load_unsupervised_scene("scene0000_00")
    segs = np.stack([np.arange(len(coords)) // 40,
                     np.arange(len(coords)) // 90], 1)
    _equal(jd.generate_grid_targets(coords, labels, inst, segs),
           pd.generate_grid_targets(coords, labels, inst, segs))


def test_scannet_free_val_phase_defaults_to_oracle(tmp_path):
    masks_dir, insseg = jt._make_freemask_fixture(tmp_path)
    (tmp_path / "insseg" / "val.txt").write_text("scene0000_00\n")
    kw = dict(masks_path=masks_dir, scannet_insseg_path=insseg, phase="val")
    pd = pds.ScanNetFreeDataset(**kw)
    assert pd.oracle_mode and jds.ScanNetFreeDataset(**kw).oracle_mode
    _equal(jds.ScanNetFreeDataset(**kw)[0], pd[0])


def _arkit_dir(tmp_path):
    rng = np.random.RandomState(13)
    xs, ys = np.meshgrid(np.arange(12), np.arange(12))
    verts = np.column_stack([xs.ravel(), ys.ravel(),
                             rng.rand(144) * 0.3]).astype(np.float32)
    verts = np.vstack([verts, [[50, 50, 50]]])  # unreferenced
    faces = []
    for i in range(11):
        for j in range(11):
            a = i * 12 + j
            faces += [[a, a + 1, a + 12], [a + 1, a + 13, a + 12]]
    colors = rng.randint(0, 255, (145, 3))
    write_ply(str(tmp_path / "ark0001.ply"), verts, colors,
              np.asarray(faces, np.int32))
    return str(tmp_path)


def test_arkit_dataset_equals_jax(tmp_path):
    """Two thresholds: only the LAST one's segment validity filters the
    vertices (the reference's quirk, kept by both)."""
    root = _arkit_dir(tmp_path)
    kw = dict(phase="train", segments_min_vert_nums=(5, 15))
    jd = jds.ARKitPseudoDataset(root, **kw,
                                preparer=jds.ScenePreparer(voxel_size=0.5))
    pd = pds.ARKitPseudoDataset(root, **kw,
                                preparer=pds.ScenePreparer(voxel_size=0.5))
    _equal(jd.load_scene_data(0), pd.load_scene_data(0))
    _equal(jd[0], pd[0])


@pytest.mark.parametrize("phase", ["val", "train"])
def test_stanford_dataset_equals_jax(tmp_path, phase):
    rng = np.random.RandomState(17)
    for area in ("area1", "area5"):
        (tmp_path / area).mkdir()
        n = 500
        write_ply(str(tmp_path / area / "office_1.ply"),
                  rng.rand(n, 3).astype(np.float32) * 9, rng.randint(
                      0, 255, (n, 3)), None,
                  extra={"label": rng.randint(0, 14, n),
                         "instance_id": rng.randint(0, 5, n),
                         "segment_id": rng.randint(0, 30, n)})
    # the train phase clips at CLIP_BOUND with the translation draw
    _seed(19)
    jd = jds.StanfordPseudoDataset(str(tmp_path), phase=phase,
                                   augment_data=True)
    want = jd[0]
    pd = pds.StanfordPseudoDataset(str(tmp_path), phase=phase,
                                   augment_data=True, rng=ptf.HostRandom(19))
    _equal(want, pd[0])


def test_inf_sampler_and_loader_equal_jax():
    for shuffle in (False, True):
        js = jds.InfSampler(list(range(7)), shuffle=shuffle, seed=3)
        ps = pds.InfSampler(list(range(7)), shuffle=shuffle, seed=3)
        assert [next(js) for _ in range(20)] == [next(ps) for _ in range(20)]

    class _DS:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            return {"i": i}

    for kw in (dict(shuffle=True), dict(shuffle=False),
               dict(repeat=True, shuffle=True)):
        jl = iter(jds.PseudoDataLoader(_DS(), batch_size=3, seed=1, **kw))
        pl = iter(pds.PseudoDataLoader(_DS(), batch_size=3, seed=1, **kw))
        n = 5 if kw.get("repeat") else 3
        assert ([next(jl) for _ in range(n)] == [next(pl) for _ in range(n)])
    assert pds.load_dataset("Stanford5cmPseudoDataset") is \
        pds.StanfordPseudoDataset
    with pytest.raises(KeyError):
        pds.load_dataset("nope")


def test_initialize_data_loader_equals_jax(tmp_path):
    """The reference's whole transform stack through the loader factory,
    two epochs' worth of items from one seed."""
    rng = np.random.RandomState(19)
    (tmp_path / "area1").mkdir()
    for k in range(2):
        n = 400
        write_ply(str(tmp_path / "area1" / f"conf_{k}.ply"),
                  rng.rand(n, 3).astype(np.float32) * 3,
                  rng.randint(0, 255, (n, 3)), None,
                  extra={"label": rng.randint(0, 10, n),
                         "instance_id": rng.randint(0, 4, n),
                         "segment_id": rng.randint(0, 20, n)})
    kw = dict(phase="train", num_workers=0, shuffle=True, repeat=True,
              augment_data=True, batch_size=1,
              dataset_kwargs=dict(data_root=str(tmp_path)), seed=2)
    _seed(23)
    jl = iter(jds.initialize_data_loader(
        jds.load_dataset("StanfordPseudoDataset"), **kw))
    want = [next(jl) for _ in range(4)]
    pl = iter(pds.initialize_data_loader(
        pds.load_dataset("StanfordPseudoDataset"), **kw,
        rng=ptf.HostRandom(23)))
    _equal(want, [next(pl) for _ in range(4)])
