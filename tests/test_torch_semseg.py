"""The supervised path of the port: `SemanticSegmentationDataset` /
`LidarDataset` (unscene3d_torch/data/semseg_dataset.py) and
`ConfusionMatrix` (eval/metrics.py) against the JAX modules, one f32 train
step on a multi-class batch against the JAX `Trainer._step_core`, and the
entry point under scripts/scannet/scannet_val.sh's overrides on the CPU.

The data are Mask3D npy directories written by
`data/synthetic.write_mask3d_scenes`. Tolerances:
  * data set items, confusion matrices, IoU: equal (bitwise, dtypes too);
  * the train step (labels 0..18, num_classes=20, the tiny model of
    tests/test_torch_train.py): losses rel 1e-5; gradients atol 2e-5 +
    rtol 2e-4 of each tensor's largest entry; updated params and BatchNorm
    running statistics rtol 2e-4 / atol 2e-5, the keys' biases within two
    learning rates (tests/test_torch_train.py's tolerances and reasons).
    The loss and the gradients are taken under the JAX step's matching;
    the port's own matching is held to it on the step's distinguishable
    prediction sets.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_jax import one_torch_thread, random_bn  # noqa: F401
from unscene3d_tpu.data import semseg_dataset as jsemseg
from unscene3d_tpu.eval import metrics as jmetrics
from unscene3d_torch.config import instantiate, load_config
from unscene3d_torch.config.loader import _resolve_target
from unscene3d_torch.data import semseg_dataset as psemseg
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import write_mask3d_scenes
from unscene3d_torch.eval import metrics as pmetrics
from unscene3d_torch.main_instance_segmentation import (build_experiment,
                                                        get_parameters)
from unscene3d_torch.models.weights import (load_flax_variables,
                                            torch_params_from_flax,
                                            torch_state_from_flax)
from unscene3d_torch.train.loop import build_trainer, make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(ROOT, "conf")
RTOL, ATOL = 2e-4, 2e-5
LR, STEPS = 1e-4, 20
NUM_CLASSES = 20
TINY = dict(num_classes=NUM_CLASSES, hidden_dim=32, num_queries=10,
            num_heads=2, dim_feedforward=64, num_decoders=1,
            hlevels=(0, 1, 2, 3), sample_sizes=(4096,) * 5)
VOXEL = 0.06
# scripts/scannet/scannet_val.sh
SCANNET_VAL = ["general.experiment_name=scannet_val",
               "general.eval_on_segments=true",
               "general.train_on_segments=true",
               'general.project_name="mask3d"', "data/datasets=scannet",
               "general.num_targets=19", "data.num_labels=20",
               "general.resume=True"]
TINY_OVERRIDES = [
    "data.batch_size=2", "data.voxel_size=0.12", "model.hidden_dim=32",
    "model.num_queries=8", "model.num_heads=2", "model.dim_feedforward=64",
    "model.num_decoders=1", "model.sample_sizes=[16,32,64,128,256]",
    "model.backbone._target_=unscene3d_tpu.models.backbone.Res16UNet14A",
    "trainer.max_epochs=1", "general.device=cpu"]


def _equal(a, b, path="scene"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    else:
        assert a == b, (path, a, b)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scannet"))
    # ScanNet20 class indices 0..17: 0 (wall) and 1 (floor) are the ones
    # conf/data/datasets/scannet.yaml filters; 2..17 fit its 19-way head
    write_mask3d_scenes(d, {"train": 3, "validation": 1}, num_points=1500,
                        num_objects=6, class_ids=tuple(range(18)), seed=5)
    return d


@pytest.mark.parametrize("kind,kw", [
    ("SemanticSegmentationDataset", dict(mode="validation")),
    ("SemanticSegmentationDataset", dict(mode="train")),
    ("SemanticSegmentationDataset", dict(
        mode="train", instance_oversampling=1.0, place_around_existing=True,
        add_unlabeled_pc=True, filter_out_classes=(0, 1), label_offset=2)),
    ("SemanticSegmentationDataset", dict(
        mode="validation", task="semantic_segmentation", add_normals=True)),
    ("SemanticSegmentationDataset", dict(mode="train", add_colors=False,
                                         filter_out_classes=(255, 3))),
    ("LidarDataset", dict(mode="train")),
], ids=["val", "train", "oversample_unlabeled", "semantic_normals",
        "no_colors", "lidar"])
def test_dataset_equals_jax(data_dir, kind, kw):
    """Every scene twice (the second pass draws on from the first's state),
    bitwise."""
    jd = getattr(jsemseg, kind)(data_dir=data_dir, seed=3, **kw)
    pd = getattr(psemseg, kind)(data_dir=data_dir, seed=3, **kw)
    assert len(jd) == len(pd)
    for _ in range(2):
        for i in range(len(jd)):
            _equal(jd[i], pd[i], f"{kind}[{i}]")


def test_dataset_reseed_restarts_the_draws(data_dir):
    pd = psemseg.SemanticSegmentationDataset(data_dir=data_dir, mode="train")
    first = pd[0]
    pd.reseed(0)
    _equal(first, pd[0])
    assert pd.scene_sizes() == [len(np.load(e["filepath"])) for e in pd.data]


def test_confusion_matrix_and_iou_equal_jax():
    r = np.random.RandomState(0)
    target = r.randint(0, 6, 500)
    target[:40] = 255
    pred = r.randint(-1, 7, 500)
    jc, pc = jmetrics.ConfusionMatrix(6), pmetrics.ConfusionMatrix(6)
    for _ in range(2):
        jc.add(pred, target)
        pc.add(pred, target)
    _equal(jc.value(), pc.value())
    for ignore in (None, 2, [0, 5]):
        _equal(jmetrics.iou_from_confusion(jc.value(), ignore),
               pmetrics.iou_from_confusion(pc.value(), ignore))
    pc.reset()
    assert not pc.value().any()


def test_every_dataset_and_metric_target_is_the_ports():
    """conf/data/datasets/*.yaml and conf/metrics/miou.yaml resolve to
    unscene3d_torch classes."""
    import yaml

    targets = []
    for sub in ("data/datasets", "metrics"):
        for name in sorted(os.listdir(os.path.join(CONF, sub))):
            with open(os.path.join(CONF, sub, name)) as f:
                node = yaml.safe_load(f)
            nodes = [node] + [v for v in node.values() if isinstance(v, dict)]
            targets += [n["_target_"] for n in nodes if "_target_" in n]
    assert sum("SemanticSegmentationDataset" in t for t in targets) == 21
    assert sum("LidarDataset" in t for t in targets) == 3
    for t in targets:
        assert _resolve_target(t).__module__.startswith("unscene3d_torch."), t
    cfg = load_config(os.path.join(CONF, "config_base_instance_segmentation"
                                   ".yaml"), SCANNET_VAL)
    cm = instantiate(cfg.metrics)
    assert isinstance(cm, pmetrics.ConfusionMatrix) and cm.num_classes == 19


def test_scannet_val_entry_point_takes_a_step(data_dir, tmp_path):
    """scannet_val.sh's overrides through the port's entry point on the CPU:
    the three data sets are the port's, the targets carry several classes,
    one step has finite losses, and an evaluation with
    general.save_visualizations writes the scene's files."""
    cfg = get_parameters(SCANNET_VAL + TINY_OVERRIDES + [
        f"general.data_dir={data_dir}", f"general.save_dir={tmp_path}/run",
        "general.save_visualizations=true"])
    exp = build_experiment(cfg)
    try:
        for ds in (exp.train_dataset, exp.validation_dataset,
                   exp.test_dataset):
            assert type(ds) is psemseg.SemanticSegmentationDataset
        assert exp.model.num_classes == 19
        (batch,) = exp._collate_step(exp._load_scenes([[0, 1]]))
        labels = batch.target.labels[batch.target.valid]
        assert len(torch.unique(labels)) > 1 and int(labels.min()) >= 2
        losses = exp.trainer.train_step(batch,
                                        torch.Generator().manual_seed(0))
        res = exp.evaluate(exp.validation_dataset, max_scenes=1,
                           with_boxes=False)
    finally:
        exp.close()
    for key in ("loss_ce", "loss_mask", "loss_dice", "total"):
        assert torch.isfinite(losses[key]).all(), key
    assert exp.trainer.step == 1 and np.isfinite(res["all_ap"])
    files = sorted(os.listdir(f"{tmp_path}/run/visualizations"))
    assert files == ["scene0003_00.html", "scene0003_00_instances.ply",
                     "scene0003_00_rgb.ply", "scene0003_00_segments.ply"] \
        or files == ["scene0003_00.html", "scene0003_00_rgb.ply",
                     "scene0003_00_segments.ply"], files


def test_labels_outside_the_head_raise(tmp_path):
    """Raw nyu40 ids (up to 39) under scannet.yaml's label_offset 0 overflow
    the 19-way head: the experiment refuses the batch (the JAX package's
    loss would be NaN)."""
    d = str(tmp_path / "raw")
    write_mask3d_scenes(d, {"train": 2, "validation": 1}, num_points=1500,
                        num_objects=4, class_ids=(24, 33, 39), seed=1)
    cfg = get_parameters(SCANNET_VAL + TINY_OVERRIDES + [
        f"general.data_dir={d}", f"general.save_dir={tmp_path}/run"])
    exp = build_experiment(cfg)
    try:
        with pytest.raises(ValueError, match="outside the model's 19"):
            exp._collate_step(exp._load_scenes([[0, 1]]))
    finally:
        exp.close()


# ------------------------------------------------- multi-class train step
class _Pinned:
    """A matcher that answers with given indices (the JAX step's)."""

    def __init__(self, matched):
        self.matched = torch.from_numpy(np.array(matched)).long()

    def __call__(self, *args):
        return self.matched


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("multiclass"))
    write_mask3d_scenes(d, {"validation": 2}, num_points=1500,
                        num_objects=6, class_ids=tuple(range(19)), seed=11)
    jd = jsemseg.SemanticSegmentationDataset(data_dir=d, mode="validation")
    pd = psemseg.SemanticSegmentationDataset(data_dir=d, mode="validation")
    js, ps = [jd[i] for i in range(2)], [pd[i] for i in range(2)]
    for a, b in zip(js, ps):
        _equal(a, b)
    labels = np.concatenate([s["mask_labels"] for s in ps])
    assert len(np.unique(labels)) >= 6 and labels.max() <= 18
    return js, ps


@pytest.fixture(scope="module")
def jax_step(scenes):
    """One JAX `Trainer._step_core` from the JAX init (random BN state):
    matched indices, losses, gradients (from Adam's first moment) and the
    state after the update."""
    from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
    from unscene3d_tpu.losses.criterion import SetCriterion as JaxCriterion
    from unscene3d_tpu.losses.matcher import HungarianMatcher as JaxMatcher
    from unscene3d_tpu.models.backbone import Res16UNet14A
    from unscene3d_tpu.models.mask3d import Mask3D as JaxMask3D
    from unscene3d_tpu.train.loop import Trainer as JaxTrainer
    from unscene3d_tpu.train.loop import TrainState
    from unscene3d_tpu.train.loop import make_optimizer as jax_opt

    batch, _ = JaxCollator(voxel_size=VOXEL, fps_queries=10)(scenes[0])
    model = JaxMask3D(backbone=Res16UNet14A(out_channels=2), **TINY)
    criterion = JaxCriterion(matcher=JaxMatcher(solver="scipy"),
                             num_classes=NUM_CLASSES)
    trainer = JaxTrainer(model, criterion, jax_opt(lr=LR, total_steps=STEPS))
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        b, train=False, is_eval=True))(batch)
    variables = random_bn(variables)
    variables["params"]["query_proj_1"]["kernel"] *= 8.0
    rng = jax.random.PRNGKey(0)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       buffers=variables["buffers"],
                       opt_state=trainer.tx.init(variables["params"]))

    @jax.jit
    def step(state, batch):
        v = {"params": state.params, "batch_stats": state.batch_stats,
             "buffers": state.buffers}
        outputs, _ = model.apply(v, batch, train=True, rngs={"sample": rng},
                                 mutable=["batch_stats"])
        matched = criterion.matcher(outputs["pred_logits"],
                                    outputs["pred_masks_seg"], batch.target,
                                    "segment_mask", batch.seg_valid)
        new, losses = trainer._step_core(state, batch, rng, None)
        return matched, new, losses

    matched, new, losses = step(state, batch)
    mu, mu0 = new.opt_state[0].mu, state.opt_state[0].mu
    grads = jax.tree.map(lambda m, m0: ((np.float64(m) - 0.9 * np.float64(
        m0)) / 0.1).astype(np.float32), mu, mu0)
    return variables, jax.tree.map(np.asarray, dict(
        matched=matched, losses=losses, grads=grads, params=new.params,
        batch_stats=new.batch_stats))


@pytest.fixture(scope="module")
def torch_step(scenes, jax_step):
    variables, ref = jax_step
    batch, _ = FreeMaskCollator(voxel_size=VOXEL, fps_queries=10)(scenes[1])
    trainer = build_trainer(torch.float32, seed=None, backbone="Res16UNet14A",
                            lr=LR, total_steps=STEPS, solver="scipy",
                            device="cpu", **TINY)
    load_flax_variables(trainer.model, variables)
    gen = torch.Generator().manual_seed(0)
    criterion = trainer.criterion
    with torch.no_grad():
        o = trainer.model(batch, gen)
        own = criterion.matcher(o["pred_logits"], o["pred_masks_seg"],
                                batch.target, batch.seg_valid)
        t = batch.target
        L = o["pred_logits"].shape[0]
        cost = criterion.matcher.cost_matrix(
            o["pred_logits"], o["pred_masks_seg"],
            t.labels[None].expand(L, -1, -1),
            t.seg_masks[None].float().expand(L, -1, -1, -1),
            t.valid[None].expand(L, -1, -1),
            batch.seg_valid[None].expand(L, -1, -1))
    trainer.criterion = dataclasses.replace(
        criterion, matcher=_Pinned(ref["matched"]))
    names = [n for n, _ in trainer.model.named_parameters()]
    losses, grads = trainer.loss_and_grads(batch, gen)
    trainer.optimizer.step(trainer.params, grads)
    for bn in trainer._bns:
        bn.update_running_stats()
    return dict(matched=own.numpy(), cost=cost.numpy(), losses=losses,
                grads=dict(zip(names, grads)),
                state={k: v.clone()
                       for k, v in trainer.model.state_dict().items()},
                labels=t.labels[t.valid].numpy())


def test_multiclass_step_matching_and_losses_match_jax(jax_step, torch_step):
    ref, got = jax_step[1], torch_step
    assert len(np.unique(got["labels"])) >= 6
    cost = got["cost"]                                    # (L, B, Q, T)
    distinct = np.ptp(cost, axis=2).max(axis=-1) > 1e-4   # (L, B)
    assert distinct.sum() >= distinct.size - distinct.shape[1]
    np.testing.assert_array_equal(got["matched"][distinct],
                                  ref["matched"][distinct])
    for key in ("loss_ce", "loss_mask", "loss_dice", "total", "num_masks"):
        np.testing.assert_allclose(got["losses"][key].detach().numpy(),
                                   ref["losses"][key], rtol=1e-5, atol=0,
                                   err_msg=key)


def test_multiclass_step_gradients_match_jax(jax_step, torch_step):
    ref = torch_params_from_flax(jax_step[1]["grads"])
    got = torch_step["grads"]
    assert set(ref) == set(got)
    for name, g in got.items():
        r = ref[name].numpy()
        err = np.abs(g.numpy() - r).max()
        assert err <= ATOL + RTOL * np.abs(r).max(), (name, err)


def test_multiclass_step_params_match_jax(jax_step, torch_step):
    ref = torch_state_from_flax({"params": jax_step[1]["params"],
                                 "batch_stats": jax_step[1]["batch_stats"]})
    got = torch_step["state"]
    noise_bound = ATOL + 2 * make_optimizer(lr=LR,
                                            total_steps=STEPS).schedule(0)
    for name, v in ref.items():
        if name.endswith("k_proj.bias"):
            assert (got[name] - v).abs().max() <= noise_bound, name
        else:
            np.testing.assert_allclose(got[name].numpy(), v.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
