"""The port's Experiment side of the self-training round against the JAX
package's.

  * checkpoints: a round trip is bitwise (every parameter, BatchNorm
    statistic and buffer, AdamW's moments and count, the step);
    `restore_partial` keeps a class head whose shape changed; `fit` resumes
    at the saved step;
  * loggers: CSV and JSONL bytes equal to the JAX package's; TensorBoard
    events decoded by the port's reader equal to the JAX logger's;
  * the slice as a whole: at tests/test_self_train_cycle.py's tiny
    overrides, the JAX `Experiment.evaluate` on its init state and the
    port's `Experiment.evaluate` with those weights give the same classes,
    scores within rtol 1e-5 and the same masks (mismatches allowed only in
    segments holding a voxel where JAX's logit is below 1e-4 in magnitude:
    counted and printed, 0 expected), and AP dicts equal to 1e-6. The JAX
    state is initialised and its eval steps compiled once per module;
  * the port's own round cycle on the CPU through its entry point: round 1
    fit, export, round 2 with the merge and the round-1 checkpoint.
"""

import os

import numpy as np
import pytest
import torch

from tests._torch_jax import np_tree, one_torch_thread  # noqa: F401
from tests.test_datasets import write_mask3d_dataset
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.models.weights import load_flax_variables
from unscene3d_torch.train import checkpoint as ckpt
from unscene3d_torch.train.loop import build_trainer

TINY_MODEL = dict(num_classes=3, hidden_dim=32, num_queries=10, num_heads=2,
                  dim_feedforward=64, num_decoders=1, hlevels=(0, 1, 2, 3),
                  sample_sizes=(4096,) * 5)
VOXEL = 0.06
# tests/test_self_train_cycle.py:tiny_cfg_overrides
CYCLE = ["data.batch_size=2", "data.voxel_size=0.12", "model.hidden_dim=32",
         "model.num_queries=8", "model.num_heads=2",
         "model.dim_feedforward=64", "model.num_decoders=1",
         "model.sample_sizes=[16,32,64,128,256]",
         "model.backbone._target_=unscene3d_tpu.models.backbone."
         "Res16UNet14A", "trainer.max_epochs=1",
         "trainer.check_val_every_n_epoch=5"]


def _tiny_trainer(seed, **kw):
    return build_trainer(torch.float32, seed=seed, backbone="Res16UNet14A",
                         lr=1e-3, total_steps=10, solver="scipy",
                         device="cpu", **dict(TINY_MODEL, **kw))


@pytest.fixture(scope="module")
def tiny_batch():
    scenes = [make_scene(1500, seed=0), make_scene(1500, seed=3)]
    return FreeMaskCollator(voxel_size=VOXEL, fps_queries=10)(scenes)[0]


def _state_equal(a, b):
    assert a["step"] == b["step"]
    assert set(a["model"]) == set(b["model"])
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["count"] == ob["count"]
    for x, y in zip(oa["mu"] + oa["nu"], ob["mu"] + ob["nu"]):
        assert torch.equal(x, y)


def test_checkpoint_round_trip_is_bitwise(tiny_batch, tmp_path):
    tr = _tiny_trainer(0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        tr.train_step(tiny_batch, gen)
    path = ckpt.save_checkpoint(str(tmp_path / "c"), tr)
    assert path.endswith(os.sep + "2") and ckpt.latest_step(
        str(tmp_path / "c")) == 2
    assert not [f for f in os.listdir(tmp_path / "c") if "tmp" in f]
    fresh = _tiny_trainer(1)
    ckpt.restore_checkpoint(str(tmp_path / "c"), fresh)
    _state_equal(fresh.state_dict(), tr.state_dict())
    # the BN running statistics moved and came across
    assert any(not torch.equal(bn.mean, torch.zeros_like(bn.mean))
               for bn in fresh._bns)
    # a second save of the same step replaces the first
    tr.step = 2
    ckpt.save_checkpoint(str(tmp_path / "c"), tr)
    assert sorted(os.listdir(tmp_path / "c")) == ["2"]
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), fresh)


def test_restore_partial_keeps_a_resized_class_head(tiny_batch, tmp_path):
    tr = _tiny_trainer(0)
    tr.train_step(tiny_batch, torch.Generator().manual_seed(0))
    ckpt.save_checkpoint(str(tmp_path / "c"), tr)
    other = _tiny_trainer(5, num_classes=4)
    before = {k: v.clone() for k, v in other.model.state_dict().items()}
    ckpt.restore_partial(str(tmp_path / "c"), other, verbose=False)
    saved = tr.model.state_dict()
    for k, v in other.model.state_dict().items():
        if k.startswith("class_embed_head."):
            assert v.shape != saved[k].shape and torch.equal(v, before[k])
        else:
            assert torch.equal(v, saved[k]), k
    assert other.step == 0 and other.optimizer.count == 0
    assert all(not m.any() for m in other.optimizer.mu)


def test_load_with_same_shape_missing_and_resized():
    t = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    out = ckpt.load_with_same_shape(t, {"a": torch.ones(2),
                                        "b": torch.ones(4)})
    assert torch.equal(out["a"], torch.ones(2))
    assert torch.equal(out["b"], torch.zeros(3))
    assert torch.equal(out["c"], torch.zeros(1))


# ----------------------------------------------------------------- loggers
ROWS = [{"epoch": 0, "loss_total": np.float32(1.5), "epoch_seconds": 2.25,
         "train_loss_ce": 0.5, "train_loss_ce_aux0": np.float64(0.75)},
        {"epoch": 0, "val_mean_ap": 0.125, "val_mean_ap_50": 0.25,
         "val_box_ap_25": 0.0},
        {"epoch": 1, "loss_total": 1.25, "epoch_seconds": 2.5,
         "train_num_masks": 8.0, "mode": "train"}]


@pytest.mark.parametrize("kind", ["CSVLogger", "JSONLLogger"])
def test_file_loggers_write_the_same_bytes(tmp_path, kind):
    from unscene3d_tpu.train import experiment as jax_exp
    from unscene3d_torch.train import experiment as port_exp

    a = getattr(port_exp, kind)(str(tmp_path / "port"))
    b = getattr(jax_exp, kind)(str(tmp_path / "jax"))
    for row in ROWS:
        a.log(dict(row))
        b.log(dict(row))
    with open(a.path, "rb") as fa, open(b.path, "rb") as fb:
        assert fa.read() == fb.read()


def test_tensorboard_events_decode_equal(tmp_path):
    from unscene3d_tpu.utils import loggers as jax_loggers
    from unscene3d_torch.utils import loggers

    a = loggers.TensorBoardLogger(str(tmp_path / "port"))
    b = jax_loggers.TensorBoardLogger(str(tmp_path / "jax"))
    for row in ROWS:
        a.log(dict(row))
        b.log(dict(row))
    ev_a = [loggers.decode_scalar_event(p)
            for p in loggers.read_tfrecords(a.path)]
    ev_b = [loggers.decode_scalar_event(p)
            for p in loggers.read_tfrecords(b.path)]
    assert [(e["step"], e["scalars"]) for e in ev_a] == \
        [(e["step"], e["scalars"]) for e in ev_b]
    assert len(ev_a) == 1 + len(ROWS)
    # the encoders agree byte for byte at one wall time
    scal = {"loss": 1.5, "ap": 0.25}
    assert (loggers.encode_scalar_event(3, 1.0e9, scal)
            == jax_loggers.encode_scalar_event(3, 1.0e9, scal))


def test_build_loggers_offline_group(tmp_path):
    from unscene3d_torch.config import load_config
    from unscene3d_torch.train.experiment import CSVLogger, build_loggers
    from unscene3d_torch.utils.loggers import TensorBoardLogger

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(
        root, "conf", "config_base_instance_segmentation.yaml"),
        [f"general.save_dir={tmp_path}"])
    kinds = [type(lg) for lg in build_loggers(cfg).loggers]
    assert kinds == [TensorBoardLogger, CSVLogger]


# ----------------------------------------------------- the slice as a whole
@pytest.fixture(scope="module")
def cycle_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cycle")
    write_mask3d_dataset(str(d / "data"), n_scenes=2)
    return d


@pytest.fixture(scope="module")
def jax_eval(cycle_data):
    """The JAX Experiment.evaluate on its init state over the validation
    set, its per-scene predictions, and each scene's voxel logits (the
    plain eval step on the same batch)."""
    from main_instance_segmentation import build_experiment, get_parameters

    d = cycle_data
    exp = build_experiment(get_parameters(CYCLE + [
        f"general.data_dir={d}/data", f"general.save_dir={d}/jax",
        "general.static_shapes=false", "general.eval_min_region_size=10"]))
    state = exp.trainer.init_state(exp._example_batch(), seed=42,
                                   jit_init=True)
    per_scene = {}
    post = exp._eval_postprocess_scene

    def recorded(out, batch, meta, *rest):
        res = post(out, batch, meta, *rest)
        per_scene[res[0]] = res[1]
        return res

    exp._eval_postprocess_scene = recorded
    results = exp.evaluate(state, exp.validation_dataset)
    step = exp.trainer.build_eval_step()
    logits = {}
    for i in range(len(exp.validation_dataset)):
        batch, meta = exp.eval_collator([exp.validation_dataset[i]])
        out = step(state, batch)
        n = meta.num_voxels[0]
        logits[meta.scene_names[0]] = (
            np.asarray(out["pred_masks_vox"][-1][:n]), meta)
    variables = {"params": np_tree(state.params),
                 "batch_stats": np_tree(state.batch_stats),
                 "buffers": np_tree(state.buffers)}
    return variables, results, per_scene, logits


def _port_experiment(d, *extra):
    from unscene3d_torch.main_instance_segmentation import (build_experiment,
                                                            get_parameters)

    return build_experiment(get_parameters(CYCLE + [
        f"general.data_dir={d}/data", "general.device=cpu"] + list(extra)))


def test_evaluate_matches_jax(cycle_data, jax_eval):
    variables, ref, ref_scene, logits = jax_eval
    exp = _port_experiment(cycle_data, f"general.save_dir={cycle_data}/port",
                           "general.eval_min_region_size=10")
    load_flax_variables(exp.model, variables)
    per_scene = {}
    post = exp._eval_postprocess_scene

    def recorded(*args):
        res = post(*args)
        per_scene[res[0]] = res[1]
        return res

    exp._eval_postprocess_scene = recorded
    got = exp.evaluate(exp.validation_dataset)
    assert set(per_scene) == set(ref_scene) and len(per_scene) == 2
    near_total = 0
    for name, want in ref_scene.items():
        p = per_scene[name]
        np.testing.assert_array_equal(p["classes"], want["classes"])
        np.testing.assert_allclose(p["scores"], want["scores"], rtol=1e-5)
        vox, meta = logits[name]
        near = (np.abs(vox) < 1e-4).any(1)             # (n_vox,)
        near_total += int(near.sum())
        seg = meta.original_segments[0]
        loose = np.isin(seg, np.unique(seg[near[meta.inverse_maps[0]]]))
        assert p["masks"].shape == want["masks"].shape
        np.testing.assert_array_equal(p["masks"][~loose],
                                      want["masks"][~loose])
    print(f"voxels with |JAX logit| < 1e-4: {near_total}")
    assert near_total == 0

    def flat(r, pre=""):
        for k, v in r.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + ".")
            else:
                yield pre + k, v

    want, have = dict(flat(ref)), dict(flat(got))
    assert set(want) == set(have)
    for k, v in want.items():
        np.testing.assert_allclose(have[k], v, atol=1e-6, err_msg=k)


def test_round_cycle(cycle_data):
    """test_self_train_cycle.py:test_round_cycle through the port's entry
    point on the CPU: round 1 fits (with one validation), the export writes
    full-resolution boolean masks, round 2 merges them and starts from
    round 1's best checkpoint; a resumed run starts at the saved step."""
    from unscene3d_torch.main_instance_segmentation import main

    d = cycle_data
    base = CYCLE + [f"general.data_dir={d}/data", "general.device=cpu",
                    "trainer.check_val_every_n_epoch=1"]
    r1 = f"{d}/round1"
    tr = main(base + [f"general.save_dir={r1}"])
    assert tr.step == 1
    assert ckpt.latest_step(f"{r1}/best") == 1
    assert ckpt.latest_step(f"{r1}/checkpoints") == 1
    main(base + [f"general.save_dir={r1}", "general.train_mode=false",
                 "general.save_for_freemask=true"])
    exported = sorted(os.listdir(f"{r1}/freemasks"))
    assert exported == ["scene0000_00_cloud.npy", "scene0000_00_masks.npy",
                        "scene0001_00_cloud.npy", "scene0001_00_masks.npy"]
    for i in range(2):
        masks = np.load(f"{r1}/freemasks/scene{i:04d}_00_masks.npy")
        cloud = np.load(f"{r1}/freemasks/scene{i:04d}_00_cloud.npy")
        pts = np.load(f"{d}/data/train/{i:04d}_00.npy")
        assert masks.dtype == bool and masks.shape[0] == len(cloud) == len(pts)
    with open(f"{r1}/metrics.csv") as f:
        header = f.readline().strip().split(",")
    assert {"loss_total", "train_loss_ce", "train_loss_ce_aux0",
            "val_mean_ap_50", "val_box_ap_25"} <= set(header)

    exp2 = _port_experiment(
        d, f"general.save_dir={d}/round2", "optimizer=adamw_lower",
        "data.datasets.train_dataset.load_self_train_data=true",
        f"data.datasets.train_dataset.self_train_data_dir={r1}")
    best = ckpt.load_state(f"{r1}/best")["model"]
    tr2 = exp2.fit(max_epochs=1, checkpoint=f"{r1}/best")
    assert tr2.step == 1
    assert exp2.train_dataset.merge_found == {"0000_00", "0001_00"}
    # round 2 started from round 1's parameters: its one update (lr 5e-5 /
    # 25 at the onecycle's start) moved each by far less than 1e-3
    moved = max((p.detach() - best[k]).abs().max().item()
                for k, p in tr2.model.named_parameters())
    assert moved < 1e-3

    # resume: a second run of round 1 with resume starts at step 1
    exp3 = _port_experiment(d, f"general.save_dir={r1}",
                            "trainer.check_val_every_n_epoch=5")
    tr3 = exp3.fit(max_epochs=2, resume=True)
    assert tr3.step == 2 and len(exp3.fit_stats["epoch_s"]) == 1
