"""The port's config loader and entry point against the JAX package's.

The reference scripts' overrides (scripts/unsupervised/train_unscene3d.sh,
scripts/mask3d_DINO_CSC_self_train.sh) compose to equal trees in both
loaders; `instantiate` builds only the port's objects, maps dtype strings
to torch dtypes and raises ImportError for a target the port lacks; the
config keys the port does not implement raise NotImplementedError, and
each training option it runs builds and takes one CPU step through the
entry point; the entry point runs on the GPU unless `general.device=cpu`.
"""

import os
import sys

import pytest
import torch

from tests._torch_jax import one_torch_thread  # noqa: F401
from tests.test_datasets import write_mask3d_dataset
from unscene3d_tpu.config import load_config as jax_load_config
from unscene3d_torch.config import instantiate, load_config
from unscene3d_torch.main_instance_segmentation import (build_experiment,
                                                        get_parameters)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(ROOT, "conf", "config_base_instance_segmentation.yaml")

# scripts/unsupervised/train_unscene3d.sh
ROUND = ["general.experiment_name=DINO_CSC_self_train",
         'general.project_name="unscene3d"', "general.eval_on_segments=true",
         "general.train_on_segments=true", "general.num_targets=3",
         "data.batch_size=8", "data.test_batch_size=1",
         "data/collation_functions=freemask_voxelize_collate",
         "data/datasets=freemask",
         "general.data_dir=data/processed/unscene3d_dino_csc",
         "data.datasets.validation_dataset.data_dir="
         "data/processed/scannet_freemask_oracle",
         "data.datasets.test_dataset.data_dir="
         "data/processed/scannet_freemask_oracle",
         "general.resume=True"]
# scripts/mask3d_DINO_CSC_self_train.sh: the export and a later round
EXPORT = ["general.train_mode=false",
          "general.experiment_name=DINO_CSC_self_train",
          "general.save_for_freemask=true", "general.filter_out_instances=true",
          "general.eval_on_segments=true", "general.num_targets=3",
          "data/datasets=freemask"]
ROUND2 = ROUND + ["trainer.max_epochs=70", "optimizer=adamw_lower",
                  "data.datasets.train_dataset.self_train_data_dir="
                  "data/self_train/DINO_CSC_self_train",
                  "data.datasets.train_dataset.load_self_train_data=true",
                  "general.checkpoint="
                  "data/self_train/DINO_CSC_self_train/best"]

TINY = ["data.batch_size=2", "data.voxel_size=0.12", "model.hidden_dim=32",
        "model.num_queries=8", "model.num_heads=2",
        "model.dim_feedforward=64", "model.num_decoders=1",
        "model.sample_sizes=[16,32,64,128,256]",
        "model.backbone._target_=unscene3d_tpu.models.backbone.Res16UNet14A",
        "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=5",
        "general.device=cpu"]


@pytest.mark.parametrize("overrides", [ROUND, EXPORT, ROUND2],
                         ids=["round1", "export", "round2"])
def test_script_overrides_compose_equal_trees(overrides):
    want = jax_load_config(BASE, overrides)
    got = load_config(BASE, overrides)
    assert got == want


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    write_mask3d_dataset(str(d), n_scenes=2)
    return str(d)


def _walk(obj, seen, out):
    """Every object reachable from `obj` through attributes, dicts and
    sequences (modules, data sets, collators, criterion, loggers)."""
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float, bool,
                                           type(None), torch.Tensor)):
        return
    seen.add(id(obj))
    out.append(obj)
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple, set)):
        items = list(obj)
    else:
        items = list(getattr(obj, "__dict__", {}).values())
    for v in items:
        _walk(v, seen, out)


def test_build_experiment_builds_only_port_objects(data_dir, tmp_path):
    cfg = get_parameters(TINY + [f"general.data_dir={data_dir}",
                                 f"general.save_dir={tmp_path}/run"])
    exp = build_experiment(cfg)
    objs = []
    _walk(exp, set(), objs)
    mods = {type(o).__module__ for o in objs}
    assert not [m for m in mods if m.startswith("unscene3d_tpu")], mods
    assert "unscene3d_torch.models.mask3d" in mods
    assert "unscene3d_torch.data.freemask_dataset" in mods
    assert "unscene3d_torch.losses.criterion" in mods
    assert "unscene3d_torch.utils.loggers" in mods     # TB of logging: offline
    assert exp.device == torch.device("cpu")
    # the list-to-tuple rule turns ignore_mask_idx: [] into ()
    assert exp.criterion.ignore_mask_idx == ()
    assert exp.model.backbone.remat is True
    assert all(bn.momentum == 0.02 for bn in exp.trainer._bns)


@pytest.mark.parametrize("name,dtype", [("float32", torch.float32),
                                        ("bfloat16", torch.bfloat16)])
def test_dtype_strings_become_torch_dtypes(name, dtype):
    cfg = load_config(BASE, TINY + [f"model.dtype={name}"])
    model = instantiate(cfg.model)
    assert model.dtype is dtype and model.backbone.dtype is dtype


def test_unported_target_raises_without_importing_jax():
    """A target in a module the port leaves out on purpose (README "Left
    out of the port") raises ImportError and imports no JAX module."""
    mod = "unscene3d_tpu.ops.pointops2"
    before = mod in sys.modules
    with pytest.raises(ImportError, match="unscene3d_tpu.ops.pointops2"):
        instantiate({"_target_": f"{mod}.attention_step1", "q": 3})
    assert (mod in sys.modules) == before


@pytest.mark.parametrize("override", [
    "matcher.num_points=100", "general.backbone_checkpoint=x.ckpt",
    "model.train_on_segments=false"])
def test_unported_config_values_raise(override, data_dir, tmp_path):
    """Keys the JAX package never reads (matcher.num_points,
    general.backbone_checkpoint, model.train_on_segments) raise."""
    cfg = get_parameters(TINY + [f"general.data_dir={data_dir}",
                                 f"general.save_dir={tmp_path}/run",
                                 override])
    with pytest.raises(NotImplementedError):
        build_experiment(cfg)


def test_config_keys_reach_the_modules():
    cfg = load_config(BASE, TINY + ["model.backbone.bn_momentum=0.1",
                                    "model.backbone.remat=false"])
    model = instantiate(cfg.model)
    from unscene3d_torch.models.sparse_modules import SparseBatchNorm

    bns = [m for m in model.modules() if isinstance(m, SparseBatchNorm)]
    assert bns and all(bn.momentum == 0.1 for bn in bns)
    assert model.backbone.remat is False
    from unscene3d_torch.data.synthetic import make_scene

    collator = instantiate(cfg.data.collation_functions.train_collation,
                           build_triplane=True, fps_queries=8)
    batch, _ = collator([make_scene(1500, 4, seed=3)])
    tri = batch.triplane
    n_valid = int(batch.valid.sum())
    assert tri is not None and tri.order.shape == (3 * n_valid,)
    assert int(tri.counts.sum()) == 3 * n_valid


def test_remat_false_keeps_activations(monkeypatch):
    """`remat: false` runs the blocks without torch.utils.checkpoint; the
    losses equal remat's on the same weights and batch."""
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.models import backbone as bb
    from unscene3d_torch.models.weights import init_random_

    cfg = load_config(BASE, TINY)
    crit = instantiate(cfg.loss, matcher=instantiate(cfg.matcher))
    batch, _ = FreeMaskCollator(voxel_size=0.12, fps_queries=8)(
        [make_scene(1500, 4, seed=3)])
    losses = {}
    for remat in (True, False):
        model = init_random_(instantiate(cfg.model), 0).train()
        model.backbone.remat = remat
        calls = []
        real = bb.checkpoint
        monkeypatch.setattr(bb, "checkpoint",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        out = model(batch, generator=torch.Generator().manual_seed(0))
        losses[remat] = crit(out, batch)["total"]
        assert bool(calls) == remat
    assert torch.equal(losses[True], losses[False])


def test_entry_point_needs_the_card_unless_asked_for_the_cpu(data_dir,
                                                             tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    over = [o for o in TINY if o != "general.device=cpu"]
    cfg = get_parameters(over + [f"general.data_dir={data_dir}",
                                 f"general.save_dir={tmp_path}/run"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_experiment(cfg)


@pytest.mark.parametrize("overrides", [
    ["loss.weight_noise_robust=1.0"], ["model.dropout=0.1"],
    ["model.pre_norm=true"], ["model.max_sample_size=true"],
    ["model.use_level_embed=true"], ["model.use_np_features=true"],
    ["model.scatter_type=max"], ["model.non_parametric_queries=false"],
    ["model.non_parametric_queries=false", "model.random_queries=true"],
    ["model.non_parametric_queries=false", "model.random_query_both=true",
     "model.random_normal=true"],
    ["data/collation_functions=voxelize_collate_merge"],
    ["data.prefetch_processes=2"]],
    ids=lambda o: "+".join(x.split("=")[0].split(".")[-1] for x in o))
def test_ported_training_options_take_a_step(overrides, data_dir, tmp_path):
    """Each training option that earlier raised builds through the entry
    point and takes one CPU step with finite losses, its batch collated by
    the experiment's own load (the collator's draws) and collate."""
    cfg = get_parameters(TINY + [f"general.data_dir={data_dir}",
                                 f"general.save_dir={tmp_path}/run"]
                         + overrides)
    exp = build_experiment(cfg)
    try:
        (batch,) = exp._collate_step(exp._load_scenes([[0, 1]]))
        losses = exp.trainer.train_step(
            batch, torch.Generator().manual_seed(0))
    finally:
        exp.close()
    for key in ("loss_ce", "loss_mask", "loss_dice", "loss_noise_robust",
                "total"):
        assert torch.isfinite(losses[key]).all(), key
    nr = losses["loss_noise_robust"]
    assert bool((nr > 0).all()) == ("loss.weight_noise_robust=1.0"
                                    in overrides)
    assert exp.trainer.step == 1
