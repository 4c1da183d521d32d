"""The `brick_levels` configuration of the PyTorch port: the k3 convs of the
named levels through the brick route (assemble -> kernel 7 -> disassemble;
on the CPU kernel 7's plain twin), held to the JAX package's brick conv.

The port's brick tables against the JAX `BrickMap` of the same level; the
tiny Mask3D eval forward with `brick_levels=(0,)` against the JAX forward
with the same option; one train step with `brick_levels=(0,)` against the
JAX `Trainer._step_core` with the same option (the saved flat x, the
recompute under remat and the pad brick's rows against the reference);
two train steps with `brick_levels=(0,)` against the port's own gather
route on the same batch; the collator's argument through the entry
point's config.

Inputs come from a numpy seed; tolerances are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_jax import one_torch_thread, random_bn  # noqa: F401
from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_scene
from unscene3d_tpu.losses.criterion import SetCriterion as JaxCriterion
from unscene3d_tpu.losses.matcher import HungarianMatcher as JaxMatcher
from unscene3d_tpu.models.backbone import Res16UNet14A
from unscene3d_tpu.models.mask3d import Mask3D as JaxMask3D
from unscene3d_tpu.ops.bricks import BRICK, build_brick_map
from unscene3d_tpu.train.loop import Trainer as JaxTrainer
from unscene3d_tpu.train.loop import TrainState
from unscene3d_tpu.train.loop import make_optimizer as jax_make_optimizer
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.inference import build_mask3d
from unscene3d_torch.models.weights import (load_flax_variables,
                                            torch_state_from_flax)
from unscene3d_torch.ops import brick_engine, conv_ops
from unscene3d_torch.ops.brick_engine import CELLS
from unscene3d_torch.train.loop import build_trainer, make_optimizer

SMALL = dict(num_classes=3, hidden_dim=32, num_queries=8, num_heads=2,
             dim_feedforward=64, num_decoders=2)
TINY = dict(num_classes=3, hidden_dim=32, num_queries=10, num_heads=2,
            dim_feedforward=64, num_decoders=1, hlevels=(0, 1, 2, 3),
            sample_sizes=(4096,) * 5)
RTOL, ATOL, LOSS_RTOL = 2e-4, 2e-5, 1e-5
# tests/test_torch_train.py's schedule: at lr 1e-4 a gradient at rounding
# level that flips its Adam update stays inside the params' atol
LR, STEPS = 1e-4, 20


@pytest.fixture(scope="module")
def scenes():
    """Two small dense scenes: few bricks, so that kernel 7's plain twin
    (27 dense slice products a brick) stays cheap on the CPU."""
    return [make_scene(1500, 4, extent=1.5, seed=s) for s in (0, 1)]


@pytest.mark.parametrize("level", [0, 1])
def test_brick_tables_match_the_jax_brick_map(scenes, level):
    """The same bricks in the same order: each brick's 10^3 assemble rows
    (the JAX (nb, 10, 10, 10) map, the port's first 1000 of 1008 cells) and
    each valid voxel's output cell (the JAX index into nb * 8^3 interior
    cells, the port's into nb_pad * 1008 halo'd cells) are equal; the pad
    bricks and the 8 tail cells are empty."""
    batch, _ = FreeMaskCollator(voxel_size=0.06, fps_queries=8,
                                brick_levels=(0, 1))(scenes)
    lv = batch.graph.levels[level]
    bg = lv.brick
    assert bg is not None and bg.n_pad == lv.num_padded
    ref = build_brick_map(lv.coords.numpy(), lv.valid.numpy())
    ref_asm = np.asarray(ref.assemble_idx)
    occupied = (ref_asm != lv.num_padded - 1).reshape(len(ref_asm), -1)
    nb = int(occupied.any(axis=1).sum())
    asm = bg.asm_idx.numpy()
    np.testing.assert_array_equal(asm[:nb, :1000],
                                  ref_asm[:nb].reshape(nb, 1000))
    assert (asm[nb:] == lv.num_padded - 1).all()
    assert (asm[:, 1000:] == lv.num_padded - 1).all()
    rows = np.nonzero(lv.valid.numpy())[0]
    ref_out = np.asarray(ref.out_idx)[rows]
    b, local = np.divmod(ref_out, BRICK ** 3)
    lx, rem = np.divmod(local, BRICK * BRICK)
    ly, lz = np.divmod(rem, BRICK)
    want = b * CELLS + (lx + 1) * 100 + (ly + 1) * 10 + (lz + 1)
    np.testing.assert_array_equal(bg.out_idx.numpy()[rows], want)


def test_eval_forward_with_brick_levels_matches_jax(scenes):
    """tests/test_torch_mask3d.py's model and tolerance (rtol 2e-4 / atol
    2e-5), `brick_levels=(0,)` on both sides; every k3 conv of level 0 went
    through the brick route, and kernel 7's wrapper ran once for each."""
    kw = dict(voxel_size=0.1, fps_queries=8, brick_levels=(0,))
    jbatch, _ = JaxCollator(**kw)(scenes)
    assert jbatch.graph.levels[0].brick is not None
    model = JaxMask3D(backbone=Res16UNet14A(out_channels=2),
                      scan_decoder=False, **SMALL)
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        b, train=False, is_eval=True))(jbatch)
    variables = random_bn(variables)
    ref = jax.jit(lambda v, b: model.apply(v, b, train=False,
                                           is_eval=True))(variables, jbatch)
    tmodel = build_mask3d(torch.float32, backbone="Res16UNet14A", seed=None,
                          **SMALL)
    load_flax_variables(tmodel, variables)
    batch, _ = FreeMaskCollator(**kw)(scenes)
    assert batch.graph.levels[0].brick is not None
    assert all(lv.brick is None for lv in batch.graph.levels[1:])
    calls = []
    real = conv_ops.brick_conv3
    conv_ops.brick_conv3 = lambda *a, **k: (calls.append(1), real(*a, **k))[1]
    try:
        with torch.no_grad():
            out = tmodel(batch)
    finally:
        conv_ops.brick_conv3 = real
    # level 0 of Res16UNet14A: the stem and block 8's two k3 convs
    assert len(calls) == 3
    for key in ("backbone_features", "mask_features", "pred_logits",
                "pred_masks_seg", "pred_masks_vox"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.fixture(scope="module")
def jax_brick_step(scenes):
    """One JAX train step (`Trainer._step_core`, one jit) with
    `brick_levels=(0,)` from the JAX init (random BN state, the sharper
    query positions of tests/test_torch_train.py), and the same step of
    the port from the bridged weights on the port's collation of the same
    scenes."""
    kw = dict(voxel_size=0.1, fps_queries=10, brick_levels=(0,))
    jbatch, _ = JaxCollator(**kw)(scenes)
    assert jbatch.graph.levels[0].brick is not None
    model = JaxMask3D(backbone=Res16UNet14A(out_channels=2), **TINY)
    criterion = JaxCriterion(matcher=JaxMatcher(solver="scipy"),
                             num_classes=3)
    trainer = JaxTrainer(model, criterion,
                         jax_make_optimizer(lr=LR, total_steps=STEPS))
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        b, train=False, is_eval=True))(jbatch)
    variables = random_bn(variables)
    variables["params"]["query_proj_1"]["kernel"] *= 8.0
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       buffers=variables["buffers"],
                       opt_state=trainer.tx.init(variables["params"]))
    rng = jax.random.PRNGKey(0)
    state, ref = jax.jit(lambda s, b: trainer._step_core(s, b, rng, None))(
        state, jbatch)
    ref_state = torch_state_from_flax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))

    batch, _ = FreeMaskCollator(**kw)(scenes)
    tr = build_trainer(torch.float32, seed=None, backbone="Res16UNet14A",
                       lr=LR, total_steps=STEPS, solver="scipy",
                       device="cpu", **TINY)
    load_flax_variables(tr.model, variables)
    calls = []
    real = brick_engine.brick_conv3_plain
    brick_engine.brick_conv3_plain = (
        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    try:
        got = tr.train_step(batch, torch.Generator().manual_seed(0))
    finally:
        brick_engine.brick_conv3_plain = real
    return (jax.tree.map(np.asarray, ref), ref_state), (
        got, tr.model.state_dict(), len(calls))


@pytest.mark.parametrize("what", ["losses", "state"])
def test_train_step_with_brick_levels_matches_jax(jax_brick_step, what):
    """tests/test_torch_train.py's tolerances: loss terms rel 1e-5; after
    the update every parameter and BatchNorm statistic rtol 2e-4 / atol
    2e-5, the attention keys' biases (an exactly zero gradient, so rounding
    noise that Adam turns into +-lr) within atol + 2 lr."""
    (ref, ref_state), (got, state, n_brick) = jax_brick_step
    # 3 level-0 convs in the forward, the two block convs again under remat
    assert n_brick == 5
    if what == "losses":
        for key in ("loss_ce", "loss_mask", "loss_dice", "total",
                    "num_masks"):
            np.testing.assert_allclose(got[key].numpy(), ref[key],
                                       rtol=LOSS_RTOL, atol=0, err_msg=key)
        return
    noise_bound = ATOL + 2 * make_optimizer(lr=LR,
                                            total_steps=STEPS).schedule(0)
    assert set(ref_state) <= set(state)
    for name, v in ref_state.items():
        if name.endswith("k_proj.bias"):
            assert (state[name] - v).abs().max() <= noise_bound, name
        else:
            np.testing.assert_allclose(state[name].numpy(), v.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.fixture(scope="module")
def train_runs(scenes):
    """Two f32 train steps from one seeded state, on the same scenes
    collated with and without `brick_levels=(0,)`."""
    runs = {}
    for bricks in ((0,), ()):
        batch, _ = FreeMaskCollator(voxel_size=0.1, fps_queries=10,
                                    brick_levels=bricks)(scenes)
        tr = build_trainer(torch.float32, seed=3, backbone="Res16UNet14A",
                           solver="scipy", device="cpu", **TINY)
        gen = torch.Generator().manual_seed(0)
        calls = []
        real = brick_engine.brick_conv3_plain
        brick_engine.brick_conv3_plain = (
            lambda *a, **k: (calls.append(1), real(*a, **k))[1])
        try:
            losses = [tr.train_step(batch, gen) for _ in range(2)]
        finally:
            brick_engine.brick_conv3_plain = real
        runs[bricks] = (losses, tr.model.state_dict(), len(calls))
    return runs


@pytest.mark.parametrize("step", [0, 1])
def test_train_steps_with_brick_levels_match_the_gather_route(train_runs,
                                                              step):
    """Losses rel 1e-5 at each step; after two steps every parameter and
    BatchNorm statistic rtol 2e-4 / atol 2e-5 (f32 summation order: the
    brick conv sums its 27 products in another order than kernel 1's
    twin)."""
    (got, state, n_brick), (want, want_state, n_plain) = (
        train_runs[(0,)], train_runs[()])
    # 3 level-0 convs, each run in the forward and again under remat for
    # the two block convs: 2 steps x (3 + 2)
    assert (n_brick, n_plain) == (10, 0)
    for key in ("loss_ce", "loss_mask", "loss_dice", "total"):
        np.testing.assert_allclose(got[step][key].numpy(),
                                   want[step][key].numpy(),
                                   rtol=LOSS_RTOL, atol=0, err_msg=key)
    if step == 1:
        for name, v in want_state.items():
            np.testing.assert_allclose(state[name].numpy(), v.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_collator_takes_brick_levels_through_the_config(tmp_path):
    """`data.collation_functions.train_collation.brick_levels=[0,1]`
    reaches the port's collator (the JAX entry point's override) and its
    batches carry the tables at levels 0 and 1."""
    from unscene3d_torch.config import instantiate
    from unscene3d_torch.data.synthetic import make_scene
    from unscene3d_torch.main_instance_segmentation import get_parameters

    cfg = get_parameters(["data.collation_functions.train_collation."
                          "brick_levels=[0,1]",
                          f"general.save_dir={tmp_path}/run",
                          "general.device=cpu"])
    collator = instantiate(cfg.data.collation_functions.train_collation,
                           fps_queries=8)
    assert collator.brick_levels == (0, 1)
    batch, _ = collator([make_scene(1500, 4, seed=3)])
    assert [lv.brick is not None for lv in batch.graph.levels] == [
        True, True, False, False, False]
