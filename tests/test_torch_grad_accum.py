"""Gradient accumulation: the port's `Trainer.accum_train_step` against the
JAX package's `build_accum_train_step` (tests/test_grad_accum.py) on the
tiny model of tests/test_torch_train.py, with the JAX init's weights
(random BatchNorm state) carried across and both sides matched by scipy.
A file of its own: the JAX compile of the accumulated step takes most of
its time, and the suite spreads files over its workers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests._torch_jax import np_tree, one_torch_thread, random_bn  # noqa
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.models.weights import (load_flax_variables,
                                            torch_state_from_flax)
from unscene3d_torch.train.loop import build_trainer

TINY_MODEL = dict(num_classes=3, hidden_dim=32, num_queries=10, num_heads=2,
                  dim_feedforward=64, num_decoders=1, hlevels=(0, 1, 2, 3),
                  sample_sizes=(4096,) * 5)
VOXEL = 0.06


def test_accumulated_step_matches_jax():
    """Two micro-batches of one scene each (scenes whose natural pad plans
    agree, so the JAX package can stack them), one step from the init, where
    both sides' scipy matching agrees (tests/test_torch_train.py, step 0):
    losses rel 1e-5, updated params and BN running statistics at
    test_torch_train.py's tolerances."""
    from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
    from unscene3d_tpu.losses.criterion import SetCriterion as JaxCriterion
    from unscene3d_tpu.losses.matcher import HungarianMatcher as JaxMatcher
    from unscene3d_tpu.models.backbone import Res16UNet14A
    from unscene3d_tpu.models.mask3d import Mask3D as JaxMask3D
    from unscene3d_tpu.parallel.mesh import stack_shards
    from unscene3d_tpu.train.loop import Trainer as JaxTrainer
    from unscene3d_tpu.train.loop import TrainState
    from unscene3d_tpu.train.loop import make_optimizer as jax_opt

    scenes = [[make_scene(1500, seed=0)], [make_scene(1500, seed=3)]]
    jc = JaxCollator(voxel_size=VOXEL, fps_queries=10)
    jb = [jc(s)[0] for s in scenes]
    assert jc.pad_plan(jb[0]) == jc.pad_plan(jb[1])
    model = JaxMask3D(backbone=Res16UNet14A(out_channels=2), **TINY_MODEL)
    criterion = JaxCriterion(matcher=JaxMatcher(solver="scipy"),
                             num_classes=3)
    trainer = JaxTrainer(model, criterion, jax_opt(lr=1e-4, total_steps=20))
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        b, train=False, is_eval=True))(jb[0])
    variables = random_bn(variables)
    variables["params"]["query_proj_1"]["kernel"] *= 8.0
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       buffers=variables["buffers"],
                       opt_state=trainer.tx.init(variables["params"]))
    rng = jax.random.PRNGKey(0)

    new_state, ref_losses = trainer.build_accum_train_step(2)(
        state, stack_shards(jb), rng)
    ref = torch_state_from_flax(
        {"params": np_tree(new_state.params),
         "batch_stats": np_tree(new_state.batch_stats)})

    port = build_trainer(torch.float32, seed=None, backbone="Res16UNet14A",
                         lr=1e-4, total_steps=20, solver="scipy",
                         device="cpu", **TINY_MODEL)
    load_flax_variables(port.model, variables)
    tb = [FreeMaskCollator(voxel_size=VOXEL, fps_queries=10)(s)[0]
          for s in scenes]
    losses = port.accum_train_step(tb, torch.Generator().manual_seed(0))
    assert port.step == 1 and port.optimizer.count == 1
    assert "matched_q" not in losses
    for key in ("loss_ce", "loss_mask", "loss_dice", "total", "num_masks"):
        np.testing.assert_allclose(losses[key].numpy(),
                                   np.asarray(ref_losses[key]), rtol=1e-5,
                                   err_msg=key)
    got = port.model.state_dict()
    # the keys' biases: zero gradient, rounding noise turned into +-lr
    # updates on both sides (tests/test_torch_train.py)
    for name, v in ref.items():
        atol = 2e-5 + 2 * 4e-6 if name.endswith("k_proj.bias") else 2e-5
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=2e-4,
                                   atol=atol, err_msg=name)
