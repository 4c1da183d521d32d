"""The training options of conf/ that the port runs since the noise-robust
slice, against the JAX package's.

  * one whole f32 train step with `weight_noise_robust=1.0` (the tiny model
    and scenes of tests/test_torch_train.py, batches with tri-plane maps):
    losses, gradients and the updated params against JAX
    `Trainer._step_core` on carried weights, at the tolerances of
    tests/test_torch_train.py (losses rel 1e-5; params rtol 2e-4 / atol
    2e-5; gradients 2e-5 + 2e-4 of each tensor's largest entry);
  * the max segment pool's gradient at ties against JAX's (both spread it
    evenly over the tied rows; exact to 1e-7);
  * dropout in train mode: bitwise repeatable from one generator seed, the
    dropped share within 5 standard deviations of p, survivors scaled by
    exactly 1 / (1 - p).
  * MergeCollator (conf/data/collation_functions/voxelize_collate_merge.
    yaml) bitwise the JAX one for each option, its generators seeded as
    the JAX module's global `random` and `np.random`;
  * `Experiment.evaluate` with `data.prefetch_processes=2` (the collates
    in spawned processes, none in the parent) equal to 0.
The decoder's query and pooling modes: tests/test_torch_decoder_modes.py.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_jax import one_torch_thread, random_bn  # noqa: F401
from tests.test_datasets import write_mask3d_dataset
from tests.test_torch_experiment import CYCLE
from unscene3d_tpu.data.collate import MergeCollator as JaxMergeCollator
from tests.test_torch_train import LR, STEPS, TINY, VOXEL, _grads_from_adam
from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_batch
from unscene3d_tpu.losses.criterion import SetCriterion as JaxCriterion
from unscene3d_tpu.losses.matcher import HungarianMatcher as JaxMatcher
from unscene3d_tpu.models.backbone import Res16UNet14A
from unscene3d_tpu.models.mask3d import Mask3D as JaxMask3D
from unscene3d_tpu.ops.segment_ops import segment_max as jax_segment_max
from unscene3d_tpu.train.loop import Trainer as JaxTrainer
from unscene3d_tpu.train.loop import TrainState
from unscene3d_tpu.train.loop import make_optimizer as jax_make_optimizer
from unscene3d_torch import native
from unscene3d_torch.data.collate import FreeMaskCollator, MergeCollator
from unscene3d_torch.inference import build_mask3d
from unscene3d_torch.models.transformer_layers import dropout
from unscene3d_torch.models.weights import (load_flax_variables,
                                            torch_params_from_flax,
                                            torch_state_from_flax)
from unscene3d_torch.ops.segment_ops import segment_max
from unscene3d_torch.train.loop import build_trainer

RTOL, ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-5
SMALL = dict(num_classes=3, hidden_dim=32, num_queries=8, num_heads=2,
             dim_feedforward=64, num_decoders=1)
FWD_VOXEL = 0.12


@pytest.fixture(scope="module")
def scenes():
    return make_batch(2, num_points=1500)


# ------------------------------------------------------ the train step
@pytest.fixture(scope="module")
def step_run(scenes):
    """One JAX and one port f32 train step from the same weights with the
    noise-robust loss at weight 1.0."""
    collate = dict(voxel_size=VOXEL, fps_queries=10, build_triplane=True)
    jb, _ = JaxCollator(**collate)(scenes)
    tb, _ = FreeMaskCollator(**collate)(scenes)
    model = JaxMask3D(backbone=Res16UNet14A(out_channels=2), **TINY)
    criterion = JaxCriterion(matcher=JaxMatcher(solver="scipy"),
                             num_classes=3, weight_noise_robust=1.0)
    trainer = JaxTrainer(model, criterion,
                         jax_make_optimizer(lr=LR, total_steps=STEPS))
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        b, train=False, is_eval=True))(jb)
    variables = random_bn(variables)
    # sharper attention so the first set's queries differ (as
    # tests/test_torch_train.py, whose step-0 matching is then JAX's)
    variables["params"]["query_proj_1"]["kernel"] *= 8.0
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       buffers=variables["buffers"],
                       opt_state=trainer.tx.init(variables["params"]))
    new, losses = jax.jit(lambda s, b: trainer._step_core(
        s, b, jax.random.PRNGKey(0), None))(state, jb)
    ref = jax.tree.map(np.asarray, dict(
        losses=losses, params=new.params, batch_stats=new.batch_stats,
        grads=_grads_from_adam(new.opt_state[0].mu, state.opt_state[0].mu)))

    port = build_trainer(torch.float32, seed=None, backbone="Res16UNet14A",
                         lr=LR, total_steps=STEPS, solver="scipy",
                         device="cpu", weight_noise_robust=1.0, **TINY)
    load_flax_variables(port.model, variables)
    names = [n for n, _ in port.model.named_parameters()]
    got, grads = port.loss_and_grads(tb, torch.Generator().manual_seed(0))
    port.optimizer.step(port.params, grads)
    for bn in port._bns:
        bn.update_running_stats()
    return ref, got, dict(zip(names, grads)), port.model.state_dict()


def test_noise_robust_step_losses_match_jax(step_run):
    ref, got, _, _ = step_run
    assert (ref["losses"]["loss_noise_robust"] > 0).all()
    for key in ("loss_ce", "loss_mask", "loss_dice", "loss_noise_robust",
                "total"):
        np.testing.assert_allclose(got[key].numpy(), ref["losses"][key],
                                   rtol=LOSS_RTOL, atol=0, err_msg=key)


def test_noise_robust_step_gradients_match_jax(step_run):
    ref, _, grads, _ = step_run
    want = torch_params_from_flax(ref["grads"])
    assert set(want) == set(grads)
    for name, g in grads.items():
        r = want[name].numpy()
        err = np.abs(g.numpy() - r).max()
        assert err <= ATOL + RTOL * np.abs(r).max(), (name, err)


def test_noise_robust_step_params_match_jax(step_run):
    ref, _, _, state = step_run
    want = torch_state_from_flax({"params": ref["params"],
                                  "batch_stats": ref["batch_stats"]})
    for name, v in want.items():
        # the keys' biases: zero gradient in exact arithmetic, rounding
        # noise on both sides that Adam turns into +-lr updates
        tol = ATOL + 2 * LR / 25 if name.endswith("k_proj.bias") else None
        if tol is not None:
            assert (state[name] - v).abs().max() <= tol, name
        else:
            np.testing.assert_allclose(state[name].numpy(), v.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_segment_max_gradient_at_ties_matches_jax():
    """Rows that tie for a segment's max share its gradient evenly in both
    packages; invalid rows and empty segments get none. The same with the
    rows per segment given (`counts`, as Mask3D passes the batch's)."""
    rng = np.random.RandomState(3)
    n, c, s = 40, 5, 6
    x = np.round(rng.randn(n, c), 1).astype(np.float32)   # many ties
    ids = rng.randint(0, s - 1, n).astype(np.int32)
    x[ids == 2] = 0.7                                     # a full tie
    valid = rng.rand(n) > 0.1
    g = rng.randn(s, c).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_segment_max(
        a, jnp.asarray(ids), s, jnp.asarray(valid)), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = segment_max(xt, torch.from_numpy(ids), s, torch.from_numpy(valid))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    np.testing.assert_allclose(xt.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), atol=1e-7)
    counts = torch.from_numpy(np.bincount(ids[valid], minlength=s)
                              .astype(np.float32))
    xc = torch.from_numpy(x).requires_grad_()
    out_c = segment_max(xc, torch.from_numpy(ids), s, torch.from_numpy(valid),
                        counts=counts)
    (out_c * torch.from_numpy(g)).sum().backward()
    assert torch.equal(out_c, out) and torch.equal(xc.grad, xt.grad)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_in_train_mode(p):
    x = torch.randn(64, 8, 128) + 3.0
    a = dropout(x, p, True, torch.Generator().manual_seed(4))
    b = dropout(x, p, True, torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    assert not torch.equal(a, dropout(x, p, True,
                                      torch.Generator().manual_seed(5)))
    kept = a != 0
    share = 1.0 - kept.float().mean().item()
    n = x.numel()
    assert abs(share - p) <= 5 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(a[kept], x[kept] / (1.0 - p))
    assert torch.equal(dropout(x, p, False, None), x)


def test_dropout_masks_come_from_the_generator(scenes):
    """A train-mode forward with dropout: equal for one generator seed,
    different for another, and different from p = 0."""
    tb, _ = FreeMaskCollator(voxel_size=FWD_VOXEL, fps_queries=8)(scenes)
    outs = {}
    for p in (0.0, 0.3):
        model = build_mask3d(torch.float32, backbone="Res16UNet14A", seed=0,
                             dropout=p, **SMALL).train()
        with torch.no_grad():
            for seed in (0, 0, 1):
                out = model(tb, torch.Generator().manual_seed(seed))
                outs.setdefault(p, []).append(out["pred_logits"])
    a, b, c = outs[0.3]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, outs[0.0][0])


# ------------------------------------------------------------ collation
MERGE_OPTIONS = {
    "default": dict(),
    "place_nearby": dict(place_nearby=True),
    "place_far": dict(place_far=True),
    "one_pc_noise": dict(make_one_pc_noise=True, ignore_label=253),
    "proba_half": dict(proba=0.5),
    "three_scenes": dict(scenes=3),
}


def _batches_equal(ref, ref_meta, got, meta):
    for lr, lg in zip(ref.graph.levels, got.graph.levels):
        for name in ("coords", "valid", "nbr_idx", "child_idx"):
            np.testing.assert_array_equal(getattr(lg, name).numpy(),
                                          np.asarray(getattr(lr, name)))
    for name in ("features", "raw_coords", "point2segment", "seg_valid",
                 "seg_counts", "level_bounds", "fps_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("labels", "valid", "seg_masks", "vox_masks"):
        np.testing.assert_array_equal(getattr(got.target, name).numpy(),
                                      np.asarray(getattr(ref.target, name)))
    assert meta.scene_names == ref_meta.scene_names
    assert meta.num_voxels == ref_meta.num_voxels


@pytest.mark.parametrize("option", list(MERGE_OPTIONS))
def test_merge_collator_matches_jax_bitwise(option):
    """Four calls on five scenes (a leftover scene where the group is
    short), the JAX collator's draws from the globals seeded with 7."""
    kw = dict(voxel_size=FWD_VOXEL, fps_queries=8, **MERGE_OPTIONS[option])
    scenes = make_batch(5, num_points=900, seed=2)
    jax_c, port_c = JaxMergeCollator(**kw), MergeCollator(seed=7, **kw)
    random.seed(7)
    np.random.seed(7)
    refs = [jax_c(scenes) for _ in range(4)]
    for ref, ref_meta in refs:
        got, meta = port_c(scenes)
        _batches_equal(ref, ref_meta, got, meta)
    merged = [len(m.scene_names) < len(scenes) for _, m in refs]
    if option == "proba_half":
        assert any(merged) and not all(merged)
    elif option == "one_pc_noise":
        assert len(refs[0][1].scene_names) == 5
    else:
        assert all(merged)


def test_fit_restarts_the_merge_draws_from_its_seed(tmp_path):
    """`Experiment.fit(seed=...)` restarts the merge collator's draws
    (`reseed`), so a merge sequence depends on the seed of `fit` alone; a
    merging collator gets a plain one for evaluation (`alters_scenes`)."""
    from unscene3d_torch.main_instance_segmentation import (build_experiment,
                                                            get_parameters)

    write_mask3d_dataset(str(tmp_path / "data"), n_scenes=4)
    exp = build_experiment(get_parameters(CYCLE + [
        f"general.data_dir={tmp_path}/data", "general.device=cpu",
        f"general.save_dir={tmp_path}/run",
        "data/collation_functions=voxelize_collate_merge",
        "data.collation_functions.train_collation.place_far=true"]))
    assert exp.collator.alters_scenes
    assert not exp.eval_collator.alters_scenes
    assert not FreeMaskCollator().alters_scenes
    scenes = [exp.train_dataset[i] for i in range(4)]

    def draw():
        return [s["xyz"] for s in exp.collator.prepare(scenes)]

    draw()
    exp.fit(max_epochs=0, seed=11)
    after_fit = draw()
    exp.collator.reseed(11)
    again = draw()
    exp.collator.reseed(12)
    other = draw()
    assert all(np.array_equal(a, b) for a, b in zip(after_fit, again))
    assert not all(np.array_equal(a, b) for a, b in zip(after_fit, other))


def test_merge_draws_follow_the_load_order(tmp_path):
    """The experiment takes the merge's draws in its scene loads, which
    its prefetcher runs in index order, and collates on worker threads:
    two experiments of one seed give the same merges."""
    from unscene3d_torch.main_instance_segmentation import (build_experiment,
                                                            get_parameters)
    from unscene3d_torch.train.experiment import Prefetcher

    write_mask3d_dataset(str(tmp_path / "data"), n_scenes=4)
    runs = []
    for run in range(2):
        exp = build_experiment(get_parameters(CYCLE + [
            f"general.data_dir={tmp_path}/data", "general.device=cpu",
            f"general.save_dir={tmp_path}/run{run}",
            "data/collation_functions=voxelize_collate_merge",
            "data.collation_functions.train_collation.place_far=true",
            "data.collation_functions.train_collation.proba=0.6"]))
        ids = [[[0, 1]], [[2, 3]], [[1, 2]], [[3, 0]], [[0, 2]], [[1, 3]]]
        seen = []
        collate = exp._collate_step
        exp._collate_step = lambda lists: (
            seen.append(sorted(float(s["xyz"].sum()) for ss in lists
                               for s in ss)), collate(lists))[1]
        batches = list(Prefetcher(lambda i: exp._load_scenes(ids[i]),
                                  exp._collate_step, len(ids),
                                  num_workers=3))
        runs.append((sorted(seen), [b[0].features.sum().item()
                                    for b in batches]))
    assert runs[0] == runs[1]
    # merged (one cloud of two scenes) and unmerged batches both occur
    assert {len(s) for s in runs[0][0]} == {1, 2}


@pytest.fixture(scope="module")
def pool_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("pool")
    write_mask3d_dataset(str(d / "data"), n_scenes=2)
    return d


def test_evaluate_with_collate_processes_equals_without(pool_data):
    from unscene3d_torch.main_instance_segmentation import (build_experiment,
                                                            get_parameters)

    res, calls = {}, {}
    for procs in (0, 2):
        exp = build_experiment(get_parameters(CYCLE + [
            f"general.data_dir={pool_data}/data", "general.device=cpu",
            f"general.save_dir={pool_data}/run{procs}",
            "general.eval_min_region_size=10",
            f"data.prefetch_processes={procs}"]))
        before = native.calls()["build_neighbor_map_padded"]
        try:
            res[procs] = exp.evaluate(exp.validation_dataset)
            assert (exp._collate_pool is not None) == (procs > 0)
        finally:
            exp.close()
        calls[procs] = native.calls()["build_neighbor_map_padded"] - before
    assert calls == {0: 10, 2: 0}     # 5 levels x 2 scenes, in the parent
    assert res[0] == res[2]
