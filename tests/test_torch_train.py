"""The PyTorch port's Mask3D train step against the JAX package's.

The whole f32 step of the tiny model of tests/test_train.py (Res16UNet14A,
hidden 32, 10 queries, 2 heads, FFN 64, one decoder round, 2 scenes of 1,500
points at voxel 0.12) runs through `Trainer._step_core` of the JAX package
and `Trainer.train_step` of the port, on the same numpy-seeded scenes and
the JAX init's weights (with random BatchNorm state) carried across by
models/weights.py. Sample sizes are wide enough that point sampling is the
identity on both sides, and both collators take the host FPS seeds, so
both models see the same points. Two steps are compared.

Both sides match with the exact solver (`solver="scipy"`): the auction's
bids walk through near-ties at the scale of its bid increment, so a
last-bit difference between the two forwards can send it down another path
(it did, for one of 80 targets). tests/test_torch_losses.py holds the
port's auction to the JAX auction on the same cost tensor, index for index.

Tolerances: loss terms rel 1e-5; updated params and BatchNorm running
stats rtol 2e-4 / atol 2e-5 (tests/test_scan_decoder.py's f32 tolerance:
both sides sum the same f32 products in other orders); gradients atol 2e-5
+ rtol 2e-4 of each tensor's largest entry, since an entry of a conv
kernel's gradient sums many terms of both signs and its rounding error
scales with the terms, not with their sum. Matched indices are equal on
every prediction set whose queries are distinguishable. In a set whose
queries all predict the same (the first, where every query is still zero,
and after a step the second too) every assignment costs the same to
rounding, so there the port's assignment must only cost what JAX's costs;
the loss and the gradients of both steps are taken under JAX's matching.
Also here: the train-mode modules (BatchNorm, the differentiable k2 convs,
pool and segment sum) against their JAX custom VJPs, `_sample_level` fed
the same scores, and AdamW and its schedules against optax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_batch
from unscene3d_tpu.losses.criterion import SetCriterion as JaxCriterion
from unscene3d_tpu.losses.matcher import HungarianMatcher as JaxMatcher
from unscene3d_tpu.models import sparse_modules as jax_sm
from unscene3d_tpu.models.backbone import Res16UNet14A
from unscene3d_tpu.models.mask3d import Mask3D as JaxMask3D
from unscene3d_tpu.models.mask3d import _sample_level as jax_sample_level
from unscene3d_tpu.ops import conv_ops as jax_conv_ops
from unscene3d_tpu.ops.segment_pool import tile_segment_sum
from unscene3d_tpu.train.loop import Trainer as JaxTrainer
from unscene3d_tpu.train.loop import make_optimizer as jax_make_optimizer
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.models import sparse_modules as torch_sm
from unscene3d_torch.models.mask3d import _sample_level
from unscene3d_torch.models.weights import (load_flax_variables,
                                            torch_params_from_flax,
                                            torch_state_from_flax)
from unscene3d_torch.ops import conv_ops
from unscene3d_torch.ops.segment_pool import segment_sum
from unscene3d_torch.train.loop import AdamW, build_trainer, make_optimizer

from tests._torch_jax import np_tree, random_bn

RTOL, ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-5
TINY = dict(num_classes=3, hidden_dim=32, num_queries=10, num_heads=2,
            dim_feedforward=64, num_decoders=1, hlevels=(0, 1, 2, 3),
            sample_sizes=(4096,) * 5)
VOXEL = 0.06
# conf/optimizer/adamw.yaml's lr: Adam's first updates are ~lr * sign(g), so
# a gradient at rounding-noise level may flip its update; at lr 1e-4 the
# onecycle's first rates keep such a flip inside the params' atol
LR, STEPS = 1e-4, 20


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def scenes():
    return make_batch(2, num_points=1500)


def _grads_from_adam(mu, mu_prev):
    """The step's gradient, read back from optax.adamw's first moment
    (mu = b1 * mu_prev + (1 - b1) * g, b1 = 0.9), in f64: _step_core does
    not return its gradients, and a second jitted gradient would double the
    compile time. The read-back error is ~1e-7 of the gradient's scale."""
    return jax.tree.map(
        lambda m, m0: ((np.float64(m) - 0.9 * np.float64(m0)) / 0.1
                       ).astype(np.float32), mu, mu_prev)


@pytest.fixture(scope="module")
def jax_run(scenes):
    """Two JAX train steps (`Trainer._step_core`) from the JAX init (random
    BN state): per step the matched indices, losses, gradients and the state
    after the update."""
    batch, _ = JaxCollator(voxel_size=VOXEL, fps_queries=10)(scenes)
    model = JaxMask3D(backbone=Res16UNet14A(out_channels=2), **TINY)
    criterion = JaxCriterion(matcher=JaxMatcher(solver="scipy"),
                             num_classes=3)
    trainer = JaxTrainer(model, criterion,
                         jax_make_optimizer(lr=LR, total_steps=STEPS))
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        b, train=False, is_eval=True))(batch)
    variables = random_bn(variables)
    # at the init, attention is near uniform and the first round's queries
    # agree to ~1e-6, which would leave that set's matching to rounding:
    # larger query positions sharpen the attention so the queries differ
    variables["params"]["query_proj_1"]["kernel"] *= 8.0
    rng = jax.random.PRNGKey(0)

    @jax.jit
    def match(state, batch):
        variables = {"params": state.params, "batch_stats": state.batch_stats,
                     "buffers": state.buffers}
        outputs, _ = model.apply(variables, batch, train=True,
                                 rngs={"sample": rng}, mutable=["batch_stats"])
        return criterion.matcher(outputs["pred_logits"],
                                 outputs["pred_masks_seg"], batch.target,
                                 "segment_mask", batch.seg_valid)

    step = jax.jit(lambda state, batch: trainer._step_core(state, batch, rng,
                                                           None))
    from unscene3d_tpu.train.loop import TrainState

    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       buffers=variables["buffers"],
                       opt_state=trainer.tx.init(variables["params"]))
    out = []
    for _ in range(2):
        matched = match(state, batch)
        mu_prev = state.opt_state[0].mu
        state, losses = step(state, batch)
        out.append(jax.tree.map(np.asarray, dict(
            matched=matched, losses=losses,
            grads=_grads_from_adam(state.opt_state[0].mu, mu_prev),
            params=state.params, batch_stats=state.batch_stats)))
    return variables, out


class _Pinned:
    """A matcher that answers with given indices (the JAX step's)."""

    def __init__(self, matched):
        self.matched = torch.from_numpy(np.array(matched)).long()

    def __call__(self, *args):
        return self.matched


@pytest.fixture(scope="module")
def torch_run(scenes, jax_run):
    """Two port train steps; per step the port's own matching with its cost
    matrices, and the losses, gradients and state after the update of the
    step taken under JAX's matching."""
    variables, ref = jax_run
    batch, _ = FreeMaskCollator(voxel_size=VOXEL, fps_queries=10)(scenes)
    trainer = build_trainer(torch.float32, seed=None, backbone="Res16UNet14A",
                            lr=LR, total_steps=STEPS, solver="scipy", **TINY)
    load_flax_variables(trainer.model, variables)
    criterion = trainer.criterion
    gen = torch.Generator().manual_seed(0)
    out = []
    names = [n for n, _ in trainer.model.named_parameters()]
    for step in range(2):
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
            criterion, matcher=_Pinned(ref[step]["matched"]))
        losses, grads = trainer.loss_and_grads(batch, gen)
        trainer.optimizer.step(trainer.params, grads)
        for bn in trainer._bns:
            bn.update_running_stats()
        out.append(dict(matched=own.numpy(), cost=cost.numpy(),
                        losses=losses, grads=dict(zip(names, grads)),
                        state={k: v.clone() for k, v in
                               trainer.model.state_dict().items()}))
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_matched_indices_match_jax(jax_run, torch_run, step):
    ref, got = jax_run[1][step]["matched"], torch_run[step]["matched"]
    cost = torch_run[step]["cost"]                       # (L, B, Q, T)
    distinct = np.ptp(cost, axis=2).max(axis=-1) > 1e-4  # (L, B)
    assert distinct.sum() >= distinct.size - 2 * distinct.shape[1]
    np.testing.assert_array_equal(got[distinct], ref[distinct])
    t = np.arange(cost.shape[-1])
    for l, b in zip(*np.nonzero(~distinct)):
        c = cost[l, b]
        np.testing.assert_allclose(c[got[l, b], t].sum(),
                                   c[ref[l, b], t].sum(), rtol=1e-6)
    if step == 0:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("step", [0, 1])
def test_losses_match_jax(jax_run, torch_run, step):
    ref, got = jax_run[1][step]["losses"], torch_run[step]["losses"]
    for key in ("loss_ce", "loss_mask", "loss_dice", "total", "num_masks"):
        _close(got[key], ref[key], rtol=LOSS_RTOL, atol=0, msg=key)


@pytest.mark.parametrize("step", [0, 1])
def test_gradients_match_jax(jax_run, torch_run, step):
    ref = torch_params_from_flax(jax_run[1][step]["grads"])
    got = torch_run[step]["grads"]
    assert set(ref) == set(got)
    for name, g in got.items():
        r = ref[name].numpy()
        err = np.abs(g.numpy() - r).max()
        assert err <= ATOL + RTOL * np.abs(r).max(), (name, err)


@pytest.mark.parametrize("step", [0, 1])
def test_params_and_bn_stats_after_update_match_jax(jax_run, torch_run,
                                                    step):
    ref = torch_state_from_flax({"params": jax_run[1][step]["params"],
                                 "batch_stats":
                                     jax_run[1][step]["batch_stats"]})
    got = torch_run[step]["state"]
    # the keys' biases have an exactly zero gradient (softmax ignores a
    # shift shared by all keys): both sides see rounding noise there, which
    # Adam turns into updates of +-lr per step, so they can differ by the
    # sum of two learning rates per step
    sched = make_optimizer(lr=LR, total_steps=STEPS).schedule
    noise_bound = ATOL + 2 * sum(sched(i) for i in range(step + 1))
    for name, v in ref.items():
        if name.endswith("k_proj.bias"):
            assert (got[name] - v).abs().max() <= noise_bound, name
        else:
            _close(got[name], v, msg=name)
    # the running statistics moved
    before = torch_state_from_flax({"batch_stats": jax_run[0]["batch_stats"]})
    assert any(not torch.equal(got[k], before[k]) for k in before)


# --------------------------------------------------------------- modules
@pytest.fixture(scope="module")
def batches(scenes):
    jb, _ = JaxCollator(voxel_size=VOXEL, fps_queries=10)(scenes)
    tb, _ = FreeMaskCollator(voxel_size=VOXEL, fps_queries=10)(scenes)
    return jb, tb


def test_batchnorm_train_matches_jax(batches):
    jb, tb = batches
    lvl_j, lvl_t = jb.graph.levels[1], tb.graph.levels[1]
    rng = np.random.RandomState(0)
    n, c = lvl_t.num_padded, 24
    x = rng.randn(n, c).astype(np.float32) * 2 + 0.5
    g = rng.randn(n, c).astype(np.float32)
    bn_j = jax_sm.SparseBatchNorm(0.02)
    v = np_tree(bn_j.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          lvl_j.valid, False))
    v["params"]["scale"] = rng.rand(c).astype(np.float32) + 0.5
    v["params"]["bias"] = rng.randn(c).astype(np.float32)

    def f(x, params):
        y, mut = bn_j.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, x,
                            lvl_j.valid, True, mutable=["batch_stats"])
        return (y * g).sum(), (y, mut)

    (_, (y_ref, mut)), (gx_ref, gp_ref) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), v["params"])
    bn = torch_sm.SparseBatchNorm(c)
    bn.scale.data = _t(v["params"]["scale"])
    bn.bias.data = _t(v["params"]["bias"])
    xt = _t(x).requires_grad_()
    y = bn(xt, lvl_t.valid)
    (y * _t(g)).sum().backward()
    bn.update_running_stats()
    _close(y, y_ref)
    _close(xt.grad, gx_ref)
    _close(bn.scale.grad, gp_ref["scale"])
    _close(bn.bias.grad, gp_ref["bias"])
    _close(bn.mean, mut["batch_stats"]["mean"])
    _close(bn.var, mut["batch_stats"]["var"])


@pytest.mark.parametrize("op", ["down2", "up2", "pool", "conv3"])
def test_conv_op_grads_match_jax_custom_vjps(batches, op):
    """dx and dW of the port's autograd Functions (twins on the CPU) against
    the JAX package's custom VJPs (conv_ops.py:_conv_down2, _conv_up2,
    _avg_pool2, _conv3)."""
    jb, tb = batches
    J, T = jb.graph.levels, tb.graph.levels
    rng = np.random.RandomState(1)
    cin, cout = 12, 20
    if op == "down2":
        n_in, n_out, k = J[1].num_padded, J[2].num_padded, 8
        fj = lambda x, w: jax_conv_ops.sparse_conv_down2(x, w, J[2],
                                                         fine=J[1])
        ft = lambda x, w: conv_ops.sparse_conv_down2(x, w, T[2], fine=T[1])
    elif op == "up2":
        n_in, n_out, k = J[2].num_padded, J[1].num_padded, 8
        fj = lambda x, w: jax_conv_ops.sparse_conv_up2(x, w, J[1],
                                                       coarse=J[2])
        ft = lambda x, w: conv_ops.sparse_conv_up2(x, w, T[1], coarse=T[2])
    elif op == "pool":
        n_in, n_out, k, cout = J[0].num_padded, J[1].num_padded, 0, cin
        fj = lambda x, w: jax_conv_ops.avg_pool2(x, J[1], fine=J[0])
        ft = lambda x, w: conv_ops.avg_pool2(x, T[1], fine=T[0])
    else:
        n_in = n_out = J[1].num_padded
        k = 27
        fj = lambda x, w: jax_conv_ops.sparse_conv3(x, w, J[1])
        ft = lambda x, w: conv_ops.sparse_conv3(x, w, T[1])
    x = rng.randn(n_in, cin).astype(np.float32)
    w = (rng.randn(k, cin, cout) * 0.2).astype(np.float32) if k else None
    g = rng.randn(n_out, cout).astype(np.float32)
    if k:
        ref_out, vjp = jax.vjp(fj, jnp.asarray(x), jnp.asarray(w))
    else:
        ref_out, vjp = jax.vjp(lambda x: fj(x, None), jnp.asarray(x))
    refs = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    wt = _t(w).requires_grad_() if k else None
    out = ft(xt, wt)
    (out * _t(g)).sum().backward()
    _close(out, ref_out)
    _close(xt.grad, refs[0], msg="dx")
    if k:
        _close(wt.grad, refs[1], msg="dW")


def test_segment_sum_grad_matches_jax():
    rng = np.random.RandomState(2)
    n, c, s = 700, 16, 30
    x = rng.randn(n, c).astype(np.float32)
    ids = rng.randint(-1, s + 2, n).astype(np.int32)
    valid = rng.rand(n) > 0.2
    g = rng.randn(s, c).astype(np.float32)
    _, vjp = jax.vjp(lambda x: tile_segment_sum(x, jnp.asarray(ids), s,
                                                jnp.asarray(valid)),
                     jnp.asarray(x))
    xt = _t(x).requires_grad_()
    out = segment_sum(xt, _t(ids), s, _t(valid), None, None)
    (out * _t(g)).sum().backward()
    _close(xt.grad, vjp(jnp.asarray(g))[0])


def test_no_backward_without_grad(batches):
    """Inputs that need no gradient take the plain forward: no autograd
    graph is recorded (the coordinate pyramid, the pooled readout)."""
    _, tb = batches
    L = tb.graph.levels
    x = torch.randn(L[0].num_padded, 3)
    assert conv_ops.avg_pool2(x, L[1]).grad_fn is None
    xr = x.clone().requires_grad_()
    assert conv_ops.avg_pool2(xr, L[1], fine=L[0]).grad_fn is not None
    with pytest.raises(ValueError, match="needs `fine`"):
        conv_ops.avg_pool2(xr, L[1])


@pytest.mark.parametrize("epilogue", ["scale", "residual", "relu"])
def test_fused_epilogue_under_grad_raises(batches, epilogue):
    """Kernel 1's fused epilogue has no backward: with an input that needs
    a gradient it raises rather than return a result with no graph; under
    torch.no_grad() it runs."""
    _, tb = batches
    lv = tb.graph.levels[1]
    x = torch.randn(lv.num_padded, 4)
    w = torch.randn(27, 4, 4, requires_grad=True)
    kw = {"scale": dict(scale=torch.ones(4), shift=torch.zeros(4)),
          "residual": dict(residual=torch.zeros(lv.num_padded, 4)),
          "relu": dict(relu=True)}[epilogue]
    with pytest.raises(NotImplementedError, match="no backward"):
        conv_ops.sparse_conv3(x, w, lv, **kw)
    with torch.no_grad():
        assert conv_ops.sparse_conv3(x, w, lv, **kw).shape == x.shape


@pytest.mark.parametrize("hlevel,size", [(3, 64), (2, 16)])
def test_sample_level_matches_jax_on_the_same_scores(batches, hlevel, size):
    jb, tb = batches
    glevel = 4 - hlevel
    assert jb.scene_idx[glevel].shape[1] > size
    key = jax.random.PRNGKey(hlevel)
    idx_ref, val_ref = jax_sample_level(jb, hlevel, size, False, False, key)
    scores = jax.random.uniform(key, jb.scene_valid[glevel].shape)
    idx, val = _sample_level(tb, hlevel, size, scores=_t(scores))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(val.numpy(), np.asarray(val_ref))
    # identity when the table is no wider than the sample size
    idx, val = _sample_level(tb, hlevel, jb.scene_idx[glevel].shape[1])
    assert idx is tb.scene_idx[glevel] and val is tb.scene_valid[glevel]


# ---------------------------------------------------------- optimizer
@pytest.mark.parametrize("schedule,total", [("onecycle", 100),
                                            ("onecycle", 2),
                                            ("exponential", 50),
                                            ("constant", 50)])
def test_schedule_matches_optax(schedule, total):
    """The port's schedules against the optax schedules that
    unscene3d_tpu/train/loop.py:make_optimizer builds (same numbers), at
    steps 0, 1, 30%, the last step and past the end; rtol 1e-5 (optax
    evaluates in f32, a few ulps) and atol 1e-6 of the peak (its f32
    cosine cancels near the end of the cycle)."""
    got = make_optimizer(lr=3e-4, total_steps=total, schedule=schedule,
                         gamma=0.99)
    span = max(total, 10)
    ref = {"onecycle": optax.cosine_onecycle_schedule(
        transition_steps=span, peak_value=3e-4, pct_start=0.3,
        div_factor=25.0, final_div_factor=1e4),
        "exponential": optax.exponential_decay(
            init_value=3e-4, transition_steps=1, decay_rate=0.99),
        "constant": lambda c: 3e-4}[schedule]
    for count in (0, 1, int(0.3 * span), span - 1, span, span + 5):
        np.testing.assert_allclose(got.schedule(count),
                                   float(ref(jnp.asarray(count))),
                                   rtol=1e-5, atol=3e-10, err_msg=str(count))


def test_adamw_matches_optax():
    rng = np.random.RandomState(3)
    shapes = [(5, 7), (11,), (2, 3, 4)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    tx = jax_make_optimizer(lr=1e-2, total_steps=10)
    state = tx.init([jnp.asarray(p) for p in params])
    jp = [jnp.asarray(p) for p in params]
    opt = make_optimizer(lr=1e-2, total_steps=10)
    assert isinstance(opt, AdamW)
    tp = [_t(p) for p in params]
    opt.init(tp)
    for _ in range(4):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [_t(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
