"""The `csr_levels` configuration of the PyTorch port against the JAX package:
the pair tables, kernel 6's plain twin against the Pallas kernel in interpret
mode, the CSR backward against `jax.grad` of `csr_conv3`, and the tiny model's
eval forward and two train steps with `csr_levels=(0,)` on both sides.

Inputs come from a numpy seed. Tolerances are stated at each test; the whole
model takes tests/test_torch_mask3d.py's and tests/test_torch_train.py's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_batch
from unscene3d_tpu.losses.criterion import SetCriterion as JaxCriterion
from unscene3d_tpu.losses.matcher import HungarianMatcher as JaxMatcher
from unscene3d_tpu.models.backbone import Res16UNet14A
from unscene3d_tpu.models.mask3d import Mask3D as JaxMask3D
from unscene3d_tpu.ops import csr_conv as jax_csr
from unscene3d_tpu.ops.kernel_maps import build_neighbor_map
from unscene3d_tpu.train.loop import Trainer as JaxTrainer
from unscene3d_tpu.train.loop import TrainState
from unscene3d_tpu.train.loop import make_optimizer as jax_make_optimizer
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.inference import build_mask3d
from unscene3d_torch.models.weights import (load_flax_variables,
                                            torch_params_from_flax,
                                            torch_state_from_flax)
from unscene3d_torch.ops import conv_ops
from unscene3d_torch.ops.conv3 import conv3_dw_plain, conv3_fwd_plain
from unscene3d_torch.ops.csr_conv import (OFFSETS, build_csr_graph,
                                          csr_conv3_fwd, csr_conv3_fwd_plain,
                                          csr_dw)
from unscene3d_torch.ops.sparse_graph import LevelGraph
from unscene3d_torch.train.loop import build_trainer

from tests._torch_jax import random_bn

N_PAD = 2 * jax_csr.TILE


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_level(seed=0, n=300, n_pad=N_PAD):
    """tests/test_csr_conv.py:_random_level: a random voxel set padded to
    n_pad, its (27, n_pad) map with misses at n_pad-1, and its valid mask."""
    rng = np.random.RandomState(seed)
    coords = np.unique(rng.randint(0, 12, (n, 3)), axis=0).astype(np.int32)
    n = len(coords)
    coords4 = np.column_stack([np.zeros(n, np.int32), coords])
    nbr_idx, nbr_valid = build_neighbor_map(coords4)
    full = np.full((27, n_pad), n_pad - 1, np.int32)
    full[:, :n] = np.where(nbr_valid, nbr_idx, n_pad - 1)
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    return full, valid, n


def _torch_level(nbr, valid):
    z = torch.zeros(0, dtype=torch.int32)
    return LevelGraph(coords=torch.zeros(len(valid), 4, dtype=torch.int32),
                      valid=_t(valid), nbr_idx=_t(nbr), child_idx=z,
                      parent_idx=z, parent_offset=z, csr=build_csr_graph(nbr))


def _assert_pairs_equal(ref: jax_csr.CsrGraph, got):
    """Every offset's real pairs of the JAX tables ([base, base + count) of
    in_rows / out_rows) equal the port's pair range of that offset."""
    in_rows = np.asarray(ref.in_rows)
    out_rows = np.asarray(ref.out_rows)[:, 0]
    bounds = got.bounds
    for ki, base in enumerate(ref.bases):
        lo, hi = bounds[ki], bounds[ki + 1]
        real = out_rows[base:base + ref.pb[ki]] != jax_csr.FAR
        assert real.sum() == hi - lo == got.counts[ki]
        assert real[:hi - lo].all()     # the real pairs lead the bucket
        np.testing.assert_array_equal(got.pair_in[lo:hi].numpy(),
                                      in_rows[base:base + hi - lo])
        np.testing.assert_array_equal(got.pair_out[lo:hi].numpy(),
                                      out_rows[base:base + hi - lo])
    assert got.num_pairs == bounds[-1]


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("seed", [0, 1])
def test_pair_tables_match_jax_on_a_random_level(seed):
    nbr, _, _ = _random_level(seed)
    got = build_csr_graph(nbr)
    _assert_pairs_equal(jax_csr.build_csr_graph(nbr, N_PAD), got)
    assert got.pair_in.dtype == got.pair_out.dtype == torch.int32
    # tile_start: the pairs of (offset, 64-row tile) are one range whose out
    # rows lie in the tile
    tiles = N_PAD // 64
    ts = got.tile_start.numpy()
    assert ts.shape == (26 * tiles + 1,) and ts[-1] == got.num_pairs
    assert (np.diff(ts) >= 0).all() and (np.diff(ts) <= 64).all()
    pout = got.pair_out.numpy()
    for ki in range(26):
        for t in range(tiles):
            rows = pout[ts[ki * tiles + t]:ts[ki * tiles + t + 1]]
            assert ((rows >= 64 * t) & (rows < 64 * t + 64)).all()
            assert (np.diff(rows) > 0).all()


@pytest.fixture(scope="module")
def collated():
    scenes = make_batch(2, num_points=1500)
    kw = dict(voxel_size=0.06, fps_queries=8, csr_levels=(0, 1))
    return JaxCollator(**kw)(scenes), FreeMaskCollator(**kw)(scenes)


def test_collated_pair_tables_match_jax(collated):
    """The batch's other tables with `csr_levels` set are held bitwise in
    tests/test_torch_collate.py (its `csr01-2scenes` case)."""
    (ref, _), (got, _) = collated
    for li, (lr, lg) in enumerate(zip(ref.graph.levels, got.graph.levels)):
        if li in (0, 1):
            assert lg.num_padded % 256 == 0
            _assert_pairs_equal(lr.csr, lg.csr)
        else:
            assert lr.csr is None and lg.csr is None
    moved = got.to("cpu").graph.levels[0].csr
    assert torch.equal(moved.pair_in, got.graph.levels[0].csr.pair_in)
    assert moved.counts == got.graph.levels[0].csr.counts


# ------------------------------------------------------- kernel 6's twin
def _dense_oracle(x, w, nbr, valid):
    n_pad = len(valid)
    out = np.zeros((n_pad, w.shape[-1]), np.float32)
    for k in range(27):
        ok = (nbr[k] != n_pad - 1) & valid
        out[ok] += (x[nbr[k]] @ w[k])[ok]
    return out


@pytest.fixture(scope="module")
def jax_fwd():
    """The Pallas kernel in interpret mode, one jitted function per epilogue
    (shared by the cases below)."""
    fns = {}

    def get(has_bias, has_res, relu):
        key = (has_bias, has_res, relu)
        if key not in fns:
            fns[key] = jax.jit(
                lambda x, w, csr, valid, bias, res: jax_csr.csr_conv3_fwd(
                    x, w, csr, valid, bias=bias if has_bias else None,
                    residual=res if has_res else None, relu=relu,
                    interpret=True))
        return fns[key]

    return get


@pytest.mark.parametrize("cin,cout", [(8, 8), (3, 8)])
@pytest.mark.parametrize("epi", ["none", "bias", "bias_res_relu"])
def test_twin_matches_pallas_interpret(jax_fwd, cin, cout, epi):
    """f32, rtol 1e-4 / atol 1e-4 (tests/test_csr_conv.py's tolerance: the
    two sum the same f32 products in another order)."""
    nbr, valid, n = _random_level(seed=cin)
    rng = np.random.RandomState(10 + cin)
    x = np.zeros((N_PAD, cin), np.float32)     # the TPU kernel needs zero
    x[:n] = rng.rand(n, cin)                   # padding rows
    w = (rng.rand(27, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    res = rng.randn(N_PAD, cout).astype(np.float32)
    has_bias, has_res = epi != "none", epi == "bias_res_relu"
    ref = jax_fwd(has_bias, has_res, has_res)(
        jnp.asarray(x), jnp.asarray(w), jax_csr.build_csr_graph(nbr, N_PAD),
        jnp.asarray(valid), jnp.asarray(bias), jnp.asarray(res))
    lvl = _torch_level(nbr, valid)
    kw = {}
    if has_bias:
        kw.update(scale=torch.ones(cout), shift=_t(bias))
    if has_res:
        kw.update(residual=_t(res), relu=True)
    got = csr_conv3_fwd(_t(x), _t(w), lvl.csr, lvl.valid, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    # the router with a bias folds it into the shift
    if epi == "bias":
        with torch.no_grad():
            routed = conv_ops.sparse_conv3(_t(x), _t(w), lvl, bias=_t(bias))
        assert torch.equal(routed, got)


@pytest.mark.parametrize("cin", [8, 3])
def test_twin_ignores_rubbish_in_padding_rows(cin):
    """Unlike the TPU kernel, the port's must not need zero padding rows:
    with noise there the twin still equals the dense oracle on valid rows
    (and kernel 1's twin everywhere)."""
    nbr, valid, n = _random_level(seed=2)
    rng = np.random.RandomState(3)
    x = rng.randn(N_PAD, cin).astype(np.float32) * 50
    x[:n] = rng.rand(n, cin)
    w = (rng.rand(27, cin, 8) * 0.1).astype(np.float32)
    lvl = _torch_level(nbr, valid)
    got = csr_conv3_fwd_plain(_t(x), _t(w), lvl.csr, lvl.valid)
    np.testing.assert_allclose(got.numpy(), _dense_oracle(x, w, nbr, valid),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), conv3_fwd_plain(_t(x), _t(w), lvl.nbr_idx,
                                     lvl.valid).numpy(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------- the backward
@pytest.fixture(scope="module")
def grads():
    """dx and dW of sum(conv * cot) on one random level: `jax.grad` of the
    JAX package's csr_conv3 (Pallas in interpret mode), the port's _CsrConv3
    and the port's _Conv3 (kernels 4/5's twins) on the same level."""
    nbr, valid, n = _random_level(seed=7)
    rng = np.random.RandomState(8)
    cin = cout = 8
    x = np.zeros((N_PAD, cin), np.float32)
    x[:n] = rng.rand(n, cin)
    w = (rng.rand(27, cin, cout) * 0.1).astype(np.float32)
    cot = rng.rand(N_PAD, cout).astype(np.float32)
    csr = jax_csr.build_csr_graph(nbr, N_PAD)
    valid_j = jnp.asarray(valid)
    ref = jax.jit(jax.grad(
        lambda x, w: (jax_csr.csr_conv3(x, w, csr, valid_j)
                      * jnp.asarray(cot)).sum(), argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    out = {"jax": [np.asarray(g) for g in ref], "n": n}
    lvl = _torch_level(nbr, valid)
    for name, level in (("csr", lvl),
                        ("gather", dataclasses.replace(lvl, csr=None))):
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        y = conv_ops.sparse_conv3(xt, wt, level)
        assert y.grad_fn is not None
        (y * _t(cot)).sum().backward()
        out[name] = [xt.grad.numpy(), wt.grad.numpy()]
    return out


def test_csr_backward_matches_jax_grad(grads):
    """rtol 1e-3 / atol 1e-4 (tests/test_csr_conv.py:83-115)."""
    for got, ref in zip(grads["csr"], grads["jax"]):
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_csr_backward_matches_the_gather_backward(grads):
    """_CsrConv3 against _Conv3 on the same level: the same sums in another
    order, rtol 1e-4 / atol 1e-5."""
    for got, ref in zip(grads["csr"], grads["gather"]):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_csr_backward_skips_dx_of_a_leaf_without_grad():
    """The stem: its input features need no gradient, so no dx is computed;
    dW is (27, Cin, Cout) f32 from kernel 5's wrapper (its twin on the CPU)
    over the level's map, in offset order, and agrees with csr_dw (the
    reference's dW over the pairs) to rtol 1e-5."""
    nbr, valid, n = _random_level(seed=4)
    lvl = _torch_level(nbr, valid)
    rng = np.random.RandomState(5)
    x = _t(rng.rand(N_PAD, 3).astype(np.float32))
    w = _t(rng.rand(27, 3, 8).astype(np.float32)).requires_grad_()
    y = conv_ops.sparse_conv3(x, w, lvl)
    y.sum().backward()
    gm = _t(valid[:, None].astype(np.float32)).expand(-1, 8).contiguous()
    dw = conv3_dw_plain(x, gm, lvl.nbr_idx)
    assert dw.shape == (27, 3, 8) and dw.dtype == torch.float32
    assert torch.equal(w.grad, dw)
    np.testing.assert_allclose(dw.numpy(), csr_dw(x, gm, lvl.csr).numpy(),
                               rtol=1e-5, atol=1e-6)
    k = OFFSETS[5]
    sel = nbr[k] != N_PAD - 1
    np.testing.assert_allclose(
        dw[k].numpy(), x.numpy()[nbr[k][sel]].T @ gm.numpy()[sel], rtol=1e-5,
        atol=1e-6)


def test_csr_dw_is_kernel_5_on_a_collated_level(collated):
    """_CsrConv3's dW (kernel 5's wrapper over the level's map) equals
    csr_dw over the collator's pair tables on level 0 of a `csr_levels`
    batch, f32, rtol 1e-5 (atol 1e-5 of max|csr_dw|: the two sum the same
    products in another order); the forward and dx stay kernel 6's."""
    _, (batch, _) = collated
    lvl = batch.graph.levels[0]
    assert lvl.csr is not None
    rng = np.random.RandomState(11)
    n, cin, cout = lvl.num_padded, 16, 24
    x = _t(rng.randn(n, cin).astype(np.float32)).requires_grad_()
    w = _t((rng.randn(27, cin, cout) * 0.1).astype(np.float32))
    w.requires_grad_()
    cot = _t(rng.randn(n, cout).astype(np.float32))
    calls = []
    plain = conv_ops.conv3_dw
    conv_ops.conv3_dw = lambda *a: (calls.append(1), plain(*a))[1]
    try:
        (conv_ops.sparse_conv3(x, w, lvl) * cot).sum().backward()
    finally:
        conv_ops.conv3_dw = plain
    assert len(calls) == 1
    gm = cot * lvl.valid[:, None].to(torch.float32)
    ref = csr_dw(x.detach(), gm, lvl.csr).numpy()
    np.testing.assert_allclose(w.grad.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(
        x.grad.numpy(), csr_conv3_fwd_plain(
            gm, torch.flip(w.detach(), (0,)).transpose(1, 2).contiguous(),
            lvl.csr, lvl.valid).numpy(), rtol=1e-5, atol=1e-6)


def test_fused_epilogue_under_grad_raises_at_a_csr_level():
    nbr, valid, _ = _random_level(seed=4)
    lvl = _torch_level(nbr, valid)
    w = torch.randn(27, 4, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        conv_ops.sparse_conv3(torch.randn(N_PAD, 4), w, lvl, relu=True)


# ------------------------------------------------------- the whole slice
# The JAX model runs under csr_conv.gather_fallback(), the JAX package's own
# CPU route for its CSR levels (utils/runtime.py:50-52): with the Pallas
# kernel in interpret mode inside the whole model, every grid step is
# emulated in Python and the module takes many minutes. The kernel itself is
# held in interpret mode by the cases above; here the JAX side checks the
# collator's 256-row pads and the router's unfused epilogue at CSR levels.
SMALL = dict(num_classes=3, hidden_dim=32, num_queries=8, num_heads=2,
             dim_feedforward=64, num_decoders=2)
TINY = dict(num_classes=3, hidden_dim=32, num_queries=10, num_heads=2,
            dim_feedforward=64, num_decoders=1, hlevels=(0, 1, 2, 3),
            sample_sizes=(4096,) * 5)
RTOL, ATOL, LOSS_RTOL = 2e-4, 2e-5, 1e-5
LR, STEPS = 1e-4, 20


@pytest.fixture(scope="module")
def scenes():
    return make_batch(2, num_points=1500)


def test_eval_forward_with_csr_levels_matches_jax(scenes):
    """tests/test_torch_mask3d.py's model and tolerance (rtol 2e-4 / atol
    2e-5), `csr_levels=(0,)` on both sides."""
    kw = dict(voxel_size=0.12, fps_queries=8, csr_levels=(0,))
    jbatch, _ = JaxCollator(**kw)(scenes)
    model = JaxMask3D(backbone=Res16UNet14A(out_channels=2),
                      scan_decoder=False, **SMALL)
    with jax_csr.gather_fallback():
        variables = jax.jit(lambda b: model.init(
            {"params": jax.random.PRNGKey(0),
             "sample": jax.random.PRNGKey(1)}, b, train=False,
            is_eval=True))(jbatch)
        variables = random_bn(variables)
        ref = jax.jit(lambda v, b: model.apply(v, b, train=False,
                                               is_eval=True))(variables,
                                                              jbatch)
    tmodel = build_mask3d(torch.float32, backbone="Res16UNet14A", seed=None,
                          **SMALL)
    load_flax_variables(tmodel, variables)
    batch, _ = FreeMaskCollator(**kw)(scenes)
    assert batch.graph.levels[0].csr is not None
    calls = []
    plain = conv_ops.csr_conv3_fwd
    conv_ops.csr_conv3_fwd = lambda *a, **k: (calls.append(1),
                                              plain(*a, **k))[1]
    try:
        out = tmodel(batch)
    finally:
        conv_ops.csr_conv3_fwd = plain
    # level 0 of Res16UNet14A: the stem, block 1's two convs... every k3
    # conv at stride 1 went through the CSR wrapper
    assert len(calls) > 0
    for key in ("backbone_features", "mask_features", "pred_logits",
                "pred_masks_seg", "pred_masks_vox"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


class _Pinned:
    def __init__(self, matched):
        self.matched = torch.from_numpy(np.array(matched)).long()

    def __call__(self, *args):
        return self.matched


@pytest.fixture(scope="module")
def train_runs(scenes):
    """Two train steps with `csr_levels=(0,)` on both sides, as
    tests/test_torch_train.py takes them: the exact solver, the port's steps
    under the JAX steps' matching, gradients read back from Adam's first
    moment."""
    kw = dict(voxel_size=0.06, fps_queries=10, csr_levels=(0,))
    jbatch, _ = JaxCollator(**kw)(scenes)
    model = JaxMask3D(backbone=Res16UNet14A(out_channels=2), **TINY)
    criterion = JaxCriterion(matcher=JaxMatcher(solver="scipy"),
                             num_classes=3)
    trainer = JaxTrainer(model, criterion,
                         jax_make_optimizer(lr=LR, total_steps=STEPS))
    rng = jax.random.PRNGKey(0)
    ref = []
    with jax_csr.gather_fallback():
        variables = jax.jit(lambda b: model.init(
            {"params": jax.random.PRNGKey(0),
             "sample": jax.random.PRNGKey(1)}, b, train=False,
            is_eval=True))(jbatch)
        variables = random_bn(variables)
        variables["params"]["query_proj_1"]["kernel"] *= 8.0

        @jax.jit
        def match(state, batch):
            v = {"params": state.params, "batch_stats": state.batch_stats,
                 "buffers": state.buffers}
            outputs, _ = model.apply(v, batch, train=True,
                                     rngs={"sample": rng},
                                     mutable=["batch_stats"])
            return criterion.matcher(outputs["pred_logits"],
                                     outputs["pred_masks_seg"], batch.target,
                                     "segment_mask", batch.seg_valid)

        step = jax.jit(lambda state, batch: trainer._step_core(
            state, batch, rng, None))
        state = TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           buffers=variables["buffers"],
                           opt_state=trainer.tx.init(variables["params"]))
        for _ in range(2):
            matched = match(state, jbatch)
            mu_prev = state.opt_state[0].mu
            state, losses = step(state, jbatch)
            grads = jax.tree.map(
                lambda m, m0: ((np.float64(m) - 0.9 * np.float64(m0)) / 0.1
                               ).astype(np.float32),
                state.opt_state[0].mu, mu_prev)
            ref.append(jax.tree.map(np.asarray, dict(
                matched=matched, losses=losses, grads=grads,
                params=state.params, batch_stats=state.batch_stats)))

    batch, _ = FreeMaskCollator(**kw)(scenes)
    tr = build_trainer(torch.float32, seed=None, backbone="Res16UNet14A",
                       lr=LR, total_steps=STEPS, solver="scipy", device="cpu",
                       **TINY)
    load_flax_variables(tr.model, variables)
    criterion_t = tr.criterion
    gen = torch.Generator().manual_seed(0)
    names = [n for n, _ in tr.model.named_parameters()]
    got = []
    for s in range(2):
        tr.criterion = dataclasses.replace(
            criterion_t, matcher=_Pinned(ref[s]["matched"]))
        losses, grads = tr.loss_and_grads(batch, gen)
        tr.optimizer.step(tr.params, grads)
        for bn in tr._bns:
            bn.update_running_stats()
        got.append(dict(losses=losses, grads=dict(zip(names, grads)),
                        state={k: v.clone() for k, v in
                               tr.model.state_dict().items()}))
    return ref, got


@pytest.mark.parametrize("step", [0, 1])
def test_train_step_with_csr_levels_matches_jax(train_runs, step):
    """Losses rel 1e-5; gradients atol 2e-5 + rtol 2e-4 of each tensor's
    largest entry; params and BN running stats rtol 2e-4 / atol 2e-5, the
    keys' biases within two learning rates per step (their exact gradient is
    zero): tests/test_torch_train.py's tolerances."""
    ref, got = train_runs[0][step], train_runs[1][step]
    for key in ("loss_ce", "loss_mask", "loss_dice", "total", "num_masks"):
        np.testing.assert_allclose(
            got["losses"][key].numpy(), np.asarray(ref["losses"][key]),
            rtol=LOSS_RTOL, atol=0, err_msg=key)
    ref_g = torch_params_from_flax(ref["grads"])
    assert set(ref_g) == set(got["grads"])
    off = []
    for name, g in got["grads"].items():
        r = ref_g[name].numpy()
        err = np.abs(g.numpy() - r).max()
        if not err <= ATOL + RTOL * np.abs(r).max():
            off.append((name, err, np.abs(r).max()))
    assert not off, off
    ref_s = torch_state_from_flax({"params": ref["params"],
                                   "batch_stats": ref["batch_stats"]})
    from unscene3d_torch.train.loop import make_optimizer
    sched = make_optimizer(lr=LR, total_steps=STEPS).schedule
    noise_bound = ATOL + 2 * sum(sched(i) for i in range(step + 1))
    for name, v in ref_s.items():
        if name.endswith("k_proj.bias"):
            assert (got["state"][name] - v).abs().max() <= noise_bound, name
        else:
            np.testing.assert_allclose(got["state"][name].numpy(), v.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
