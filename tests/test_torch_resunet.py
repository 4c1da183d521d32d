"""The MinkUNet / sparse ResNet families of the PyTorch port against the JAX
package: the k3 stride-2 maps bitwise, the stride-2 ops and pools (kernel
2's plain twin on the CPU) and their gradients against `jax.grad`, the tiny
ResUNet14 / ResNet14 eval forwards of tests/test_resunet.py on bridged
weights, `CrossEntropyLoss` with ignored labels, and the name registry.

Inputs come from numpy seeds; tolerances are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_jax import one_torch_thread, random_bn  # noqa: F401
from unscene3d_tpu import models as jax_models
from unscene3d_tpu.losses.criterion import CrossEntropyLoss as JaxCE
from unscene3d_tpu.models.resunet import ResNet14 as JaxResNet14
from unscene3d_tpu.models.resunet import ResUNet14 as JaxResUNet14
from unscene3d_tpu.ops import conv_ops as jax_ops
from unscene3d_tpu.ops.kernel_maps import \
    build_sparse_graph as jax_build_sparse_graph
from unscene3d_torch import models
from unscene3d_torch.config import instantiate
from unscene3d_torch.losses.criterion import CrossEntropyLoss
from unscene3d_torch.models.resunet import ResNet14, ResUNet14
from unscene3d_torch.models.weights import load_flax_backbone_variables
from unscene3d_torch.ops import conv_ops
from unscene3d_torch.ops.kernel_maps import (KERNEL3_OFFSETS,
                                             build_sparse_graph)
from unscene3d_torch.ops.sparse_graph import graph_from_levels

RTOL, ATOL = 2e-4, 2e-5


def coords_set(n=500, extent=20, seed=3):
    """tests/test_resunet.py:coords_set: unique random voxels of 2 scenes."""
    r = np.random.RandomState(seed)
    return np.unique(np.column_stack([
        r.randint(0, 2, 4 * n), r.randint(-extent, extent, (4 * n, 3))
    ]), axis=0)[:n].astype(np.int32)


@pytest.fixture(scope="module")
def graphs():
    coords = coords_set(n=800, extent=40, seed=5)
    ref = jax_build_sparse_graph(coords, num_levels=6,
                                 build_down_nbr_maps=True)
    got = graph_from_levels(build_sparse_graph(coords, num_levels=6,
                                               build_down_nbr_maps=True))
    return ref, got


def test_down_neighbour_maps_equal_jax_bitwise(graphs):
    """Every level's (27, N) k3 stride-2 map equals the JAX map; the
    transposed table inverts it: fine row i under offset k reads the one
    coarse row whose map entry k is i, a miss everywhere else."""
    ref, got = graphs
    assert got.levels[0].down_nbr_idx is None
    for li in range(1, 6):
        want = np.asarray(ref.levels[li].down_nbr_idx)
        lv = got.levels[li]
        np.testing.assert_array_equal(lv.down_nbr_idx.numpy(), want)
        n_c, n_f = lv.num_padded, lv.finer_num_padded
        oracle = np.full((27, n_f), n_c - 1, np.int64)
        for k in range(27):
            hits = np.nonzero(want[k] != n_f - 1)[0]
            oracle[k, want[k, hits]] = hits
        np.testing.assert_array_equal(lv.down_nbr_t.numpy(), oracle)


def test_down_neighbour_map_oracle(graphs):
    """tests/test_resunet.py:test_down_nbr_map_oracle on the port's map."""
    _, got = graphs
    fine, coarse = got.levels[0], got.levels[1]
    nf = int(fine.valid.sum())
    lut = {tuple(c): i for i, c in enumerate(fine.coords.numpy()[:nf])}
    cc = coarse.coords.numpy()
    d = coarse.down_nbr_idx.numpy()
    for j in range(0, int(coarse.valid.sum()), 7):
        for k in (0, 13, 26):
            q = (cc[j, 0], *(cc[j, 1:] * 2 + KERNEL3_OFFSETS[k]))
            assert d[k, j] == lut.get(q, fine.num_padded - 1)


def _x(level, c, seed):
    rng = np.random.RandomState(seed)
    x = np.zeros((level.num_padded, c), np.float32)
    n = int(level.valid.sum())
    x[:n] = rng.randn(n, c)
    return x


def _ops(lv):
    """(name, port op, JAX op, weight shape) over fine level lv - 1 and
    coarse level lv."""
    return [
        ("sparse_conv3_down2",
         lambda x, w, g: conv_ops.sparse_conv3_down2(
             x, w, g.levels[lv], fine=g.levels[lv - 1]),
         lambda x, w, g: jax_ops.sparse_conv3_down2(x, w, g.levels[lv]),
         (27, 6, 5)),
        ("sparse_conv1_down2",
         lambda x, w, g: conv_ops.sparse_conv1_down2(
             x, w, g.levels[lv], fine=g.levels[lv - 1]),
         lambda x, w, g: jax_ops.sparse_conv1_down2(x, w, g.levels[lv]),
         (6, 5)),
        ("sum_pool2",
         lambda x, w, g: conv_ops.sum_pool2(x, g.levels[lv],
                                            g.levels[lv - 1]),
         lambda x, w, g: jax_ops.sum_pool2(x, g.levels[lv]), None),
        ("max_pool2",
         lambda x, w, g: conv_ops.max_pool2(x, g.levels[lv]),
         lambda x, w, g: jax_ops.max_pool2(x, g.levels[lv]), None),
    ]


@pytest.mark.parametrize("lv", [1, 3])
@pytest.mark.parametrize("op", range(4), ids=[o[0] for o in _ops(1)])
def test_stride2_ops_and_gradients_match_jax(graphs, lv, op):
    """Forward rtol 2e-4 / atol 2e-5; for the ops with an autograd
    Function (the k3 and k1 stride-2 convs, the sum pool) dx and dW of
    sum(out * r) against jax.grad at the same tolerance, relative to each
    gradient's largest entry."""
    ref, got = graphs
    name, fn, jfn, wshape = _ops(lv)[op]
    x = _x(got.levels[lv - 1], 6, seed=lv)
    rng = np.random.RandomState(10 + lv)
    w = None if wshape is None else (rng.randn(*wshape) * 0.3).astype(
        np.float32)
    out_j = jfn(jnp.asarray(x), None if w is None else jnp.asarray(w), ref)
    r = rng.randn(*out_j.shape).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    wt = None if w is None else torch.tensor(w, requires_grad=True)
    out = fn(xt, wt, got)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL, err_msg=name)
    if name == "max_pool2":
        return
    (out * torch.from_numpy(r)).sum().backward()
    if w is None:
        gx = jax.grad(lambda a: (jfn(a, None, ref) * r).sum())(jnp.asarray(x))
        pairs = [(xt.grad, gx)]
    else:
        gx, gw = jax.grad(lambda a, b: (jfn(a, b, ref) * r).sum(),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        pairs = [(xt.grad, gx), (wt.grad, gw)]
    for g, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=ATOL + RTOL * np.abs(want).max(),
                                   err_msg=name)


def test_unpool_nearest_matches_jax(graphs):
    ref, got = graphs
    x = _x(got.levels[2], 5, seed=4)
    want = jax_ops.unpool_nearest(jnp.asarray(x), ref.levels[1])
    out = conv_ops.unpool_nearest(torch.from_numpy(x), got.levels[1])
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("family", ["ResUNet14", "ResNet14"])
def test_tiny_forward_matches_jax_on_bridged_weights(graphs, family):
    """tests/test_resunet.py:test_minkunet_and_resnet_forward's configs,
    eval mode, random BatchNorm state, rtol 2e-4 / atol 2e-5 relative to
    the output's largest entry."""
    ref, got = graphs
    feats = _x(got.levels[0], 3, seed=6)
    if family == "ResUNet14":
        kw = dict(out_channels=4, init_dim=16,
                  planes=(16, 24, 32, 48, 32, 24, 24))
        jnet, net = JaxResUNet14(**kw), ResUNet14(**kw)
    else:
        kw = dict(out_channels=4, init_dim=16, planes=(16, 24, 32, 48))
        jnet, net = JaxResNet14(**kw), ResNet14(**kw)
    variables = random_bn(jnet.init(jax.random.PRNGKey(0),
                                    jnp.asarray(feats), ref))
    want = np.asarray(jnet.apply(variables, jnp.asarray(feats), ref,
                                 train=False))
    load_flax_backbone_variables(net, variables)
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(feats), got).numpy()
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def test_cross_entropy_matches_jax_with_ignored_labels():
    rng = np.random.RandomState(0)
    logits = rng.randn(64, 20).astype(np.float32) * 3
    labels = rng.randint(0, 20, 64)
    labels[::5] = 255
    want = float(JaxCE(ignore_index=255)(jnp.asarray(logits),
                                         jnp.asarray(labels)))
    got = CrossEntropyLoss(ignore_index=255)(torch.from_numpy(logits),
                                             torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    assert CrossEntropyLoss()(torch.from_numpy(logits),
                              torch.full((64,), 255)).item() == 0.0


def test_registry_resolves_every_jax_name():
    """The 16 names of the JAX registry, each to the port's class of that
    name; a config `_target_` of the JAX module builds the port's model."""
    names = sorted(jax_models._MODELS)
    assert len(names) == 16
    for name in names:
        cls = models.load_model(name)
        assert cls.__name__ == name
        assert cls.__module__.startswith("unscene3d_torch.models")
    with pytest.raises(KeyError, match="unknown model"):
        models.load_model("ResUNet50")
    net = instantiate({"_target_": "unscene3d_tpu.models.resunet.ResUNet34",
                       "out_channels": 20})
    assert isinstance(net, models.load_model("ResUNet34"))
    assert net.layers == (2, 3, 4, 6, 2, 2)
    assert isinstance(instantiate({
        "_target_": "unscene3d_tpu.losses.criterion.CrossEntropyLoss",
        "ignore_index": 255}), CrossEntropyLoss)


def test_resnet_train_step_reaches_every_parameter(graphs):
    """Train mode on the CPU: the stride-2 blocks' k3 and k1 convs and the
    sum pool run their autograd Functions; CrossEntropyLoss over the
    level-5 rows gives a finite gradient to every parameter and each
    BatchNorm keeps its batch statistics."""
    _, got = graphs
    torch.manual_seed(0)
    net = ResNet14(out_channels=4, init_dim=16, planes=(16, 24, 32, 48))
    for p in net.parameters():
        torch.nn.init.normal_(p, std=0.2)
    feats = torch.from_numpy(_x(got.levels[0], 3, seed=8))
    out = net.train()(feats, got)
    lv5 = got.levels[5]
    labels = torch.where(lv5.valid, torch.arange(lv5.num_padded) % 4,
                         torch.full((lv5.num_padded,), 255))
    CrossEntropyLoss()(out, labels).backward()
    for name, p in net.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert net.layer1_0.conv1.kernel.grad.abs().sum() > 0
    assert net.layer1_0.downsample_conv.kernel.grad.abs().sum() > 0
    assert all(bn.batch_stats is not None for bn in net.modules()
               if hasattr(bn, "batch_stats"))
