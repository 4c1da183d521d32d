"""The row order of kernel 1 and 4's dx (unscene3d_torch/ops/conv3.py:
row_order) on the CPU: the order and its tally against a numpy twin on a
level of a `make_scene` batch and on a hand-built level, one order per level
kept on the LevelGraph, the twins' indifference to it, the tracer's device
counts it feeds, and the benchmark's reader of them."""

import numpy as np
import pytest
import torch

from portbench import manifest
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.ops import conv_ops
from tests._row_order import own_order
from unscene3d_torch.ops.conv3 import (conv3_bwd, conv3_fwd, level_order,
                                       row_order)
from unscene3d_torch.utils import trace


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def levels():
    scene = make_scene(num_points=6_000, num_objects=3, extent=2.0, seed=4)
    batch, _ = FreeMaskCollator(voxel_size=0.02, fps_queries=8)([scene])
    return batch.graph.levels


def _hand_map():
    """A (27, 70) map, no multiple of 32 rows: rows 0-59 valid with their
    centre and a few neighbours by a fixed pattern, rows 60-69 padding."""
    n = 70
    nbr = np.full((27, n), n - 1, np.int32)
    for i in range(60):
        nbr[13, i] = i
        for k in (i % 5, 26 - i % 7, (3 * i) % 27):
            nbr[k, i] = (i + k) % 60
    return nbr, np.arange(n) < 60


def _numpy_order(nbr):
    """(order, sorted keys, live (offset, group) pairs, valid pairs)."""
    n = nbr.shape[1]
    hit = nbr != n - 1
    keys = (hit.astype(np.int64) << np.arange(27)[:, None]).sum(0)
    order = np.argsort(keys, kind="stable").astype(np.int32)
    srt = hit[:, order]
    srt = np.pad(srt, ((0, 0), (0, -n % 32)))
    live = int(srt.reshape(27, -1, 32).any(-1).sum())
    return order, keys[order].astype(np.int32), live, int(hit.sum())


@pytest.mark.parametrize("case", ["L0", "L2", "hand"])
def test_row_order_equals_the_numpy_twin(levels, case):
    if case == "hand":
        nbr, valid = _hand_map()
    else:
        lvl = levels[int(case[1])]
        nbr, valid = lvl.nbr_idx.numpy(), lvl.valid.numpy()
    got = row_order(torch.from_numpy(nbr))
    order, keys, live, pairs = _numpy_order(nbr)
    assert got.order.dtype == got.keys.dtype == torch.int32
    assert np.array_equal(got.order.numpy(), order)
    assert np.array_equal(got.keys.numpy(), keys)
    assert (int(got.live_groups), int(got.pairs)) == (live, pairs)
    # padding rows (mask 0) first, then every valid row (its centre is set)
    n_pad = int((~valid).sum())
    assert not valid[order[:n_pad]].any() and valid[order[n_pad:]].all()
    # never fewer products than the pairs; at a scene's level fewer than
    # in the rows' own order (not a rule: a sort need not find the fewest)
    own = own_order(torch.from_numpy(nbr))
    assert torch.equal(own.order, torch.arange(len(valid),
                                               dtype=torch.int32))
    assert int(own.pairs) == pairs <= 32 * live
    if case != "hand":
        assert live < int(own.live_groups)


def test_level_order_is_built_once_and_shared(levels):
    """The CPU twins of a k3 conv's forward and dx build no order; the
    level keeps the order level_order builds, returns that one instance
    again, and moving the level carries it. (On the card the train step's
    five builds: tests/test_torch_cuda.py.)"""
    lvl = levels[1].to("cpu")
    lvl.order = None
    g = torch.Generator().manual_seed(0)
    x = torch.randn(lvl.num_padded, 8, generator=g, requires_grad=True)
    w = torch.randn(27, 8, 4, generator=g, requires_grad=True)
    out = conv_ops.sparse_conv3(x, w, lvl)
    out.sum().backward()
    assert lvl.order is None
    built = level_order(lvl)
    assert lvl.order is built and level_order(lvl) is built
    moved = lvl.to("cpu")
    assert torch.equal(moved.order.order, built.order)


def test_twins_accept_an_order_and_ignore_it(levels):
    lvl = levels[1]
    n = lvl.num_padded
    g = torch.Generator().manual_seed(1)
    x = torch.randn(n, 6, generator=g)
    w = torch.randn(27, 6, 5, generator=g)
    gm = torch.randn(n, 5, generator=g) * lvl.valid[:, None]
    order = row_order(lvl.nbr_idx)
    assert torch.equal(conv3_fwd(x, w, lvl.nbr_idx, lvl.valid, order=order),
                       conv3_fwd(x, w, lvl.nbr_idx, lvl.valid))
    for a, b in zip(conv3_bwd(x, gm, w, lvl.nbr_idx, lvl.valid, order=order),
                    conv3_bwd(x, gm, w, lvl.nbr_idx, lvl.valid)):
        assert torch.equal(a, b)


def test_row_order_refuses_a_map_of_another_shape():
    with pytest.raises(ValueError, match="want"):
        row_order(torch.zeros(8, 16, dtype=torch.int32))


def test_device_counts_are_read_after_the_window():
    """A 0-d tensor counted with a host multiplier: kept while recording,
    read in summary(); nothing while off; reset() forgets it."""
    trace.reset()
    a, b = torch.tensor(7), torch.tensor(5, dtype=torch.int64)
    trace.count("macs", a, 3)
    with trace.recording():
        trace.count("macs", a, 3)
        trace.count("macs", a, 10)
        trace.count("macs", b, 2)
        trace.count("macs", 4)
        trace.count("other", b)
    assert trace.summary()["counters"] == {"macs": 7 * 13 + 5 * 2 + 4,
                                           "other": 5}
    assert trace.summary()["counters"]["macs"] == 105
    with trace.recording():
        trace.count("late", a, 2)
    trace.reset()
    assert trace.summary()["counters"] == {}


@pytest.mark.parametrize("metric", ["conv_dense_ratio.train",
                                    "conv_dense_ratio.train.small"])
def test_the_dense_ratio_metric_reads_the_counters(monkeypatch, metric):
    read = manifest.metric_reader(metric)
    s = {"spans": {"step": {"n": 2, "host_ms": [1.0] * 2,
                            "device_ms": []}},
         "counters": {"conv3.dense_macs": 640, "conv3.pair_macs": 400}}
    monkeypatch.setattr(trace, "summary", lambda: s)
    assert read({}) == 1.6
    s["counters"] = {"auction_rounds": 3}
    assert read({}) is None
