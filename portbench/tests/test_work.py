"""The work counts against chip_smoke.py's printed counts, and the trace
reduction on made-up intervals."""

import numpy as np
import pytest

from portbench import scenes, trace
from portbench.reference import collate
from portbench.work import least_seconds, sparse


@pytest.fixture(scope="module")
def bench_l0_pairs():
    """The bench scene's level-0 valid pairs (make_scene(250_000, 12, 8.0,
    seed 0) at 2 cm)."""
    s = scenes.make_scene(250_000, 12, 8.0, 0)
    vox, _ = collate.sparse_quantize(s["xyz"], 0.02)
    coords = np.column_stack([np.zeros(len(vox), np.int32), vox])
    return sparse.hits(collate.neighbor_map(coords, len(vox) + 1))


def test_k3_conv_counts_equal_chip_smokes(bench_l0_pairs):
    """L0 128 -> 96 with the fused epilogue and a residual over the bench
    scene's 204,800 padded rows: 42.52 GFLOP; 154.1 MB bf16, 285.8 MB f32."""
    for it, mb in ((2, 154.1), (4, 285.8)):
        flops, nbytes = sparse.k3_fwd(204_800, bench_l0_pairs, 128, 96, it,
                                      epilogue=True, residual=True)
        assert round(flops / 1e9, 2) == 42.52
        assert round(nbytes / 1e6, 1) == mb


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(67e12, 0) == pytest.approx(1.0)
    assert least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert least_seconds(67e9, 3.35e12) == pytest.approx(1.0)


def test_reduce_intervals_union_and_idle_gaps():
    """Busy time is the union of the device intervals inside the window;
    each idle gap goes to the host span open when it began."""
    marks = [(0, "h2d"), (100, "backbone"), (400, "criterion")]
    iv = [(50, 150, "k1"), (120, 200, "k2"), (300, 350, "k1"),
          (900, 1200, "k3")]
    out = trace.reduce_intervals(iv, 0, 1000, marks)
    assert out["busy_s"] == pytest.approx(300e-9)
    assert out["window_s"] == pytest.approx(1000e-9)
    assert out["by_name"] == pytest.approx({"k1": 150e-9, "k2": 80e-9,
                                            "k3": 100e-9})
    assert out["gaps"] == pytest.approx({"h2d": 50e-9, "backbone": 650e-9})
    assert out["device_events"] == 4
    b = trace.breakdown(out)
    assert b["device_ops"][0] == ["k1", pytest.approx(150e-9)]
    assert b["idle_gaps"][0] == ["backbone", pytest.approx(650e-9)]
