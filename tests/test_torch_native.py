"""The port's native host library (`unscene3d_torch/native`, C++ built with
g++ at first use) against three references, bitwise: the port's own numpy
twins (`native=False`), the JAX package's C++ library
(`unscene3d_tpu/native`) and the JAX package's numpy paths. Covered: the
padded k3 neighbour map (sorted coords take the two-pointer merge, shuffled
ones the flat hash), furthest point sampling with distance ties and invalid
rows, and the two window-table passes with and without spilled pairs; the
counterparts of tests/test_native.py. Also: a build whose compiler is
missing or fails raises, a nonzero return code raises, and the collator's
two routes give the same batch while the call counters show which one
served it.

Tolerance: none, every comparison is exact (integer tables; the FPS seeds
are indices chosen by f32 arithmetic that both sides run in the same
order).
"""

import os
import stat

import numpy as np
import pytest

import unscene3d_tpu.native as jnative
from unscene3d_tpu.data.collate import fps_numpy as jax_fps
from unscene3d_tpu.ops import window_conv as jwc
from unscene3d_tpu.ops.kernel_maps import (
    build_neighbor_map_padded as jax_nbr_padded)
from tests.test_native import grid_mesh as jax_grid_mesh
from unscene3d_torch import native
from unscene3d_torch.data.collate import FreeMaskCollator, fps_numpy
from unscene3d_torch.data.synthetic import (make_batch, make_mesh_scene,
                                            make_scene)
from unscene3d_torch.ops.kernel_maps import (KERNEL3_OFFSETS,
                                             build_neighbor_map_padded)
from unscene3d_torch.ops.win_graph import build_win_graph

WIN_FIELDS = ("r0", "starts", "lidx", "spill_out", "spill_in", "spill_k",
              "spill_rows", "sp_q0", "sp_qn")


def _jax_numpy(monkeypatch):
    """Send the JAX package's callers to their numpy paths."""
    for name in ("build_neighbor_map_native",
                 "build_neighbor_map_padded_native",
                 "furthest_point_sample_native", "win_tables_native",
                 "win_fill_lidx_native"):
        monkeypatch.setattr(jnative, name, lambda *a: None)


@pytest.mark.parametrize("shuffled", [False, True], ids=["sorted", "shuffled"])
def test_neighbor_map_padded_bitwise(monkeypatch, shuffled):
    r = np.random.RandomState(0)
    coords = np.unique(np.column_stack([
        r.randint(0, 3, 3000), r.randint(-8, 8, (3000, 3))]),
        axis=0).astype(np.int32)
    if shuffled:
        coords = coords[r.permutation(len(coords))]
    n_pad = (len(coords) // 128 + 2) * 128
    before = native.build_neighbor_map_padded.calls
    got = build_neighbor_map_padded(coords, n_pad)
    assert native.build_neighbor_map_padded.calls == before + 1
    assert got.dtype == np.int32 and got.shape == (27, n_pad)
    twin = build_neighbor_map_padded(coords, n_pad, native=False)
    assert native.build_neighbor_map_padded.calls == before + 1
    jax_cpp = jnative.build_neighbor_map_padded_native(
        coords, KERNEL3_OFFSETS, n_pad, n_pad - 1)
    _jax_numpy(monkeypatch)
    jax_np = jax_nbr_padded(coords, n_pad)
    for name, ref in (("numpy twin", twin), ("JAX C++", jax_cpp),
                      ("JAX numpy", jax_np)):
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert (got[13, :len(coords)] == np.arange(len(coords))).all()
    assert (got[:, len(coords):] == n_pad - 1).all()
    hits = got[:, :len(coords)] != n_pad - 1
    assert 0.2 < hits.mean() < 0.8   # both hits and misses are exercised


def _fps_case(n=20_000, seed=1):
    r = np.random.RandomState(seed)
    xyz = (r.randn(n, 3) * 3).astype(np.float32)
    # duplicated points force distance ties: the first maximum must win
    xyz[n // 2:n // 2 + 500] = xyz[:500]
    valid = np.ones(n, bool)
    valid[-2048:] = False
    xyz[-1024:] = 100.0      # far invalid rows must never be chosen
    return xyz, valid


@pytest.mark.parametrize("k", [1, 100])
def test_fps_bitwise(monkeypatch, k):
    xyz, valid = _fps_case()
    before = native.furthest_point_sample.calls
    got = fps_numpy(xyz, valid, k)
    assert native.furthest_point_sample.calls == before + 1
    assert got.dtype == np.int32 and got.shape == (k,)
    twin = fps_numpy(xyz, valid, k, native=False)
    jax_cpp = jnative.furthest_point_sample_native(xyz, valid, k)
    _jax_numpy(monkeypatch)
    jax_np = jax_fps(xyz, valid, k)
    for name, ref in (("numpy twin", twin), ("JAX C++", jax_cpp),
                      ("JAX numpy", jax_np)):
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert valid[got].all()
    assert len(np.unique(got)) == k


def test_fps_ties_take_the_first_maximum():
    """Four equidistant corners from the start: the lowest index wins each
    round, as numpy's argmax."""
    xyz = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0],
                    [0, -1, 0], [0, 0, 0]], np.float32)
    valid = np.ones(6, bool)
    got = fps_numpy(xyz, valid, 4)
    np.testing.assert_array_equal(got, fps_numpy(xyz, valid, 4, native=False))
    np.testing.assert_array_equal(got, [0, 1, 2, 3])


@pytest.fixture(scope="module")
def level0():
    scene = make_scene(num_points=12_000, num_objects=4, extent=3.0, seed=3)
    lvl = FreeMaskCollator(voxel_size=0.02)([scene])[0].graph.levels[0]
    return len(lvl.valid), lvl.nbr_idx.numpy()


@pytest.mark.parametrize("w_sub,w_union", [(384, 4096), (256, 512)],
                         ids=["wide", "spilling"])
def test_win_tables_bitwise(monkeypatch, level0, w_sub, w_union):
    n_pad, nbr = level0
    kw = dict(w_sub=min(w_sub, n_pad), w_union=min(w_union, n_pad))
    before = native.calls()
    got = build_win_graph(nbr, n_pad, **kw)
    after = native.calls()
    assert after["win_lo_reg"] == before["win_lo_reg"] + 1
    assert after["win_fill_lidx"] == before["win_fill_lidx"] + 1
    refs = {"numpy twin": build_win_graph(nbr, n_pad, native=False, **kw),
            "JAX C++": jwc.build_win_graph(nbr, n_pad, **kw)}
    # the first pass alone, against the JAX library's
    np.testing.assert_array_equal(native.win_lo_reg(nbr, n_pad, 256),
                                  jnative.win_tables_native(nbr, n_pad, 256))
    _jax_numpy(monkeypatch)
    refs["JAX numpy"] = jwc.build_win_graph(nbr, n_pad, **kw)
    for name, ref in refs.items():
        for f in WIN_FIELDS:
            np.testing.assert_array_equal(
                getattr(got, f), np.asarray(getattr(ref, f)),
                err_msg=f"{name}: {f}")
        assert got.spill_q == ref.spill_q, name
    assert (got.num_spills > 0) == (w_union == 512)


def test_collate_routes_agree_and_counters_show_the_route():
    scenes = make_batch(2, num_points=1500)
    kw = dict(voxel_size=0.12, fps_queries=8)
    native.reset_calls()
    got, _ = FreeMaskCollator(**kw)(scenes)
    assert native.calls()["build_neighbor_map_padded"] == 5
    assert native.calls()["furthest_point_sample"] == 2
    ref, _ = FreeMaskCollator(native=False, **kw)(scenes)
    assert native.calls()["build_neighbor_map_padded"] == 5
    assert native.calls()["furthest_point_sample"] == 2
    np.testing.assert_array_equal(got.fps_idx.numpy(), ref.fps_idx.numpy())
    for lg, lr in zip(got.graph.levels, ref.graph.levels):
        np.testing.assert_array_equal(lg.nbr_idx.numpy(), lr.nbr_idx.numpy())


def test_missing_compiler_raises(tmp_path):
    with pytest.raises(RuntimeError, match="host compiler"):
        native.build(cxx=str(tmp_path / "no-such-g++"),
                     build_dir=str(tmp_path))


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    """A compiler that answers the target query and then fails: the error
    carries its output, and no library is left behind."""
    cxx = tmp_path / "broken-g++"
    cxx.write_text("#!/bin/sh\n"
                   "case \"$*\" in *--help=target*) echo native; exit 0;; "
                   "esac\n"
                   "echo 'kernel_maps.cpp: error: broken on purpose' >&2\n"
                   "exit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IXUSR)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="broken on purpose"):
        native.build(cxx=str(cxx), build_dir=str(out))
    assert not [f for f in os.listdir(out) if f.endswith(".so")]


def test_nonzero_return_code_raises():
    coords = np.array([[0, 0, 0, 0], [0, 1, 0, 0]], np.int32)
    with pytest.raises(RuntimeError, match="returned 1"):   # no padding row
        native.build_neighbor_map_padded(coords, KERNEL3_OFFSETS, 2, 1)
    with pytest.raises(RuntimeError, match="returned 1"):   # no points
        native.furthest_point_sample(np.zeros((0, 3), np.float32),
                                     np.zeros(0, bool), 4)


@pytest.mark.parametrize("native_route", [True, False], ids=["C++", "numpy"])
def test_coordinates_out_of_the_hashable_range_raise(native_route):
    """Both routes reject a coordinate whose neighbour leaves the keys'
    18-bit range, and a batch index outside [0, 256)."""
    edge = np.array([[0, 0, 0, 0], [0, (1 << 17) - 1, 0, 0]], np.int32)
    with pytest.raises(OverflowError, match="hashable range"):
        build_neighbor_map_padded(edge, 128, native=native_route)
    inside = np.array([[0, 0, 0, 0], [0, (1 << 17) - 2, -(1 << 17) + 1, 5]],
                      np.int32)
    got = build_neighbor_map_padded(inside, 128, native=native_route)
    assert (got[13, :2] == [0, 1]).all()
    with pytest.raises(OverflowError, match="batch index"):
        build_neighbor_map_padded(np.array([[256, 0, 0, 0]], np.int32), 128,
                                  native=native_route)


@pytest.mark.parametrize("grid,thr,min_verts", [(60, 0.005, 20),
                                                (60, 0.005, 50),
                                                (40, 0.02, 4)])
def test_segment_mesh_bitwise(grid, thr, min_verts):
    """The port's C++ equals the JAX package's C++, and the port's numpy
    twin the JAX package's numpy path. The JAX package's two paths are not
    one algorithm (union by rank in f32 against a fixed root in f64): on
    these meshes their partitions differ (e.g. 58 against 59 segments), so
    C++ against numpy is held where tests/test_native.py holds it, below."""
    mesh = make_mesh_scene(grid=grid, num_objects=6, seed=grid)
    v, f = mesh["vertices"], mesh["faces"]
    c = mesh["colors"].astype(np.float32) / 255.0
    before = native.segment_mesh.calls
    seg, pairs = native.segment_mesh(v, f, c, thr, min_verts)
    assert native.segment_mesh.calls == before + 1
    assert seg.dtype == pairs.dtype == np.int32 and seg.shape == (len(v),)
    n = seg.max() + 1
    assert set(np.unique(seg)) == set(range(n)) and 3 < n < len(v) // 10
    assert pairs.shape[1] == 2 and (pairs[:, 0] != pairs[:, 1]).all()
    jseg, jpairs = jnative.segment_mesh(v, f, c, thr, min_verts)
    np.testing.assert_array_equal(seg, jseg)
    np.testing.assert_array_equal(pairs, jpairs)
    tseg, tpairs = native.segment_mesh_numpy(v, f, c, thr, min_verts)
    assert native.segment_mesh.calls == before + 1
    nseg, npairs = jnative._segment_mesh_numpy(v, f.astype(np.int32), c,
                                               thr, min_verts)
    np.testing.assert_array_equal(tseg, nseg)
    np.testing.assert_array_equal(tpairs, npairs)


@pytest.mark.parametrize("case", [dict(nx=12, ny=12, seed=3, kthr=0.02,
                                       min_verts=4),
                                  dict(nx=20, ny=20, seed=0, kthr=0.01,
                                       min_verts=5)])
def test_segment_mesh_equals_both_jax_paths_on_their_fixtures(case):
    """tests/test_native.py's meshes, where its C++ and numpy paths agree:
    the port's C++ equals both."""
    verts, faces, colors = jax_grid_mesh(case["nx"], case["ny"],
                                         seed=case["seed"])
    args = (case["kthr"], case["min_verts"])
    seg, pairs = native.segment_mesh(verts, faces, colors, *args)
    for name, (rs, rp) in (
            ("JAX C++", jnative.segment_mesh(verts, faces, colors, *args)),
            ("JAX numpy", jnative._segment_mesh_numpy(verts, faces, colors,
                                                      *args)),
            ("numpy twin", native.segment_mesh_numpy(verts, faces, colors,
                                                     *args))):
        np.testing.assert_array_equal(seg, rs, err_msg=name)
        np.testing.assert_array_equal(pairs, rp, err_msg=name)


def test_segment_mesh_bounds_its_pair_buffer_and_checks_its_input(
        monkeypatch):
    """A mesh of one face per segment: its pairs fill a large share of the
    wrapper's buffer of 3 pairs per face, the C++'s bound (one pair per
    edge). The C++ reports a buffer below the pairs it found as -needed;
    the wrapper raises on such a report."""
    mesh = make_mesh_scene(grid=80, num_objects=0, seed=1)
    v, f = mesh["vertices"], mesh["faces"]
    c = np.random.RandomState(0).rand(len(v), 3).astype(np.float32)
    seg, pairs = native.segment_mesh(v, f, c, 1e-9, 1)
    jseg, jpairs = jnative.segment_mesh(v, f, c, 1e-9, 1)
    assert len(f) < len(pairs) <= 3 * len(f)
    np.testing.assert_array_equal(seg, jseg)
    np.testing.assert_array_equal(pairs, jpairs)
    small = np.empty((100, 2), np.int32)
    comps = np.empty(len(v), np.int32)
    v32, f32 = v.astype(np.float32), f.astype(np.int32)
    n = native.load().segment_mesh(
        native._ptr(v32), len(v), native._ptr(f32), len(f),
        native._ptr(c), 1e-9, 1, native._ptr(comps), native._ptr(small), 100)
    assert n == -len(pairs)
    np.testing.assert_array_equal(comps, seg)

    class Overflowing:
        def segment_mesh(self, *args):
            return -(3 * len(f) + 1)
    monkeypatch.setattr(native, "load", Overflowing)
    with pytest.raises(RuntimeError, match="overflow"):
        native.segment_mesh(v, f, c, 1e-9, 1)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="out of range"):
        native.segment_mesh(v, f + len(v), c)
    with pytest.raises(ValueError, match="colors"):
        native.segment_mesh(v, f, c[:-1])
