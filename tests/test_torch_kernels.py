"""The kernel modules of the PyTorch port against the JAX package.

On the CPU each wrapper runs its plain twin, and the twin is held against
the JAX function: kernel 1 against window_conv3_fwd run through the Pallas
interpreter (as tests/test_window_conv.py runs it), kernel 2 against
window_k_apply (its XLA reference on the CPU) for down, up and pool tables,
kernel 3 against tile_segment_sum, kernels 4 and 5 (the k3 backward)
against window_conv3_bwd_fused and window_conv3_dw in the Pallas
interpreter, on window graphs with and without spills.
tests/test_torch_cuda.py holds each CUDA kernel against its twin on the
card.

Tolerances: f32 rtol 2e-4 / atol 2e-5 (tests/test_scan_decoder.py): the
twins and the JAX functions sum the same f32 products in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_scene
from unscene3d_tpu.ops.kernel_maps import build_neighbor_map
from unscene3d_tpu.ops.segment_pool import tile_segment_sum
from unscene3d_tpu.ops.window_conv import (build_win_graph, pallas_interpret,
                                           window_conv3_bwd_fused,
                                           window_conv3_dw, window_conv3_fwd)
from unscene3d_tpu.ops.window_gather import (up_tables_from_parents as
                                             jax_up_tables, window_k_apply)
from unscene3d_torch.ops.conv3 import (conv3_bwd, conv3_bwd_plain, conv3_dw,
                                       conv3_dw_plain, conv3_fwd,
                                       conv3_fwd_plain, fold_bias)
from unscene3d_torch.ops.k_apply import (k_apply, k_apply_gemm,
                                         k_apply_plain, k_apply_sum)
from unscene3d_torch.ops.kernel_maps import up_tables_from_parents
from unscene3d_torch.ops.segment_pool import (segment_order, segment_sum,
                                              segment_sum_plain)

RTOL, ATOL = 2e-4, 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ------------------------------------------------------------- kernel 1
@pytest.fixture(scope="module")
def blob_graph():
    """k3 map of a dense blob, padded like the collator (missing -> n_pad-1)."""
    rng = np.random.RandomState(3)
    pts = rng.randint(0, 9, size=(2000, 3))
    coords = np.unique(np.concatenate(
        [np.zeros((len(pts), 1), np.int64), pts], axis=1), axis=0)
    coords = coords[np.lexsort(coords.T[::-1])]
    n_pad = 1024
    idx, val = build_neighbor_map(coords.astype(np.int32), use_native=False)
    nbr = np.full((27, n_pad), n_pad - 1, np.int64)
    nbr[:, :len(coords)] = np.where(val, idx, n_pad - 1)
    valid = np.zeros(n_pad, bool)
    valid[:len(coords)] = True
    return nbr, valid


@pytest.mark.parametrize("cin,cout,spill,epi", [
    (8, 16, False, "scale_relu"),        # packed-select Pallas path
    (8, 16, True, "scale_res_relu"),     # forced spills + in-kernel inject
    (48, 16, False, "bias"),             # bias folded into a unit scale
    (48, 32, True, "all"),               # bias + scale/shift + residual + ReLU
])
def test_conv3_twin_matches_pallas_interpret(blob_graph, cin, cout, spill,
                                             epi):
    nbr, valid = blob_graph
    n_pad = nbr.shape[1]
    wg = build_win_graph(nbr, n_pad, w_sub=256 if spill else 384,
                         w_union=512 if spill else n_pad)
    assert (int(wg.num_spill_padded) > 0) == spill
    rng = np.random.RandomState(cin + cout)
    # padding rows are NOT zero: the port must skip missing neighbours
    x = rng.randn(n_pad, cin).astype(np.float32)
    w = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
    kw = {}
    if epi in ("scale_relu", "scale_res_relu", "all"):
        kw["scale"] = (rng.rand(cout) + 0.5).astype(np.float32)
        kw["shift"] = rng.randn(cout).astype(np.float32)
    if epi in ("scale_res_relu", "all"):
        kw["residual"] = rng.randn(n_pad, cout).astype(np.float32)
    if epi in ("bias", "all"):
        kw["bias"] = rng.randn(cout).astype(np.float32)
    relu = epi != "bias"
    # the Pallas kernel reads whole windows, so its own input keeps the
    # repo's zero-padding invariant; the twin gets the noisy padding
    xz = x * valid[:, None]
    with pallas_interpret():
        ref = window_conv3_fwd(jnp.asarray(xz), jnp.asarray(w), wg,
                               jnp.asarray(valid), relu=relu,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    scale, shift = fold_bias(
        _t(kw["bias"]) if "bias" in kw else None,
        _t(kw["scale"]) if "scale" in kw else None,
        _t(kw["shift"]) if "shift" in kw else None, cout, "cpu")
    got = conv3_fwd_plain(_t(x), _t(w), _t(nbr.astype(np.int32)), _t(valid),
                          scale=scale, shift=shift,
                          residual=_t(kw["residual"]) if "residual" in kw
                          else None, relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------- kernels 4 and 5
@pytest.mark.parametrize("cin,cout,spill,group", [
    (48, 16, False, 1),
    (48, 16, True, 1),    # spills: the fused kernel adds mirrored pairs back
    (8, 24, True, 2),     # narrow input, grouped tiles
])
def test_conv3_bwd_twin_matches_pallas_fused_interpret(blob_graph, cin, cout,
                                                       spill, group):
    """Kernel 4's twin: dx and dW (all 27 offsets) against the fused Pallas
    backward, which includes its spill corrections."""
    nbr, valid = blob_graph
    n_pad = nbr.shape[1]
    wg = build_win_graph(nbr, n_pad, w_sub=256 if spill else 384,
                         w_union=512 if spill else 768, group=group)
    assert (int(wg.num_spill_padded) > 0) == spill
    rng = np.random.RandomState(cin + 7 * cout)
    x = rng.randn(n_pad, cin).astype(np.float32)
    w = (rng.randn(27, cin, cout) * 0.1).astype(np.float32)
    gm = rng.randn(n_pad, cout).astype(np.float32) * valid[:, None]
    xz = x * valid[:, None]      # the Pallas kernel's zero-padding invariant
    with pallas_interpret():
        out = window_conv3_bwd_fused(jnp.asarray(xz), jnp.asarray(gm),
                                     jnp.asarray(w), wg, jnp.asarray(valid))
    assert out is not None
    dx_ref, dw_ref = out
    dx, dw = conv3_bwd_plain(_t(x), _t(gm), _t(w), _t(nbr.astype(np.int32)),
                             _t(valid))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("spill", [False, True])
def test_conv3_dw_twin_matches_pallas_dw_interpret(blob_graph, spill):
    """Kernel 5's twin against the Pallas dW kernel (26 off-centre offsets,
    spilled pairs excluded): the centre is the plain x^T gm and the spilled
    pairs are added as window_conv.py:_win_bwd adds them."""
    nbr, valid = blob_graph
    n_pad = nbr.shape[1]
    wg = build_win_graph(nbr, n_pad, w_sub=256 if spill else 384,
                         w_union=512 if spill else 768)
    assert (int(wg.num_spill_padded) > 0) == spill
    rng = np.random.RandomState(11)
    x = rng.randn(n_pad, 8).astype(np.float32)
    gm = rng.randn(n_pad, 16).astype(np.float32) * valid[:, None]
    xz = x * valid[:, None]
    with pallas_interpret():
        dws = np.asarray(window_conv3_dw(jnp.asarray(xz), jnp.asarray(gm), wg))
    ref = np.concatenate([dws[:13], (xz.T @ gm)[None], dws[13:]])
    if spill:
        s_in, s_out = np.asarray(wg.spill_in), np.asarray(wg.spill_out)
        for p, k in enumerate(np.asarray(wg.spill_k)):
            ref[k] += np.outer(xz[s_in[p]], gm[s_out[p]])
    got = conv3_dw_plain(_t(x), _t(gm), _t(nbr.astype(np.int32)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------- kernel 2
@pytest.fixture(scope="module")
def win_batch():
    """A collated scene with K=8 window tables at every level >= 512 rows."""
    scene = make_scene(num_points=12_000, num_objects=4, extent=3.0, seed=3)
    batch, _ = JaxCollator(voxel_size=0.02, win_levels=(0, 1, 2, 3, 4),
                           win_group=1)([scene])
    return batch


@pytest.mark.parametrize("mode,lv", [("down", 1), ("down", 2), ("up", 0),
                                     ("up", 1), ("pool", 1), ("pool", 2)])
def test_k_apply_twin_matches_window_k_apply(win_batch, mode, lv):
    L = win_batch.graph.levels
    rng = np.random.RandomState(lv)
    cin, cout = 24, 40
    if mode == "up":
        fine, coarse = L[lv], L[lv + 1]
        wt = fine.win_up
        n_in, out_level = coarse.num_padded, fine
        table = _t(up_tables_from_parents(
            np.asarray(fine.parent_idx), np.asarray(fine.parent_offset),
            np.asarray(fine.valid), n_in))
        np.testing.assert_array_equal(
            table.numpy(), jax_up_tables(
                np.asarray(fine.parent_idx), np.asarray(fine.parent_offset),
                np.asarray(fine.valid), n_in))
    else:
        coarse = L[lv]
        wt = coarse.win_down
        n_in, out_level = L[lv - 1].num_padded, coarse
        table = _t(np.asarray(coarse.child_idx))
    assert wt is not None
    x = rng.randn(n_in, cin).astype(np.float32)
    w = (None if mode == "pool"
         else (rng.randn(8, cin, cout) * 0.2).astype(np.float32))
    ref = window_k_apply(jnp.asarray(x), None if w is None else jnp.asarray(w),
                         wt, jnp.asarray(out_level.valid),
                         out_level.num_padded)
    got = k_apply_plain(_t(x), table, None if w is None else _t(w),
                        _t(out_level.valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------- kernel 3
@pytest.mark.parametrize("n,c,s", [(1024, 16, 40), (2560, 32, 192)])
def test_segment_sum_twin_matches_tile_segment_sum(n, c, s):
    rng = np.random.RandomState(n)
    x = rng.randn(n, c).astype(np.float32)
    ids = rng.randint(-2, s + 3, n).astype(np.int32)   # some out of range
    valid = rng.rand(n) > 0.2
    ref = tile_segment_sum(jnp.asarray(x), jnp.asarray(ids), s,
                           jnp.asarray(valid))
    got = segment_sum_plain(_t(x), _t(ids), s, _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------- wrapper routing
_KERNELS = (conv3_fwd, conv3_bwd, conv3_dw, k_apply_gemm, k_apply_sum,
            segment_sum)


def _reset_counters():
    for fn in _KERNELS:
        fn.launches = 0


def test_cpu_tensors_route_to_the_twins_without_launching():
    _reset_counters()
    rng = np.random.RandomState(0)
    n, c = 256, 8
    nbr = _t(rng.randint(0, n, (27, n)).astype(np.int32))
    valid = _t(rng.rand(n) > 0.1)
    x = _t(rng.randn(n, c).astype(np.float32))
    w = _t(rng.randn(27, c, c).astype(np.float32))
    torch.testing.assert_close(conv3_fwd(x, w, nbr, valid, relu=True),
                               conv3_fwd_plain(x, w, nbr, valid, relu=True),
                               rtol=0, atol=0)
    table = nbr[:8].contiguous()
    torch.testing.assert_close(k_apply(x, table, w[:8], valid),
                               k_apply_plain(x, table, w[:8], valid),
                               rtol=0, atol=0)
    torch.testing.assert_close(k_apply(x, table, None, valid),
                               k_apply_plain(x, table, None, valid),
                               rtol=0, atol=0)
    ids_np = rng.randint(0, 10, n).astype(np.int32)
    ids = _t(ids_np)
    order, offsets = segment_order(ids_np, 10, valid.numpy())
    torch.testing.assert_close(segment_sum(x, ids, 10, valid, _t(order),
                                           _t(offsets)),
                               segment_sum_plain(x, ids, 10, valid),
                               rtol=0, atol=0)
    gm = x * valid[:, None]
    for a, b in zip(conv3_bwd(x, gm, w, nbr, valid),
                    conv3_bwd_plain(x, gm, w, nbr, valid)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(conv3_dw(x, gm, nbr),
                               conv3_dw_plain(x, gm, nbr), rtol=0, atol=0)
    assert all(fn.launches == 0 for fn in _KERNELS)
