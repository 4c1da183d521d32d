"""The two prototype paths of the PyTorch port against the JAX package on the
CPU: the window tables (ops/win_graph.py), kernel 9's plain twin
(ops/win_decompose.py), kernel 8's plain twin (ops/proto_brick.py) and the
entry points unscene3d_torch/bench/proto_*.py.

Inputs come from a numpy seed. Tolerances:
  * `build_win_graph`: every field bitwise equal to the JAX function's, as
    it runs here (its C++ table routines where they are compiled) and with
    those switched off (its numpy branches, which the port copies);
  * kernel 9's twin against the Pallas kernel of
    benchmarks/proto_win_decompose.py run in interpret mode, bf16 in and
    out: 8e-3 of max|reference| (both sum bf16 products in f32 and round
    once to bf16, in another order: one bf16 ulp);
  * kernel 8's twin against the Pallas brick kernel in interpret mode on the
    occupied cells and against the JAX gather conv at the real voxels, f32:
    rtol 1e-4 / atol 1e-4 (the same f32 products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unscene3d_tpu.native as jnative
from benchmarks import proto_win_decompose as jproto
from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.ops import brick_engine as jbe
from unscene3d_tpu.ops import conv_ops as jconv_ops
from unscene3d_tpu.ops import window_conv as jwc
from unscene3d_torch.bench import proto_brick, proto_win_decompose
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.ops import brick_engine as be
from unscene3d_torch.ops.conv3 import conv3_fwd
from unscene3d_torch.ops.kernel_maps import build_neighbor_map_padded
from unscene3d_torch.ops.proto_brick import (proto_brick_conv,
                                             proto_brick_conv_plain)
from unscene3d_torch.ops.win_decompose import (VARIANTS, WinTables,
                                               spill_products,
                                               win_conv_variant)
from unscene3d_torch.ops.win_graph import build_win_graph

BF16_TOL = 8e-3
RTOL = ATOL = 1e-4
SMALL = dict(num_points=2500, num_objects=4, extent=3.0, seed=1)
FIELDS = ("r0", "starts", "lidx", "spill_out", "spill_in", "spill_k",
          "spill_rows", "sp_q0", "sp_qn")
STATIC = ("w_subs", "w_sub", "w_union", "group", "tile", "spill_q")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_per_pool():
    """The suite runs several workers at once. On top of them, the thread
    pools of torch and of the OpenBLAS behind JAX's CPU LAPACK only spin:
    one batched eigh of this file took 17 minutes in a whole run and 8 s
    alone. One thread each while this module runs."""
    import threadpoolctl

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def level():
    """Level 0 of a small scene at voxel 0.05, padded to a multiple of 2048
    rows."""
    lvl = FreeMaskCollator(voxel_size=0.05)(
        [make_scene(**SMALL)])[0].graph.levels[0]
    coords = lvl.coords[lvl.valid].numpy()
    n_pad = -(-(len(coords) + 1) // 2048) * 2048
    return coords, n_pad, build_neighbor_map_padded(coords, n_pad)


@pytest.fixture(params=["native", "numpy"])
def jax_tables(request, monkeypatch):
    """The JAX function with its C++ table routines, then without them."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "win_tables_native", lambda *a: None)
        monkeypatch.setattr(jnative, "win_fill_lidx_native", lambda *a: None)


@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("w_sub,w_union,spills", [
    (256, 512, True),            # narrow windows: many spilled pairs
    (None, None, False),         # the whole level in every window
    ((256, 512), 1024, True),    # per-region widths (W_own, W_dx)
])
def test_win_graph_equals_jax_bitwise(level, jax_tables, group, w_sub,
                                      w_union, spills):
    _, n_pad, nbr = level
    kw = dict(w_sub=w_sub or n_pad, w_union=w_union or n_pad, group=group)
    ref = jwc.build_win_graph(nbr, n_pad, **kw)
    got = build_win_graph(nbr, n_pad, **kw)
    for name in FIELDS:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name)
        assert r.dtype == g.dtype and r.shape == g.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    for name in STATIC:
        assert getattr(got, name) == getattr(ref, name), name
    assert (got.num_spills > 0) == spills
    # a group whose rows outgrow the union window was halved to fit
    assert got.group == min(group, got.w_union // 256)
    assert got.num_spill_padded == ref.num_spill_padded


def test_win_graph_spill_plan_and_asserts(level):
    _, n_pad, nbr = level
    wg = build_win_graph(nbr, n_pad, w_sub=256, w_union=512, group=2)
    plan = (wg.num_spill_padded + 64, wg.spill_q + 8)
    padded = build_win_graph(nbr, n_pad, w_sub=256, w_union=512, group=2,
                             spill_plan=plan)
    assert padded.num_spill_padded == plan[0] and padded.spill_q == plan[1]
    assert padded.num_spills == wg.num_spills
    with pytest.raises(AssertionError):      # SpillPlanExceeded
        build_win_graph(nbr, n_pad, w_sub=256, w_union=512, group=2,
                        spill_plan=(8, 8))
    with pytest.raises(AssertionError):      # own window narrower than a tile
        build_win_graph(nbr, n_pad, w_sub=128, w_union=512)
    with pytest.raises(ValueError, match="power of two"):   # no G x tile
        build_win_graph(nbr, n_pad, w_sub=256, w_union=2048, group=3)


@pytest.mark.parametrize("w_union", [1024, 2048])
def test_win_graph_rejects_a_group_that_is_no_power_of_two(level, w_union):
    """Group 6 is halved to 3 where its rows outgrow the union window (1024)
    and kept where they fit (2048); 3 or 6 tiles of 256 rows divide no level
    padded to a multiple of 2048 rows, where the reference's divisibility
    assert fires. The port raises a ValueError naming the group first."""
    _, n_pad, nbr = level
    assert n_pad % (3 * 256) != 0
    with pytest.raises(ValueError, match="group 6 is not a power of two"):
        build_win_graph(nbr, n_pad, w_sub=256, w_union=w_union, group=6)


@pytest.fixture(scope="module")
def win_case(level):
    """The prototype's inputs at the small level: G = 2, W = 256, bf16 noise
    on every row of x, the padding rows included."""
    _, n_pad, nbr = level
    g, w_sub, c = 2, 256, 16
    wg = build_win_graph(nbr, n_pad, w_sub=w_sub,
                         w_union=4096 + (g - 1) * 256, group=g)
    assert wg.num_spills > 0 and wg.group == g
    rng = np.random.RandomState(0)
    x = rng.randn(n_pad, c).astype(np.float32)
    w = (rng.randn(27, c, c) * 0.05).astype(np.float32)
    return wg, x, w


@pytest.mark.parametrize("variant", VARIANTS)
def test_win_conv_variant_twin_matches_pallas_interpret(win_case, variant):
    """The Pallas kernel is built as benchmarks/proto_win_decompose.py:146-166
    builds it, with interpret=True."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    wg, x, w = win_case
    n_pad, c = x.shape
    g, T = wg.group, jproto.T
    kernel = jproto.make_kernel(variant, wg.w_sub, wg.w_union, g,
                                jnp.bfloat16)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2,
        grid=(n_pad // (g * T),),
        in_specs=[
            pl.BlockSpec((g * T, 26), lambda t, r, s: (t, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.HBM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((g * T, c), lambda t, r, s: (t, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[
            pltpu.VMEM((2, wg.w_union, c), jnp.bfloat16),
            pltpu.SemaphoreType.DMA((2,)),
        ],
    )
    ref = pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((n_pad, c), jnp.bfloat16),
        interpret=True,
    )(jnp.asarray(wg.r0), jnp.asarray(wg.starts).reshape(-1),
      jnp.asarray(wg.lidx), jnp.asarray(x, jnp.bfloat16),
      jnp.asarray(w, jnp.bfloat16))
    ref = np.asarray(ref.astype(jnp.float32))
    got = win_conv_variant(_t(x).bfloat16(), _t(w).bfloat16(),
                           WinTables.from_graph(wg), variant)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= BF16_TOL * np.abs(ref).max(), (variant, err)


def test_full_plus_spills_is_the_gather_conv(level, win_case):
    """`full` lacks exactly the spilled pairs of kernel 1 (valid rows; a
    padding row's centre reads its own noise)."""
    coords, n_pad, nbr = level
    wg, x, w = win_case
    xb, wb = _t(x).bfloat16(), _t(w).bfloat16()
    valid = torch.arange(n_pad) < len(coords)
    full = win_conv_variant(xb, wb, WinTables.from_graph(wg), "full")
    k1 = conv3_fwd(xb, wb, _t(nbr), valid).float()
    total = full.float() + spill_products(xb, wb, wg)
    scale = k1.abs().max().item()
    assert (total - k1)[valid].abs().max().item() <= BF16_TOL * scale
    # and the spills matter: without them the rows they feed are off
    assert (full.float() - k1)[valid].abs().max().item() > 0.05 * scale


def test_win_conv_variant_rejects_bad_inputs(win_case):
    wg, x, w = win_case
    tables = WinTables.from_graph(wg)
    xb, wb = _t(x).bfloat16(), _t(w).bfloat16()
    with pytest.raises(ValueError):
        win_conv_variant(xb, wb, tables, "onehot_only")
    wide = build_win_graph(np.full((27, 512), 511, np.int32), 512,
                           w_sub=(256, 512), w_union=512)
    with pytest.raises(ValueError):
        WinTables.from_graph(wide)


@pytest.fixture(scope="module")
def brick_setup():
    """tests/test_torch_brick.py's set-up: level 0 of two scenes at voxel
    0.05, 16 -> 24 channels, f32."""
    from unscene3d_tpu.data.synthetic import make_batch

    scenes = make_batch(2, num_points=6000, seed=0)
    jl0 = JaxCollator(voxel_size=0.05)(scenes)[0].graph.levels[0]
    l0 = FreeMaskCollator(voxel_size=0.05)(scenes)[0].graph.levels[0]
    jbg = jbe.build_brick_graph(np.asarray(jl0.coords), np.asarray(jl0.valid))
    bg = be.build_brick_graph(l0.coords.numpy(), l0.valid.numpy())
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(l0.num_padded, 16)).astype(np.float32)
         * l0.valid.numpy()[:, None])
    w = (rng.normal(size=(27, 16, 24)) * 0.1).astype(np.float32)
    return jl0, jbg, l0, bg, x, w


def test_proto_brick_twin_matches_pallas_and_gather(brick_setup):
    jl0, jbg, l0, bg, x, w = brick_setup
    g = be.assemble(_t(x), bg)
    got = proto_brick_conv(g, _t(w))
    assert got is not None and got.shape == (bg.nb_pad, be.CELLS, 24)
    assert not got[:, :be.WIN_LO].any()
    assert not got[:, be.WIN_LO + be.WIN_N:].any()
    # kernel 7 (Pallas, interpret mode, no epilogue) on the occupied cells
    ref = np.asarray(jax.jit(lambda g, w, bg: jbe.brick_conv3(
        g, w, bg, interpret=True))(jbe.assemble(jnp.asarray(x), jbg),
                                   jnp.asarray(w), jbg))
    occ = bg.occ.numpy()
    np.testing.assert_allclose(got.numpy()[occ], ref[occ], rtol=RTOL,
                               atol=ATOL)
    # no occupancy mask: empty interior cells hold their neighbours' sums
    win = slice(be.WIN_LO, be.WIN_LO + be.WIN_N)
    assert np.abs(got.numpy()[:, win][~occ[:, win]]).max() > 0.1
    assert not ref[~occ].any()
    # the JAX gather conv at the real voxels, as the prototype checks itself
    flat = be.disassemble(got, bg, l0).numpy()
    jref = np.asarray(jconv_ops.sparse_conv3(jnp.asarray(x), jnp.asarray(w),
                                             jl0))
    valid = l0.valid.numpy()
    np.testing.assert_allclose(flat[valid], jref[valid], rtol=RTOL, atol=ATOL)


def test_proto_brick_host_tables():
    """The vectorised neighbour lookup and window statistics equal the
    prototype's dict-and-loop forms (benchmarks/proto_brick_pallas.py:85-102);
    the assemble map puts every voxel at its own cell and nothing else."""
    rng = np.random.RandomState(3)
    real = np.unique(rng.randint(0, [40, 24, 16], (900, 3)), axis=0)
    bo = proto_brick.brick_order(real)
    ubrick, uniq, nb = bo["ubrick"], bo["uniq"], len(bo["ubrick"])
    np.testing.assert_array_equal(proto_brick.morton3(ubrick), uniq)
    assert (np.diff(uniq.astype(np.int64)) > 0).all()
    key2id = {int(k): i for i, k in enumerate(uniq)}
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1)]
    ref = np.full((nb, 27), -1, np.int64)
    for k, off in enumerate(offs):
        nc = ubrick + np.array(off)
        nk = proto_brick.morton3(np.maximum(nc, 0))
        for i in np.nonzero((nc >= 0).all(1))[0]:
            ref[i, k] = key2id.get(int(nk[i]), -1)
    nbr_ids = proto_brick.neighbour_bricks(ubrick, uniq)
    np.testing.assert_array_equal(nbr_ids, ref)
    np.testing.assert_array_equal(nbr_ids[:, 13], np.arange(nb))
    wsize = np.array([bo["ends"][r[r >= 0]].max()
                      - bo["starts"][r[r >= 0]].min() for r in ref])
    np.testing.assert_array_equal(
        proto_brick.window_stats(nbr_ids, bo["starts"], bo["ends"]), wsize)
    srt = real[bo["order"]]
    asm = proto_brick.assemble_map(srt, ubrick)
    assert asm.shape == (nb, be.CELLS) and (asm[:, 1000:] == len(real)).all()
    cell = bo["cell"]
    interior = ((cell // 64 + 1) * 100 + ((cell // 8) % 8 + 1) * 10
                + cell % 8 + 1)
    np.testing.assert_array_equal(asm[bo["own_brick"], interior],
                                  np.arange(len(real)))
    # a filled cell names the voxel whose coordinates are the cell's
    b, cid = np.nonzero(asm[:, :1000] < len(real))
    xyz = np.stack([cid // 100 - 1, (cid // 10) % 10 - 1, cid % 10 - 1], 1)
    np.testing.assert_array_equal(srt[asm[b, cid]], (ubrick[b] << 3) + xyz)


def test_proto_entry_points_run_on_the_cpu():
    scene = dict(num_points=6000, num_objects=4, extent=3.0, seed=1)
    lines = []
    res = proto_brick.run("cpu", channels=16, scene=scene, voxel_size=0.05,
                          reps=1, log=lines.append)
    assert res["max_rel_err"] <= proto_brick.REL_TOL
    assert set(res["ms"]) == {"assembly_gather", "conv3_fwd",
                              "brick_conv_proto"}
    assert any("brick-vs-gather" in ln for ln in lines)
    res = proto_win_decompose.run("cpu", cin=16, group=2, w_sub=256,
                                  scene=scene, reps=1, harness=True,
                                  log=lines.append)
    assert list(res["ms"]) == ["harness", *VARIANTS, "conv3_fwd"]
    assert res["rows"] % 512 == 0 and res["spilled_pairs"] > 0


def test_proto_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for mod in (proto_brick, proto_win_decompose):
        with pytest.raises(RuntimeError):
            mod.run()


def test_proto_brick_twin_is_used_for_cpu_tensors_only():
    g = torch.zeros(1, be.CELLS, 4)
    w = torch.zeros(27, 4, 4)
    before = proto_brick_conv.launches, win_conv_variant.launches
    assert torch.equal(proto_brick_conv(g, w), proto_brick_conv_plain(g, w))
    assert (proto_brick_conv.launches, win_conv_variant.launches) == before
    with pytest.raises(ValueError):
        proto_brick_conv(g.to("meta"), w.to("meta"))


def test_sass_opcode_counts():
    """`bench/sass.py` counts each kernel's opcodes from cuobjdump's SASS,
    predicated instructions included."""
    from unscene3d_torch.bench.sass import opcode_counts

    sass = """
\tcode for sm_90a
\t\tFunction : _Z3fooPf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LD.E R76, desc[UR10][R64.64] ;
        /*0020*/              @!P0 MOVM.16.MT88 R4, R4 ;
        /*0030*/                   HMMA.16816.F32.BF16 R8, R4, R6, R8 ;
        /*0040*/                   HMMA.16816.F32.BF16 R12, R4, R7, R12 ;
\t\tFunction : _Z3barPf
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/              @P1 BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/                   EXIT ;
"""
    counts = opcode_counts(sass)
    assert list(counts) == ["_Z3fooPf", "_Z3barPf"]
    assert counts["_Z3fooPf"] == {"LDC": 1, "LD": 1, "MOVM": 1, "HMMA": 2}
    assert counts["_Z3barPf"] == {"LDS": 1, "BAR": 1, "EXIT": 1}


def test_ring_times_runs_every_case_on_the_cpu():
    """`bench/ring_times.py` on "cpu" at a tiny size (its times are then
    the twins' on the host clock, no device time): every case of kernel 1,
    kernel 2's up2 and kernel 6 beside kernel 1 gets a positive time."""
    from unscene3d_torch.bench import ring_times

    got = ring_times.run(
        "cpu", bench=dict(num_points=4000, num_objects=3, extent=2.0,
                          seed=0),
        train=dict(num_points=3000, num_objects=3, extent=2.0),
        train_batch=1, voxel=0.05)
    cases = ["L0 128->96 +res", "L0 3->32", "L2 128->128",
             "as dx, train L0 128->96"]
    assert set(got) == ({"conv3_fwd L0 3->32", "conv3_fwd L0 128->96 +res",
                         "conv3_fwd L3 384->256",
                         "k_apply up2 L1->L0 96->96"}
                        | {f"csr_conv3 {c}" for c in cases}
                        | {f"conv3_fwd beside it, {c}" for c in cases})
    assert all(t > 0 for t in got.values())


def test_sass_digests_ignore_addresses_and_encodings():
    """`bench/sass.py`'s digest of a kernel's instruction text is the same
    for the same instructions at other addresses with other encodings, and
    differs when one operand differs."""
    from unscene3d_torch.bench.sass import digests

    def kernel(name, base, reg):
        return (f"\t\tFunction : {name}\n"
                f"        /*{base:04x}*/   LDC R1, c[0x0][0x28] ;   "
                f"/* 0x00000a00ff01{base:04x} */\n"
                f"        /*{base + 16:04x}*/   @!P0 IADD3 R{reg}, R1, 0x4, "
                f"RZ ;   /* 0x000fe2 */\n")

    d = digests("\tcode for sm_90a\n" + kernel("_Z1a", 0, 2)
                + kernel("_Z1b", 0x40, 2) + kernel("_Z1c", 0, 3))
    assert list(d) == ["_Z1a", "_Z1b", "_Z1c"]
    assert d["_Z1a"] == d["_Z1b"] != d["_Z1c"]
