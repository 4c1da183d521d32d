"""The brick conv engine of the PyTorch port against the JAX package's
(unscene3d_tpu/ops/brick_engine.py), on the set-up of
tests/test_brick_engine.py: two scenes of 6,000 points at voxel 0.05, level
0, 16 channels, inputs from a numpy seed.

The tables of `build_brick_graph` are equal exactly. `assemble`,
`halo_exchange` and `disassemble` move rows and are equal exactly; kernel 7's
plain twin is held against the Pallas kernel in interpret mode, and
`brick_conv1` against the JAX op, at rtol 1e-4 / atol 1e-4 (the same f32
products summed in another order), in that file's four cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_batch
from unscene3d_tpu.ops import brick_engine as jbe
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.ops import brick_engine as be
from unscene3d_torch.ops import conv_ops

RTOL = ATOL = 1e-4
C, CO = 16, 24


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    scenes = make_batch(2, num_points=6000, seed=0)
    jl0 = JaxCollator(voxel_size=0.05)(scenes)[0].graph.levels[0]
    l0 = FreeMaskCollator(voxel_size=0.05)(scenes)[0].graph.levels[0]
    jbg = jbe.build_brick_graph(np.asarray(jl0.coords), np.asarray(jl0.valid))
    bg = be.build_brick_graph(l0.coords.numpy(), l0.valid.numpy())
    rng = np.random.default_rng(0)
    x = rng.normal(size=(l0.num_padded, C)).astype(np.float32)
    x = x * l0.valid.numpy()[:, None]
    return jl0, jbg, l0, bg, x, rng


@pytest.fixture(scope="module")
def jax_conv3():
    """The Pallas kernel in interpret mode, jitted once per epilogue."""
    plain = jax.jit(lambda g, w, bg: jbe.brick_conv3(g, w, bg,
                                                     interpret=True))
    fused = jax.jit(lambda g, w, bg, sc, of, res: jbe.brick_conv3(
        g, w, bg, scale=sc, offset=of, residual=res, relu=True,
        interpret=True))
    return plain, fused


def test_brick_tables_equal_jax(setup):
    _, jbg, _, bg, _, _ = setup
    assert bg.n_pad == jbg.n_pad and bg.nb_pad == jbg.nb_pad
    for name in ("asm_idx", "out_idx", "nbr"):
        r, g = np.asarray(getattr(jbg, name)), getattr(bg, name).numpy()
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    np.testing.assert_array_equal(bg.occ.numpy(), np.asarray(jbg.occ))
    # the last brick is the all-empty pad brick
    assert not bg.occ[-1].any()
    assert be.K3_DELTAS == jbe.K3_DELTAS and be.HALO_DIRS == jbe.HALO_DIRS


def test_brick_conv3_matches_pallas_and_gather(setup, jax_conv3):
    jl0, jbg, l0, bg, x, rng = setup
    w = (rng.normal(size=(27, C, CO)) * 0.1).astype(np.float32)
    jg = jbe.assemble(jnp.asarray(x), jbg)
    g = be.assemble(_t(x), bg)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    ref = jax_conv3[0](jg, jnp.asarray(w), jbg)
    got = be.brick_conv3(g, _t(w), bg)
    assert got.shape == (bg.nb_pad, be.CELLS, CO)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    assert not got[:, :be.WIN_LO].any()
    assert not got[:, be.WIN_LO + be.WIN_N:].any()
    y = be.disassemble(got, bg, l0)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jbe.disassemble(jnp.asarray(got.numpy()), jbg,
                                              jl0)))
    # the same function as the gather conv on the flat level
    np.testing.assert_allclose(
        y.numpy(), conv_ops.sparse_conv3(_t(x), _t(w), l0).numpy(),
        rtol=RTOL, atol=ATOL)


def test_halo_exchange_enables_second_conv(setup, jax_conv3):
    jl0, jbg, l0, bg, x, rng = setup
    w1 = (rng.normal(size=(27, C, CO)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(27, CO, C)) * 0.1).astype(np.float32)
    g1 = be.brick_conv3(be.assemble(_t(x), bg), _t(w1), bg)
    h1 = be.halo_exchange(g1, bg)
    np.testing.assert_array_equal(
        h1.numpy(),
        np.asarray(jbe.halo_exchange(jnp.asarray(g1.numpy()), jbg)))
    ref = jbe.disassemble(
        jax_conv3[0](jnp.asarray(h1.numpy()), jnp.asarray(w2), jbg), jbg, jl0)
    y2 = be.disassemble(be.brick_conv3(h1, _t(w2), bg), bg, l0)
    np.testing.assert_allclose(y2.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    chain = conv_ops.sparse_conv3(conv_ops.sparse_conv3(_t(x), _t(w1), l0),
                                  _t(w2), l0)
    np.testing.assert_allclose(y2.numpy(), chain.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_brick_conv3_fused_affine_residual_relu(setup, jax_conv3):
    jl0, jbg, l0, bg, x, rng = setup
    w = (rng.normal(size=(27, C, CO)) * 0.1).astype(np.float32)
    sc = rng.normal(size=(CO,)).astype(np.float32)
    of = rng.normal(size=(CO,)).astype(np.float32)
    res_flat = rng.normal(size=(l0.num_padded, CO)).astype(np.float32)
    res_flat = res_flat * l0.valid.numpy()[:, None]
    jg = jbe.assemble(jnp.asarray(x), jbg)
    jres = jbe.assemble(jnp.asarray(res_flat), jbg)
    ref = jax_conv3[1](jg, jnp.asarray(w), jbg, jnp.asarray(sc),
                       jnp.asarray(of), jres)
    got = be.brick_conv3(be.assemble(_t(x), bg), _t(w), bg, scale=_t(sc),
                         offset=_t(of), residual=be.assemble(_t(res_flat),
                                                             bg), relu=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    flat = conv_ops.sparse_conv3(_t(x), _t(w), l0)
    flat = torch.clamp_min(flat * _t(sc) + _t(of) + _t(res_flat), 0.0)
    np.testing.assert_allclose(
        be.disassemble(got, bg, l0).numpy(),
        (flat * l0.valid[:, None]).numpy(), rtol=RTOL, atol=ATOL)
    # scale alone: the offset defaults to zero, as in the JAX op
    only = be.brick_conv3(be.assemble(_t(x), bg), _t(w), bg, scale=_t(sc))
    np.testing.assert_allclose(
        only.numpy(),
        np.asarray(jbe.brick_conv3(jg, jnp.asarray(w), jbg,
                                   scale=jnp.asarray(sc), interpret=True)),
        rtol=RTOL, atol=ATOL)


def test_brick_conv1(setup):
    jl0, jbg, l0, bg, x, rng = setup
    w = (rng.normal(size=(C, 8)) * 0.1).astype(np.float32)
    sc = rng.normal(size=(8,)).astype(np.float32)
    of = rng.normal(size=(8,)).astype(np.float32)
    jg = jbe.assemble(jnp.asarray(x), jbg)
    g = be.assemble(_t(x), bg)
    np.testing.assert_allclose(
        be.brick_conv1(g, _t(w), bg).numpy(),
        np.asarray(jbe.brick_conv1(jg, jnp.asarray(w), jbg)), rtol=RTOL,
        atol=ATOL)
    np.testing.assert_allclose(
        be.brick_conv1(g, _t(w), bg, _t(sc), _t(of)).numpy(),
        np.asarray(jbe.brick_conv1(jg, jnp.asarray(w), jbg, jnp.asarray(sc),
                                   jnp.asarray(of))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        be.disassemble(be.brick_conv1(g, _t(w), bg), bg, l0).numpy(),
        conv_ops.sparse_conv1(_t(x), _t(w), l0).numpy(), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("affine", [False, True])
def test_brick_conv1_keeps_empty_cells_zero_near_nan(setup, affine):
    """NaN in every empty cell of g (halo and padding cells included):
    `brick_conv1` selects zero there, as `brick_conv3` does, where the
    reference's product by the mask would carry the NaN (the reference
    differs here on purpose); the occupied cells keep the finite result."""
    _, _, _, bg, x, rng = setup
    w = _t((rng.normal(size=(C, 8)) * 0.1).astype(np.float32))
    kw = {}
    if affine:
        kw = dict(scale=_t(rng.normal(size=(8,)).astype(np.float32)),
                  offset=_t(rng.normal(size=(8,)).astype(np.float32)))
    g = be.assemble(_t(x), bg)
    clean = be.brick_conv1(g, w, bg, **kw)
    g[~bg.occ] = float("nan")
    got = be.brick_conv1(g, w, bg, **kw)
    assert not got.isnan().any()
    assert not got[~bg.occ].any()
    assert torch.equal(got, clean)


def test_brick_conv3_rejects_an_unsupported_device(setup):
    """Only a CPU tensor reaches the twin: any other device that is not CUDA
    raises (driven through a meta tensor)."""
    _, _, _, bg, _, _ = setup
    g = torch.empty(bg.nb_pad, be.CELLS, 4, device="meta")
    w = torch.empty(27, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        be.brick_conv3(g, w, bg)
