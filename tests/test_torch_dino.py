"""The port's DINO ViT (`unscene3d_torch/models/encoders_2d/dino.py`) against
the JAX package's on the CPU, with the JAX weights carried over by the
bridge (`models/weights.py:load_flax_dino_variables`) or both sides loading
one DINO-repo-format checkpoint (`load_dino_weights` /
`load_torch_dino_weights`). Inputs come from a numpy seed; the JAX side is
jitted once per module for each stride and input size, all four facets in
one call. The narrow model's flax variables are made once per module by the
JAX package's own converter from a seeded DINO-format state dict (they serve
every stride and input size: the parameters do not depend on them).

Tolerances, relative to max|JAX| of the compared output:
  * the narrow ViT (dim 64, 3 blocks, 2 heads), every facet, stride 4 and
    8, square and non-square: 1e-5 (measured <= 6e-7: the same f32 ops in
    another order);
  * `interpolate_pos_encoding` against `interpolate_pos_encoding_torch`:
    rtol 1e-4, atol 2e-5, as tests/test_encoder_fidelity.py holds the JAX
    function to torch's own bicubic;
  * `DinoNet` at full ViT-S width (384 wide, 12 blocks, 6 heads, stride 4)
    on a 40 x 56 frame, through the bilinear upsample, border rows and
    columns included: 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests._torch_jax import np_tree, one_torch_thread  # noqa: F401
from unscene3d_tpu.models.encoders_2d import dino as jdino
from unscene3d_torch.models.encoders_2d import load_2d_model
from unscene3d_torch.models.encoders_2d.dino import (DinoNet, ViTExtractor,
                                                     interpolate_pos_encoding,
                                                     load_dino_weights)
from unscene3d_torch.models.weights import (dino_state_from_flax,
                                            load_flax_dino_variables)

NARROW = dict(dim=64, depth=3, num_heads=2, facet_layer=1)
NARROW_TOL = 1e-5
FACETS = ["key", "query", "token", "attn_qk"]
FULL_TOL = 1e-4
CASES = [(4, (40, 56)), (8, (48, 48)), (8, (40, 64))]


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _random_dino_state(seed, **vit):
    """Seeded random arrays under the DINO repository's names and shapes."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in ViTExtractor(**vit).state_dict().items():
        scale = 0.1 if k.endswith("bias") else 0.05
        sd[k] = (rng.randn(*v.shape) * scale).astype(np.float32)
        if "norm" in k and k.endswith("weight"):
            sd[k] += 1.0
    return sd


@pytest.fixture(scope="module")
def narrow_variables():
    return np_tree(jdino.load_torch_dino_weights(_random_dino_state(
        0, **NARROW)))


@pytest.fixture(scope="module")
def jax_vit(narrow_variables):
    """(stride, shape) -> (input, {facet: the JAX ViT's output}), each case
    jitted and run once, on first use."""
    done = {}

    def run(stride, shape):
        if (stride, shape) not in done:
            img = np.random.RandomState(stride + shape[1]).rand(
                2, *shape, 3).astype(np.float32)
            model = jdino.ViTExtractor(stride=stride, **NARROW)
            fwd = jax.jit(lambda v, x: {f: model.apply(v, x, facet=f)
                                        for f in FACETS})
            done[stride, shape] = img, fwd(narrow_variables, jnp.asarray(img))
        return done[stride, shape]
    return run


@pytest.mark.parametrize("facet", FACETS)
@pytest.mark.parametrize("stride,shape", CASES,
                         ids=[f"s{s}-{h}x{w}" for s, (h, w) in CASES])
def test_vit_matches_jax(narrow_variables, jax_vit, facet, stride, shape):
    img, outs = jax_vit(stride, shape)
    want = outs[facet]
    vit = ViTExtractor(stride=stride, **NARROW)
    load_flax_dino_variables(vit, narrow_variables)
    with torch.no_grad():
        got = vit(torch.from_numpy(img), facet=facet)
    h = (shape[0] - 8) // stride + 1
    w = (shape[1] - 8) // stride + 1
    pairs = zip(got, want) if facet == "attn_qk" else [(got, want)]
    for g, ref in pairs:
        assert tuple(g.shape) == (2, h, w, 64) == np.asarray(ref).shape
        assert _rel_err(g.numpy(), ref) <= NARROW_TOL


@pytest.mark.parametrize("h0,w0", [(11, 15), (47, 63), (28, 28)])
def test_interpolate_pos_encoding_matches_jax(h0, w0):
    pos = np.random.RandomState(4).randn(1, 28 * 28 + 1, 16).astype(
        np.float32)
    got = interpolate_pos_encoding(torch.from_numpy(pos), h0, w0, 28)
    want = jax.jit(jdino.interpolate_pos_encoding_torch,
                   static_argnums=(1, 2, 3))(jnp.asarray(pos), h0, w0, 28)
    assert got.shape == (1, h0 * w0 + 1, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-5)


def test_patch_embed_equals_the_convolution(narrow_variables):
    """unfold + matmul computes the strided 8 x 8 convolution."""
    vit = ViTExtractor(stride=4, **NARROW)
    load_flax_dino_variables(vit, narrow_variables)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 3, 40, 56).astype(
        np.float32))
    pe = vit.patch_embed
    with torch.no_grad():
        want = F.conv2d(x, pe.proj.weight, pe.proj.bias, stride=4)
        got = pe(x)
    np.testing.assert_allclose(got.numpy(),
                               want.flatten(2).transpose(1, 2).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def full_checkpoint(tmp_path_factory):
    """A seeded random ViT-S/8 state dict in the DINO repository's format
    (under a `module.` prefix, in a `state_dict` wrapper), saved with
    torch.save, and its numpy copy."""
    sd = _random_dino_state(7)
    path = tmp_path_factory.mktemp("dino") / "dino_deitsmall8_pretrain.pth"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v)
                               for k, v in sd.items()}}, path)
    return str(path), sd


def test_dinonet_full_width_matches_jax(full_checkpoint):
    path, _ = full_checkpoint
    img = np.random.RandomState(2).rand(1, 40, 56, 3).astype(np.float32)
    want = jdino.DinoNet(variables=jdino.load_torch_dino_weights(path),
                         image_size=(40, 56))(img)
    net = DinoNet(state_dict=load_dino_weights(path), device="cpu")
    got = net(img)
    assert tuple(got.shape) == want.shape == (1, 40, 56, 384)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    got = got.numpy()
    assert _rel_err(got, want) <= FULL_TOL
    # the bilinear upsample's borders (replicated on both sides)
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert _rel_err(got[sl], want[sl]) <= FULL_TOL


def test_dino_checkpoint_loading(full_checkpoint):
    path, sd = full_checkpoint
    state = load_dino_weights(path)
    assert set(state) == set(sd) and "module.norm.weight" not in state
    # the same from an in-memory dict without wrapper or prefix
    again = load_dino_weights({k: torch.from_numpy(v) for k, v in sd.items()})
    assert all(torch.equal(state[k], again[k]) for k in state)
    vit = ViTExtractor()
    vit.load_state_dict(state, strict=True)
    stray = dict(state, **{"head.weight": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="head.weight"):
        DinoNet(state_dict=stray, device="cpu")
    lacking = {k: v for k, v in state.items() if k != "norm.bias"}
    with pytest.raises(RuntimeError, match="norm.bias"):
        DinoNet(state_dict=lacking, device="cpu")


def test_dino_bridge_raises_on_missing_and_unused(narrow_variables):
    vit = ViTExtractor(**NARROW)
    extra = {"params": dict(narrow_variables["params"])}
    extra["params"]["block_3"] = narrow_variables["params"]["block_0"]
    with pytest.raises(KeyError, match="unused"):
        load_flax_dino_variables(vit, extra)
    lacking = {"params": dict(narrow_variables["params"])}
    del lacking["params"]["pos_embed"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_dino_variables(vit, lacking)
    odd = {"params": dict(narrow_variables["params"], head={"kernel": 0})}
    with pytest.raises(KeyError, match="unknown module head"):
        dino_state_from_flax(odd)


def test_dinonet_options_and_defaults():
    assert load_2d_model("DinoNet") is DinoNet
    with pytest.raises(ValueError, match="attn_qk"):
        DinoNet(facet="attn_qk", device="cpu")
    with pytest.raises(ValueError, match="unknown facet"):
        ViTExtractor(**NARROW)(torch.zeros(1, 16, 16, 3), facet="value")
    a = DinoNet(device="cpu").model.state_dict()
    b = ViTExtractor().init_random_(0).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            DinoNet()                   # the default device is the card
