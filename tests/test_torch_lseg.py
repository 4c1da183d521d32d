"""The port's LSeg (models/encoders_2d/lseg.py) against the JAX package's:
the tiny tower through both `LSegNet` wrappers on weights bridged from the
JAX variables (features, the multi-resolution maps, relevance maps), a
reference-layout state dict with the `net.` prefix through both loaders,
the full ViT-L/16 configuration's shapes on the `meta` device, and the
registry.

Tolerance: tests/test_encoder_fidelity.py:336-360's, rtol 2e-4 and atol
2e-5 of the tensor's largest magnitude (random BatchNorm statistics blow
activations up). Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import torch

from tests._torch_jax import np_tree, one_torch_thread  # noqa: F401
from unscene3d_tpu.models.encoders_2d.lseg import LSegFeatureNet as JaxLSeg
from unscene3d_tpu.models.encoders_2d.lseg import LSegNet as JaxLSegNet
from unscene3d_tpu.models.encoders_2d.lseg import \
    load_torch_lseg_weights as jax_load_lseg
from unscene3d_torch.models.encoders_2d import load_2d_model
from unscene3d_torch.models.encoders_2d.lseg import (TINY, LSegFeatureNet,
                                                     LSegNet,
                                                     load_torch_lseg_weights)
from unscene3d_torch.models.weights import (load_flax_lseg_variables,
                                            lseg_state_from_flax)

# H = 32 shrinks the 4 x 4 pos-embed grid to 2 rows, W = 96 grows it to 6
IMAGE = (32, 96)


def _close(got, want, name):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-5 * max(scale, 1.0), err_msg=name)


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).rand(2, *IMAGE, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_pair(images):
    """The JAX tiny LSegNet on the variables of a seeded reference-layout
    checkpoint (random BatchNorm statistics; a flax init's compile costs
    more than the tests) and 20 text embeddings, and its outputs."""
    text = np.random.RandomState(1).randn(20, 512).astype(np.float32)
    sd = _reference_state(LSegFeatureNet(**TINY), seed=2, unused=False)
    variables = jax_load_lseg({k: v.numpy() for k, v in sd.items()})
    net = JaxLSegNet(variables=variables, image_size=IMAGE,
                     text_embeddings=text, tiny=True)
    # op by op: a tiny tower's jit compile costs more than its one call
    net._fwd = net.model.apply
    outs = net.forward_multi_res(images[None])
    return variables, text, outs, net.relevance_maps(images)


def test_tiny_lseg_matches_jax_on_bridged_weights(images, jax_pair):
    variables, text, want, want_rel = jax_pair
    net = LSegNet(state_dict=lseg_state_from_flax(np_tree(variables)),
                  image_size=IMAGE, text_embeddings=text, tiny=True,
                  device="cpu")
    got = net.forward_multi_res(images[None])
    for g, w, name in zip(got, want, ("out", "path1", "path2", "path3")):
        _close(g.numpy(), w, name)
    _close(net(images).numpy(), want[0][0], "call")
    _close(net.relevance_maps(images).numpy(), want_rel, "relevance")
    feat = LSegFeatureNet(**TINY)
    load_flax_lseg_variables(feat, np_tree(variables))   # strict: no leftover
    assert torch.equal(feat.scratch.head1.weight,
                       net.model.scratch.head1.weight)


def _reference_state(model: LSegFeatureNet, seed: int,
                     unused: bool = True) -> dict:
    """A seeded reference-layout checkpoint: the tower's keys under `net.`
    and, with `unused`, keys of the reference that the tower does not
    use."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if v.dtype.is_floating_point:
            v = torch.randn(v.shape, generator=g) * (0.3 if v.ndim > 1
                                                     else 0.1)
            if "running_var" in k:
                v = v.abs() + 0.5
        sd[f"net.{k}"] = v
    if not unused:
        return sd
    for k in list(sd):      # the reference's unused unit of refinenet4
        if k.startswith("net.scratch.refinenet3.resConfUnit1."):
            sd[k.replace("refinenet3", "refinenet4")] = sd[k].clone()
    sd["net.pretrained.model.norm.weight"] = torch.ones(64)
    sd["net.logit_scale"] = torch.tensor(1.0)
    return sd


def test_reference_checkpoint_loads_in_both_loaders(images):
    """One reference-layout state dict (`net.` prefix, unused keys) through
    the JAX converter and through the port's loader: the towers agree."""
    sd = _reference_state(LSegFeatureNet(**TINY), seed=5)
    variables = jax_load_lseg({k: v.numpy() for k, v in sd.items()})
    want = JaxLSeg(**TINY).apply(variables, images)
    net = LSegNet(state_dict=load_torch_lseg_weights(sd), image_size=IMAGE,
                  tiny=True, device="cpu")
    with torch.no_grad():
        got = net.model(torch.from_numpy(images).permute(0, 3, 1, 2))
    for g, w, name in zip(got, want, ("out", "path1", "path2", "path3")):
        _close(g.numpy(), w, name)
    with pytest.raises(KeyError, match="missing"):
        LSegNet(state_dict={}, image_size=IMAGE, tiny=True, device="cpu")


def test_full_config_has_vit_l16_shapes():
    with torch.device("meta"):
        m = LSegFeatureNet()
    vit = m.pretrained.model
    assert tuple(vit.pos_embed.shape) == (1, 24 * 24 + 1, 1024)
    assert len(vit.blocks) == 24 and m.hooks == (5, 11, 17, 23)
    assert tuple(vit.blocks[0].attn.qkv.weight.shape) == (3072, 1024)
    assert tuple(vit.blocks[0].mlp.fc1.weight.shape) == (4096, 1024)
    assert tuple(vit.patch_embed.proj.weight.shape) == (1024, 3, 16, 16)
    assert [m.pretrained.act_postprocess1[4].weight.shape[2],
            m.pretrained.act_postprocess2[4].weight.shape[2],
            len(m.pretrained.act_postprocess3),
            m.pretrained.act_postprocess4[4].stride[0]] == [4, 2, 4, 2]
    assert tuple(m.scratch.layer4_rn.weight.shape) == (256, 1024, 3, 3)
    assert tuple(m.scratch.head1.weight.shape) == (512, 256, 1, 1)
    assert m.scratch.refinenet4.resConfUnit1 is None
    n = sum(p.numel() for p in m.parameters())
    assert 300e6 < n < 360e6, n


def test_registry_and_frame_size_check():
    assert load_2d_model("LSegNet") is LSegNet
    with pytest.raises(ValueError, match="divisible by 32"):
        LSegNet(image_size=(240, 320), tiny=True, device="cpu")
    net = LSegNet(image_size=IMAGE, tiny=True, device="cpu")
    with pytest.raises(ValueError, match="no text embeddings"):
        net.relevance_maps(np.zeros((1, *IMAGE, 3), np.float32))
