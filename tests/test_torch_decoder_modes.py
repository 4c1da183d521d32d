"""The decoder's query and pooling modes of conf/model/mask3d.yaml against
the JAX package's: forward parity of each mode group, one JAX compile
(init and forward together) per group, on the tiny model of
tests/test_torch_mask3d.py with one decoder round:

  * level embeddings + np features + max scatter + max_sample_size +
    pre-norm layers, in train mode (max_sample_size keeps every point
    there; BatchNorm on batch statistics);
  * learned queries with dropout 0.1, in eval mode (dropout is the identity
    in both packages), and `return_aux_vox`'s voxel logits of every set;
  * random queries, and random_query_both with random_normal: both
    packages take the same numbers (the port's `query_draw`; the JAX
    draw replaced while its forward is traced).
Tolerance rtol 2e-4 / atol 2e-5 (tests/test_torch_mask3d.py's f32 one).
Each group's own params cross the weight bridge from the flax variables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_jax import np_tree, one_torch_thread  # noqa: F401
from unscene3d_tpu.data.collate import FreeMaskCollator as JaxCollator
from unscene3d_tpu.data.synthetic import make_batch
from unscene3d_tpu.models.backbone import Res16UNet14A
from unscene3d_tpu.models.mask3d import Mask3D as JaxMask3D
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.inference import build_mask3d
from unscene3d_torch.models.weights import load_flax_variables

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(num_classes=3, hidden_dim=32, num_queries=8, num_heads=2,
             dim_feedforward=64, num_decoders=1)
VOXEL = 0.12
KEYS = ("pred_logits", "pred_masks_seg", "pred_masks_vox", "mask_features")


@pytest.fixture(scope="module")
def scenes():
    return make_batch(2, num_points=1500)


GROUPS = {
    # in train mode: max_sample_size keeps every point there
    "level_np_max_fullsample_prenorm": dict(
        use_level_embed=True, use_np_features=True, scatter_type="max",
        max_sample_size=True, pre_norm=True),
    # in eval mode, where dropout is the identity in both packages
    "learned_queries_dropout_eval": dict(non_parametric_queries=False,
                                         dropout=0.1),
    "random_queries": dict(non_parametric_queries=False, random_queries=True),
    "random_query_both_normal": dict(non_parametric_queries=False,
                                     random_query_both=True,
                                     random_normal=True),
}


def _draw(group, B):
    """The random-query numbers both packages take, or None."""
    kw = GROUPS[group]
    if not (kw.get("random_queries") or kw.get("random_query_both")):
        return None
    D, Q = SMALL["hidden_dim"], SMALL["num_queries"]
    rng = np.random.RandomState(11)
    if kw.get("random_query_both"):
        return rng.randn(B, Q, 2 * D).astype(np.float32)
    return rng.rand(B, Q, D).astype(np.float32)


@pytest.fixture(scope="module", params=list(GROUPS))
def group_run(request, scenes, monkeypatch_module):
    """(group, JAX variables, JAX outputs, port outputs) of one forward."""
    group = request.param
    kw = GROUPS[group]
    train = group.startswith("level_np_max")
    aux = group.startswith("learned_queries")
    jb, _ = JaxCollator(voxel_size=VOXEL, fps_queries=8)(scenes)
    draw = _draw(group, 2)
    if draw is not None:
        real = {f: getattr(jax.random, f) for f in ("uniform", "normal")}

        def fake(name):
            def f(key, shape, dtype=jnp.float32, *a, **k):
                if tuple(shape) == draw.shape:
                    return jnp.asarray(draw, dtype)
                return real[name](key, shape, dtype, *a, **k)
            return f

        for name in real:
            monkeypatch_module.setattr(jax.random, name, fake(name))
    model = JaxMask3D(backbone=Res16UNet14A(out_channels=2),
                      scan_decoder=False, **SMALL, **kw)
    rngs = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}

    def run(b):
        v = model.init(rngs, b, train=False, is_eval=True)
        if train:
            out, _ = model.apply(v, b, train=True, rngs=rngs,
                                 mutable=["batch_stats"])
        else:
            out = model.apply(v, b, train=False, is_eval=True,
                              return_aux_vox=aux, rngs=rngs)
        return v, {k: out[k] for k in KEYS}

    variables, ref = jax.jit(run)(jb)
    monkeypatch_module.undo()
    variables = np_tree(variables)
    tb, _ = FreeMaskCollator(voxel_size=VOXEL, fps_queries=8)(scenes)
    port = build_mask3d(torch.float32, backbone="Res16UNet14A", seed=None,
                        **SMALL, **kw)
    load_flax_variables(port, variables)
    port.train(train)
    with torch.no_grad():
        got = port(tb, torch.Generator().manual_seed(0), return_aux_vox=aux,
                   query_draw=None if draw is None else torch.from_numpy(draw))
    return group, variables, jax.tree.map(np.asarray, ref), got


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_mode_group_forward_matches_jax(group_run):
    group, _, ref, got = group_run
    for key in KEYS:
        g = got[key].numpy()
        assert g.shape == ref[key].shape, (group, key)
        np.testing.assert_allclose(g, ref[key], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{group} {key}")


def test_mode_group_params_cross_the_bridge(group_run):
    """The group's own params come across from the flax variables and
    nothing else is added: the learned queries, the level embedding, the
    np-feature projection; no query projection for random queries."""
    group, variables, ref, got = group_run
    params = variables["params"]
    own = {"level_np_max_fullsample_prenorm": {
               "level_embed", "np_feat_proj_0", "np_feat_proj_1",
               "query_proj_0"},
           "learned_queries_dropout_eval": {"query_feat", "query_pos"},
           "random_queries": set(), "random_query_both_normal": set()}[group]
    assert own <= set(params), sorted(params)
    if group.startswith("random"):
        assert not any(k.startswith("query_") for k in params)
    if group.startswith("learned_queries"):
        L = got["pred_masks_seg"].shape[0]
        assert got["pred_masks_vox"].shape[0] == L > 1
