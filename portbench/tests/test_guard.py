"""The import guard compares top-level module names whole."""

import pytest

from portbench import guard


@pytest.mark.parametrize("modules,found", [
    (["unscene3d_torch", "unscene3d_torch.ops.conv3", "torch"], []),
    (["unscene3d_tpu.ops"], ["unscene3d_tpu"]),
    (["jax", "jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jaxtyping", "flaxen", "unscene3d_tpu_extra"], []),
])
def test_forbidden_by_whole_top_level_name(modules, found):
    assert guard.forbidden_modules(modules) == found


def test_this_process_holds_no_forbidden_module():
    import portbench.run  # noqa: F401
    import unscene3d_torch.train.loop  # noqa: F401
    assert guard.forbidden_modules() == []
