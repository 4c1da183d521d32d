"""2D encoder registry (the counterpart of
unscene3d_tpu/models/encoders_2d/__init__.py; reference
models/encoders_2d/__init__.py:16-29)."""

from unscene3d_torch.models.encoders_2d.dino import DinoNet, ViTExtractor
from unscene3d_torch.models.encoders_2d.lseg import LSegFeatureNet, LSegNet

__all__ = ["DinoNet", "LSegFeatureNet", "LSegNet", "ViTExtractor",
           "load_2d_model"]

_MODELS_2D = {"DinoNet": DinoNet, "LSegNet": LSegNet}


def load_2d_model(name: str):
    """The 2D encoder class of that name; an unknown name raises
    KeyError."""
    if name not in _MODELS_2D:
        raise KeyError(f"unknown 2d model {name!r}; known: "
                       f"{sorted(_MODELS_2D)}")
    return _MODELS_2D[name]
