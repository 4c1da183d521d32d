"""Sparse UNet backbones, the Mask3D decoder (eval and train forwards), the
MinkUNet / sparse ResNet families and the weight bridge from the JAX
package's variables. `load_model(name)` is the name registry of
unscene3d_tpu/models/__init__.py (reference models/__init__.py:18-31)."""

from unscene3d_torch.models.backbone import (Res16UNet14A, Res16UNet18A,
                                             Res16UNet18B, Res16UNet34A,
                                             Res16UNet34B, Res16UNet34C,
                                             Res16UNet34D, Res16UNetBase)
from unscene3d_torch.models.mask3d import Mask3D
from unscene3d_torch.models.resunet import (MinkUNetBase, ResNet14, ResNet18,
                                            ResNet34, ResNetBase, ResUNet14,
                                            ResUNet14A, ResUNet18, ResUNet18A,
                                            ResUNet34)

__all__ = ["Mask3D", "MinkUNetBase", "Res16UNetBase", "ResNetBase",
           "load_model"]

_MODELS = {cls.__name__: cls for cls in (
    Res16UNet14A, Res16UNet18A, Res16UNet18B, Res16UNet34A, Res16UNet34B,
    Res16UNet34C, Res16UNet34D, Mask3D, ResUNet14, ResUNet14A, ResUNet18,
    ResUNet18A, ResUNet34, ResNet14, ResNet18, ResNet34)}


def load_model(name: str):
    """The model class of that name; an unknown name raises KeyError."""
    if name not in _MODELS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_MODELS)}")
    return _MODELS[name]
