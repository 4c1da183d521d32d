"""2D encoder registry (the counterpart of
unscene3d_tpu/models/encoders_2d/__init__.py; reference
models/encoders_2d/__init__.py:16-29)."""

from unscene3d_torch.models.encoders_2d.dino import DinoNet, ViTExtractor

__all__ = ["DinoNet", "ViTExtractor", "load_2d_model"]

_MODELS_2D = {"DinoNet": DinoNet}
_NOT_PORTED = {"LSegNet": "ROADMAP.md Queue 1 item 10 "
                          "(models/encoders_2d/lseg.py)"}


def load_2d_model(name: str):
    """The 2D encoder class of that name; LSegNet raises
    NotImplementedError (not ported yet), an unknown name KeyError."""
    if name in _NOT_PORTED:
        raise NotImplementedError(f"2d model {name!r} is not ported yet: "
                                  f"{_NOT_PORTED[name]}")
    if name not in _MODELS_2D:
        known = sorted([*_MODELS_2D, *_NOT_PORTED])
        raise KeyError(f"unknown 2d model {name!r}; known: {known}")
    return _MODELS_2D[name]
