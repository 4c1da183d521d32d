"""Pseudo-mask generation (counterpart of unscene3d_tpu/pseudo)."""
