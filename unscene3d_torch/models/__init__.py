"""Sparse UNet backbone and the Mask3D decoder (eval and train forwards),
plus the weight bridge from the JAX package's variables."""
