"""UnScene3D in PyTorch for one NVIDIA H100 (Hopper, sm_90a).

A port of the JAX package `unscene3d_tpu`, which stays in the repository as
the reference. Public functions keep the JAX package's tensor layouts: flat
`(N_pad, C)` features, k3 weights `(27, Cin, Cout)` with offsets z-fastest
and the centre at 13, k2 weights `(8, Cin, Cout)` with offset id
`dx*4 + dy*2 + dz`.

Every Pallas kernel of the JAX package has a hand-written CUDA kernel under
`csrc/`, built at first use (`ops/_build.py`) and bound with ctypes: the k3
conv from the neighbour map (kernel 1) or, at the collator's `csr_levels`,
from compacted valid pairs (kernel 6), the k2/pool gather, the segment sum,
the k3 backward, and the dense brick conv (kernel 7, `ops/brick_engine.py`).
Each kernel's wrapper runs its plain PyTorch twin for CPU tensors only; for
a CUDA tensor it launches the kernel or raises.

This package imports torch, numpy and scipy, never jax, flax or anything of
`unscene3d_tpu`.
"""

__version__ = "0.1.0"
