"""Products the k3 gather-GEMM computes over the valid pairs' products, in
`train.mask3d.b8-small`: the program's counter `conv3.dense_macs` (32 x the live
(offset, 32-row group) pairs of each launch of kernel 1 and kernel 4's dx,
x Cin x Cout) over `conv3.pair_macs` (the valid pairs x Cin x Cout), both
a step (unscene3d_torch/ops/conv3.py). 1 is no dead row in any group."""

from portbench import program


def read(ctx):
    dense = program.per_step("conv3.dense_macs")
    pairs = program.per_step("conv3.pair_macs")
    return dense / pairs if dense and pairs else None
