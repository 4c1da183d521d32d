"""The train steps' model FLOPs (portbench/work/mask3d.py: the products of
the forward once and the backward twice, the rematerialised forward not
counted) over the traced window, as a share of one H100's f32 rate outside
the tensor cores (67 TFLOP/s; TF32 is off), in %, in `train.mask3d.b8`."""

from portbench import readers


def read(ctx):
    return readers.mfu_f32(ctx)
