"""The sparse convolutions' share of their roofline in the train steps:
the least time of the work on the port's conv kernels (k3 forward, dx and
dW, the k2 down / up convs and their dx; portbench/work/sparse.py) over the
device time of those kernels in the traced window, in %, in `train.mask3d.b8`. The
forwards that the backward recomputes (remat) run on these kernels and are
not counted as work."""

from portbench import readers


def read(ctx):
    return readers.conv_roofline(ctx)
