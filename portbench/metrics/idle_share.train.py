"""Share of the traced window in which no kernel, copy or set ran on the
card, in %, in `train.mask3d.b8`."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
