"""Mean device time of the matcher and criterion in a train step (CUDA
events around the trainer's criterion call: losses/matcher.py,
losses/criterion.py), in ms, in `train.mask3d.b8-small`."""

from portbench import readers


def read(ctx):
    return readers.span_ms(ctx, "criterion")
