"""Mean device time of the backbone's forward in a train step (CUDA
events by hooks around `model.backbone`, models/backbone.py), in ms, in
`train.mask3d.b8-small`."""

from portbench import readers


def read(ctx):
    return readers.span_ms(ctx, "backbone")
