"""Mean device time of Mask3D's decoder in a train step (the program's span
`mask3d.decoder`: from the backbone's return to the forward's return,
models/mask3d.py), in ms, in `train.mask3d.b8`."""

from portbench import program


def read(ctx):
    return program.span_ms("mask3d.decoder")
