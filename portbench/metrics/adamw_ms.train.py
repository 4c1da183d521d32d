"""Mean device time of the AdamW update in a train step (the program's span
`step.adamw`, train/loop.py), in ms, in `train.mask3d.b8`."""

from portbench import program


def read(ctx):
    return program.span_ms("step.adamw")
