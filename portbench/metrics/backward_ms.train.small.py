"""Mean device time of the backward in a train step (the program's span
`step.backward`: `torch.autograd.grad` and the zero fill,
train/loop.py), in ms, in `train.mask3d.b8-small`."""

from portbench import program


def read(ctx):
    return program.span_ms("step.backward")
