"""Mean device time of the matcher in a train step (the program's span
`criterion.matcher`: the cost matrices, the auction and its greedy
completion, losses/matcher.py), in ms, in `train.mask3d.b8`."""

from portbench import program


def read(ctx):
    return program.span_ms("criterion.matcher")
