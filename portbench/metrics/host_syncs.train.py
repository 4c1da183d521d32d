"""Device-to-host reads a train step (the program's counters
`host_syncs.<site>` summed, over its count of `step` spans), in
`train.mask3d.b8`."""

from portbench import program


def read(ctx):
    return program.per_step("host_syncs")
