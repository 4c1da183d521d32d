"""Rounds of the matcher's auction a train step (the program's counter
`auction_rounds` over its count of `step` spans,
losses/matcher.py:solve_lsap_auction), in `train.mask3d.b8-small`."""

from portbench import program


def read(ctx):
    return program.per_step("auction_rounds")
