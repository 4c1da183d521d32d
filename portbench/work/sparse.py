"""Operations and bytes of the sparse convolutions, with the arithmetic of
`chip_smoke.py`'s per-kernel `work=` tuples: each input byte read once and
each output byte written once, whatever a kernel reads again; FLOPs over
the valid pairs of the table (2 per multiply-add), not over the padded
rows or the rows a tile computes without a neighbour.

Every function returns (flops, bytes). `n` is a level's padded row count,
`pairs` the table's entries that are no miss (`hits`), `it` the bytes of
the features' type.
"""

from __future__ import annotations

import numpy as np

_IDX = 4      # int32 table entries
_F32 = 4


def hits(table) -> int:
    """Entries of a neighbour / child / parent table that are no miss
    (misses point at the table's largest row)."""
    t = np.asarray(table)
    return int((t != t.max()).sum())


def k3_fwd(n, pairs, cin, cout, it, epilogue=False, residual=False):
    """Kernel 1: x, W, the (27, n) map, the valid flags, the output; with
    the fused eval epilogue also scale and shift (f32) and a residual."""
    nbytes = (n * cin * it + 27 * cin * cout * it + 27 * n * _IDX + n
              + n * cout * it)
    if epilogue:
        nbytes += 2 * cout * _F32
    if residual:
        nbytes += n * cout * it
    return 2 * pairs * cin * cout, nbytes


def k3_dx_dw(n, pairs, cin, cout, it):
    """Kernel 4 (dx) then kernel 5 (dW): x read and dx written, gm, W read
    and dW written, the map and the flags; two products over the pairs."""
    nbytes = (2 * n * cin * it + n * cout * it + 2 * 27 * cin * cout * it
              + 27 * n * _IDX + n)
    return 4 * pairs * cin * cout, nbytes


def k3_dw(n, pairs, cin, cout, it):
    """Kernel 5 alone (the stem, whose input needs no gradient): x, gm,
    the map, an f32 dW."""
    nbytes = n * cin * it + n * cout * it + 27 * n * _IDX \
        + 27 * cin * cout * _F32
    return 2 * pairs * cin * cout, nbytes


def k2_gemm(n_in, n_out, pairs, cin, cout, it):
    """Kernel 2 weighted (the k2 down / up conv or its dx): x (n_in rows),
    W (8, cin, cout), the (8, n_out) table, the output's flags, the
    output."""
    nbytes = (n_in * cin * it + 8 * cin * cout * it + 8 * n_out * _IDX
              + n_out + n_out * cout * it)
    return 2 * pairs * cin * cout, nbytes
