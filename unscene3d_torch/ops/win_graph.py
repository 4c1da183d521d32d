"""Window tables of one level's k3 topology (the port's copy of
unscene3d_tpu/ops/window_conv.py:build_win_graph). Its two inner passes run
in the port's native library (`native/kernel_maps.cpp`: `win_lo_reg`,
`win_fill_lidx`), as the reference's `win_tables_native` serves them;
`native=False` runs their numpy twins.

The TPU's k3 kernel streams one union window of `w_union` rows per
supertile (G consecutive 256-row tiles) and selects each off-centre
neighbour inside a per-region sub-window of `w_sub` rows (region = k // 9:
the dx = -1 slice, the tile's own rows, the dx = +1 slice). These tables say
where the windows start (`r0`, `starts`), where each neighbour sits inside
its sub-window (`lidx`, -1 for a missing or spilled neighbour) and which
pairs fell outside (`spill_*`). The model's Hopper kernels read the (27, N)
neighbour map directly and need none of this; kernel 9
(ops/win_decompose.py) reads rows through these tables so that the TPU
kernel's decomposition can be timed on the card. Held bitwise against the
JAX function by tests/test_torch_proto.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from unscene3d_torch import native as native_lib

TILE = 256


class SpillPlanExceeded(AssertionError):
    """The level's spill tables outgrew the given `spill_plan`; `needed`
    carries the realized requirement."""

    def __init__(self, msg: str, needed: dict | None = None):
        super().__init__(msg)
        self.needed = needed or {}


@dataclasses.dataclass
class WinGraph:
    """Fields of unscene3d_tpu/ops/window_conv.py:WinGraph, numpy arrays."""

    r0: np.ndarray          # (n_super,) int32 union-window start row
    starts: np.ndarray      # (n_tiles, 3) int32 region start relative to r0
    lidx: np.ndarray        # (n_pad, 26) int16 neighbour row relative to its
    #                         region start; -1 = missing or spilled
    spill_out: np.ndarray   # (P8,) int32 out row (sentinel n_pad - 1)
    spill_in: np.ndarray    # (P8,) int32 in row (sentinel n_pad - 1)
    spill_k: np.ndarray     # (P8,) int32 offset id in [0, 27)
    spill_rows: np.ndarray  # (P8,) int32 out row relative to its tile; -1
    sp_q0: np.ndarray       # (n_tiles,) int32 8-aligned slice start
    sp_qn: np.ndarray       # (n_tiles, 2) int32 [qa, qb) inside the slice
    w_subs: tuple = ()
    w_sub: int = 512
    w_union: int = 2304
    group: int = 1
    tile: int = TILE
    spill_q: int = 0

    @property
    def num_spill_padded(self) -> int:
        return self.spill_out.shape[0]

    @property
    def num_spills(self) -> int:
        """Real spilled pairs (the tables are padded with sentinels)."""
        return int((self.spill_rows >= 0).sum())


def build_win_graph(nbr_idx: np.ndarray, n_pad: int, w_sub=384,
                    w_union: int = 4096, spill_plan: tuple | None = None,
                    group: int = 1, tile: int = TILE,
                    native: bool = True) -> WinGraph:
    """Window tables from a (27, n_pad) k3 neighbour map (missing ->
    n_pad - 1). The centre offset (13) is not tabled. `w_sub` is one width
    or (W_own, W_dx); `w_union` is clamped to n_pad; a group whose G * tile
    rows exceed the union window is halved until they fit (grouping only
    amortizes the window read). The group must be a power of two: the
    reference halves any group the same way, and a group that is none (6
    -> 3) may stop dividing the level's tiles and trip its divisibility
    assert, so the port raises ValueError for one up front. `native` picks
    the C++ or the numpy passes (bitwise equal)."""
    nbr_idx = np.asarray(nbr_idx)
    assert nbr_idx.shape[0] == 27 and nbr_idx.shape[1] == n_pad
    group, tile = int(group), int(tile)
    if group < 1 or group & (group - 1):
        raise ValueError(f"build_win_graph: group {group} is not a power of "
                         "two")
    ks = [k for k in range(27) if k != 13]
    if isinstance(w_sub, (tuple, list)):
        wo, wx = (min(int(v), n_pad) for v in w_sub[:2])
        w_reg = (wx, wo, wx)
    else:
        w = min(int(w_sub), n_pad)
        w_reg = (w, w, w)
    w_union = min(int(w_union), n_pad)
    while group > 1 and group * tile > w_union:
        group //= 2
    assert group * tile <= w_union, (group, tile, w_union)
    assert n_pad % (tile * group) == 0 and n_pad >= w_union >= max(w_reg)
    assert w_union % 32 == 0 and tile % 32 == 0
    assert all(w % 32 == 0 for w in w_reg)
    # the own-region window must be able to contain a full tile
    assert w_reg[1] >= tile, (w_reg, tile)
    n_tiles = n_pad // tile
    n_super = n_tiles // group
    tile_of = np.arange(n_pad) // tile
    super_of_tile = np.arange(n_tiles) // group

    BIG = np.int64(1 << 40)
    # per (tile, region) 32-aligned window starts, then the union start
    if native:
        lo_reg = native_lib.win_lo_reg(nbr_idx, n_pad, tile)
    else:
        lo_reg = np.full((3, n_tiles), BIG, np.int64)
        for k in ks:
            idx = nbr_idx[k].astype(np.int64)
            valid = idx != (n_pad - 1)
            per_tile = np.where(valid, idx, BIG).reshape(n_tiles, tile)
            lo = per_tile.min(axis=1)
            r = k // 9
            lo_reg[r] = np.minimum(lo_reg[r],
                                   np.where(lo == BIG, BIG, lo & ~31))
    tstart = np.arange(n_tiles, dtype=np.int64) * tile
    r0_tile = lo_reg.min(axis=0)
    r0_tile = np.where(r0_tile == BIG, tstart, r0_tile)
    # union start per supertile: low enough for every member tile's offsets,
    # high enough that the last member's own rows stay inside
    sstart = tstart.reshape(n_super, group)[:, 0]
    send = sstart + group * tile
    r0 = r0_tile.reshape(n_super, group).min(axis=1)
    r0 = np.clip(r0, send - w_union, sstart)
    r0 = np.clip(r0, 0, n_pad - w_union) & ~31

    r0_of_tile = r0[super_of_tile]
    starts = np.zeros((n_tiles, 3), np.int32)
    lo_of = np.empty((3, n_tiles), np.int64)
    for r in range(3):
        lo = np.where(lo_reg[r] == BIG, r0_of_tile, lo_reg[r])
        lo = np.clip(lo, r0_of_tile, r0_of_tile + w_union - w_reg[r])
        if r == 1:
            # the own-region window contains the tile's own rows
            lo = np.maximum(lo, tstart + tile - w_reg[1])
            lo = np.minimum(lo, tstart)
        starts[:, r] = (lo - r0_of_tile).astype(np.int32)
        lo_of[r] = lo

    if native:
        lidx, all_out, all_in, all_k = native_lib.win_fill_lidx(
            nbr_idx, n_pad, tile, lo_of, w_reg)
        sp_out, sp_in, sp_k = [all_out], [all_in], [all_k]
    else:
        lidx = np.full((n_pad, 26), -1, np.int16)
        sp_out, sp_in, sp_k = [], [], []
        for ki, k in enumerate(ks):
            idx = nbr_idx[k].astype(np.int64)
            valid = idx != (n_pad - 1)
            r = k // 9
            rel = idx - lo_of[r][tile_of]
            ok = valid & (rel >= 0) & (rel < w_reg[r])
            lidx[ok, ki] = rel[ok].astype(np.int16)
            bad = valid & ~ok
            if bad.any():
                rows = np.nonzero(bad)[0]
                sp_out.append(rows.astype(np.int32))
                sp_in.append(idx[rows].astype(np.int32))
                sp_k.append(np.full(len(rows), k, np.int32))

    # compact tile-sorted spill packing: tile t's pairs at 8-aligned slots
    # [q0[t], q0[t] + counts[t])
    n_spill = sum(len(a) for a in sp_out)
    if n_spill:
        all_out = np.concatenate(sp_out)
        all_in = np.concatenate(sp_in)
        all_k = np.concatenate(sp_k)
        t_of = all_out // tile
        counts = np.bincount(t_of, minlength=n_tiles)
    else:
        counts = np.zeros(n_tiles, np.int64)
    seg = -(-counts // 8) * 8
    q0 = np.concatenate([[0], np.cumsum(seg)[:-1]])
    q_need = int(seg.max()) if n_spill else 0
    p_need = int(seg.sum())
    if spill_plan is None:
        spill_q, p8 = q_need, p_need
    else:
        p8, spill_q = int(spill_plan[0]), int(spill_plan[1])
    if spill_q < q_need or p8 < p_need:
        raise SpillPlanExceeded(
            f"spill plan ({p8}, {spill_q}) < needed ({p_need}, {q_need})",
            needed={"win_spill": (p_need, q_need)})
    P = max(p8, spill_q) if (n_spill or p8 or spill_q) else 0
    q0c = np.minimum(q0, max(P - spill_q, 0))
    qa = q0 - q0c
    qb = qa + counts
    out = np.full(P, n_pad - 1, np.int32)
    inn = np.full(P, n_pad - 1, np.int32)
    kk = np.zeros(P, np.int32)
    rows = np.full(P, -1, np.int32)
    if n_spill:
        order = np.argsort(t_of, kind="stable")
        rank = np.arange(n_spill) - np.concatenate(
            [[0], np.cumsum(counts)[:-1]])[t_of[order]]
        slots = q0[t_of[order]] + rank
        out[slots] = all_out[order]
        inn[slots] = all_in[order]
        kk[slots] = all_k[order]
        rows[slots] = (all_out[order] - t_of[order] * tile).astype(np.int32)
    return WinGraph(
        r0=r0.astype(np.int32), starts=starts, lidx=lidx,
        spill_out=out, spill_in=inn, spill_k=kk, spill_rows=rows,
        sp_q0=q0c.astype(np.int32),
        sp_qn=np.stack([qa, qb], 1).astype(np.int32),
        w_subs=tuple(int(w) for w in w_reg),
        w_sub=int(max(w_reg)), w_union=int(w_union),
        group=group, tile=tile, spill_q=int(spill_q))
