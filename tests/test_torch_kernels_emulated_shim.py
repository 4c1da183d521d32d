"""Checks of the CUDA emulation itself (tests/cuda_emu/cuda_shim.h, through
tests/cuda_emu/shim_checks.cu): the constructs the kernels rely on behave as
on the card, or fail as the card would.
"""

import pytest
import torch

from tests.cuda_emu.emulation import _p, emu  # noqa: F401


@pytest.mark.parametrize("offset,aligned", [(0, True), (16, True),
                                            (8, False), (3, False)])
def test_emulation_rejects_misaligned_wmma_pointers(emu, offset, aligned):
    """The card needs 32-byte aligned WMMA fragment pointers: the shim
    reports any other as cudaErrorMisalignedAddress (716), so that a shifted
    fragment the card would reject fails here first."""
    out = torch.full((16, 16), float("nan"))
    code = emu.emu_wmma_at(offset, _p(out))
    if aligned:
        assert code == 0 and torch.equal(out, torch.full((16, 16), 16.0))
    else:
        assert code == 716


@pytest.mark.parametrize("construct", ["col_major", "ballot"])
def test_emulation_of_col_major_fragments_and_ballots(emu, construct):
    """Two constructs of the shim that kernel 5 uses. "col_major": a
    column-major matrix_a fragment reads its tile transposed. "ballot":
    __ballot_sync puts each lane's predicate in its bit (ranks and counts
    per warp, over a block of two and a half warps)."""
    if construct == "col_major":
        tile = torch.arange(256, dtype=torch.float32).view(16, 16)
        out = torch.full((16, 16), float("nan"))
        assert emu.emu_wmma_col_major(_p(tile), _p(out)) == 0
        assert torch.equal(out, tile.t())
        return
    threads = 80
    pred = (torch.arange(threads) * 7 % 5 < 2).int()
    rank = torch.full((threads,), -1, dtype=torch.int32)
    count = torch.full((threads,), -1, dtype=torch.int32)
    assert emu.emu_ballot(_p(pred), _p(rank), _p(count), threads) == 0
    for w0 in range(0, threads, 32):
        p = pred[w0:w0 + 32]
        assert torch.equal(rank[w0:w0 + 32], (torch.cumsum(p, 0) - p).int())
        assert (count[w0:w0 + 32] == int(p.sum())).all()


def test_emulation_of_warp_shuffles(emu):
    """__shfl_sync from a fixed other lane, within segments of 8 lanes, and
    an __shfl_xor_sync butterfly sum (the same in every lane), over a block
    of three warps."""
    threads = 96
    vals = (torch.arange(threads, dtype=torch.int32) * 37 % 101).int()
    out = torch.full((threads, 3), float("nan"))
    assert emu.emu_shfl(_p(vals), _p(out), threads) == 0
    t = torch.arange(threads)
    base = t // 32 * 32
    lane = t % 32
    assert torch.equal(out[:, 0], vals[base + (lane + 5) % 32].float())
    assert torch.equal(out[:, 1],
                       vals[base + (lane & ~7) + (lane + 3) % 8].float())
    sums = vals.view(3, 32).sum(1).float().repeat_interleave(32)
    assert torch.equal(out[:, 2], sums)
