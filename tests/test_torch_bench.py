"""The port's measuring entry points on the CPU: the row fingerprints of
`bench/ring_times.py` that compare two checkouts' outputs bitwise (its
cases: tests/test_torch_proto.py), `bench/f32_path.py` (the f32 forward and
train step) and `bench/reduce_times.py` (the pools and the segment sum) at
a tiny size. On the CPU they run the kernels'
plain twins and their times are host-clock times of those, no device
times; the card runs them at full size."""

import pytest
import torch

from unscene3d_torch.bench import f32_path, reduce_times, ring_times


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_pool():
    """One thread for torch and the BLAS pools while this module runs: the
    suite runs several workers at once."""
    import threadpoolctl

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fingerprint_tells_rows_apart(dtype):
    """Equal rows give equal fingerprints; a row whose bits differ in one
    element gives another."""
    g = torch.Generator().manual_seed(0)
    out = torch.randn(64, 40, generator=g).to(dtype)
    a = ring_times.fingerprint(out)
    assert a.shape == (64,) and a.dtype == torch.int64
    assert torch.equal(a, ring_times.fingerprint(out.clone()))
    other = out.clone()
    other[7, 13] = -other[7, 13]
    b = ring_times.fingerprint(other)
    assert (a != b).nonzero().flatten().tolist() == [7]


def test_f32_path_numbers():
    """The f32 forward and a batch of two through two train steps: every
    number finite and positive."""
    out = f32_path.run(
        "cpu", bench=dict(num_points=3000, num_objects=3, extent=2.0,
                          seed=0),
        train=dict(num_points=2000, num_objects=3, extent=2.0),
        train_batch=2, steps=1, voxel=0.1)
    assert set(out) == {"forward_ms", "step_first_ms", "step_ms",
                        "scenes_per_s"}
    assert all(v > 0 and v == v for v in out.values())


def test_reduce_times_cases():
    """Every pool instance (4 bench levels x C=3 and 128 in f32, C=128 in
    bf16, and the train L0->L1) and the segment sum of both batches, again
    with pieces of 16 rows: a time and one fingerprint per output row."""
    rows = {}
    out = reduce_times.run(
        "cpu", bench=dict(num_points=3000, num_objects=3, extent=2.0,
                          seed=0),
        train=dict(num_points=2000, num_objects=3, extent=2.0),
        train_batch=2, voxel=0.1, rows=rows, rows_per_piece=(16,))
    assert set(out) == set(rows) and len(out) == 13 + 9
    assert all(v > 0 for v in out.values())
    pools = [k for k in out if " pool " in k]
    assert len(pools) == 9 + 5 and "float32 pool bench L3->L4 C=3" in pools
    seg = [k for k in out if "segment_sum train" in k]
    assert len(seg) == 4
    for dtype in ("float32", "bfloat16"):   # the twin reads no pieces
        a, b = (rows[k] for k in seg if k.startswith(dtype))
        assert torch.equal(a, b)
