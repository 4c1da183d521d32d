"""Device times of kernel 2's 8-child pool sum and of kernel 3 (the segment
sum) at every instance the main path runs, and a fingerprint of every
output row.

    python3 -m unscene3d_torch.bench.reduce_times [--save FILE]
        [--rows-per-piece R ...]
    python3 -m unscene3d_torch.bench.reduce_times --compare FILE_A FILE_B

Cases, f32 and then bf16: the pool (`k_apply` with no weights, as
`avg_pool2` calls it) at the bench scene's L0->L1, L1->L2, L2->L3 and
L3->L4 with C=128 (the mask features, model dtype) and, in f32 only, C=3
(the coordinates), and at the train batch's L0->L1 with C=128; the segment
sum (`segment_sum`, as Mask3D.forward's mask-feature pool calls it) over the
bench scene's and the train batch's level 0 with C=128, and again for each
`--rows-per-piece` R with the order cut into pieces of R rows. CUDA events,
median of 10 launches. Prints one line per case and, last, one JSON object
of every time. The scenes, data and seeds are fixed: run it in two
checkouts in turns to compare them on one card. `--save` and `--compare` as
in `bench/ring_times.py`: the pool's rows must not differ between two
checkouts (the same f32 adds in the same order); the segment sum's may (its
order of adds is the kernel's own).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from unscene3d_torch.bench.ring_times import (BENCH_SCENE, TRAIN_BATCH,
                                              TRAIN_SCENE, compare,
                                              fingerprint)
from unscene3d_torch.bench.timing import clock_name, device_ms
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.ops import segment_pool
from unscene3d_torch.ops.k_apply import k_apply
from unscene3d_torch.runtime import resolve_device

DTYPES = (torch.float32, torch.bfloat16)


def _walk(batch, dev, rows_per_piece=None):
    """The keyword arguments of segment_sum for the batch's host tables; a
    checkout from before the pieces (timed in turns against this one)
    takes order and offsets alone."""
    walk = dict(order=batch.seg_order.to(dev),
                offsets=batch.seg_offsets.to(dev))
    if hasattr(batch, "seg_pieces"):
        pieces = batch.seg_pieces
        if rows_per_piece is not None:
            pieces = torch.from_numpy(segment_pool.segment_pieces(
                batch.seg_offsets.numpy(), rows_per_piece))
        walk["pieces"] = pieces.to(dev)
    return walk


def run(device="cuda", bench=BENCH_SCENE, train=TRAIN_SCENE,
        train_batch=TRAIN_BATCH, voxel=0.02, rows=None,
        rows_per_piece=()) -> dict:
    """Name of each case -> milliseconds (see the top); `rows`, a dict,
    receives each case's output row fingerprints under the same name."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(0)
    out = {}
    rows = {} if rows is None else rows

    def ms(name, fn):
        rows[name] = fingerprint(fn())
        out[name] = device_ms(fn, dev, spin=True)

    batches = {"bench": FreeMaskCollator(voxel_size=voxel, fine_buckets=True,
                                         fps_queries=100)(
        [make_scene(**bench)])[0]}
    batches["train"] = FreeMaskCollator(voxel_size=voxel, fps_queries=100)(
        [make_scene(**train, seed=100 + i) for i in range(train_batch)])[0]
    for dtype in DTYPES:
        tag = str(dtype)[6:]
        for name, batch in batches.items():
            L = [lv.to(dev) for lv in batch.graph.levels]
            for lv in range(4 if name == "bench" else 1):
                fine, coarse = L[lv], L[lv + 1]
                for c in (3, 128) if dtype == torch.float32 else (128,):
                    if c == 3 and name == "train":
                        continue
                    x = torch.randn(fine.num_padded, c, generator=g).to(
                        dev, dtype)
                    ms(f"{tag} pool {name} L{lv}->L{lv + 1} C={c}",
                       lambda: k_apply(x, coarse.child_idx, None,
                                       coarse.valid))
            S = batch.batch_size * batch.num_segments_padded
            seg = (L[0].coords[:, 0].long() * batch.num_segments_padded
                   + batch.point2segment.to(dev).long())
            xs = torch.randn(L[0].num_padded, 128, generator=g).to(dev, dtype)
            for r in (None, *rows_per_piece):
                walk = _walk(batch, dev, r)
                ms(f"{tag} segment_sum {name} ({L[0].num_padded},128)->({S},"
                   f"128)" + ("" if r is None else f" R={r}"),
                   lambda: segment_pool.segment_sum(xs, seg, S, L[0].valid,
                                                    **walk))
            del L, x, xs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    from unscene3d_torch.runtime import gpu_name_and_power_limit

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save", help="write the output row fingerprints here")
    ap.add_argument("--compare", nargs=2, metavar="FILE",
                    help="rows differing between two --save files")
    ap.add_argument("--rows-per-piece", type=int, nargs="*", default=(),
                    metavar="R", help="also time the segment sum with the "
                    "order cut into pieces of R rows")
    args = ap.parse_args(argv)
    if args.compare:
        diff = compare(*args.compare)
        for name, n in diff.items():
            print(f"{name:60s} rows differing: {n}")
        print(json.dumps({"rows_differing": diff}))
        return 0
    rows = {}
    times = run(rows=rows, rows_per_piece=args.rows_per_piece)
    if args.save:
        torch.save(rows, args.save)
    card = gpu_name_and_power_limit().splitlines()[0]
    for name, t in times.items():
        print(f"{name:60s} {t:.4f} ms")
    print(card)
    print(json.dumps({"card": card, "clock": clock_name("cuda"),
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
