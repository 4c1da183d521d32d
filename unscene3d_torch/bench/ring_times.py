"""Device times of the ring gather-GEMM body in both dtypes at the shapes
chip_smoke.py times it, with kernel 6 beside kernel 1 on the same inputs,
and a fingerprint of every output row.

    python3 -m unscene3d_torch.bench.ring_times [--save FILE]
    python3 -m unscene3d_torch.bench.ring_times --compare FILE_A FILE_B

For f32 and then bf16: kernel 1 (`conv3_fwd`) at the bench scene's L0
3->32, L0 128->96 with a residual and L3 384->256, and kernel 2's up2
L1->L0 96->96 (`k_apply`); kernel 6 (`csr_conv3_fwd`) at the bench scene's
L0 128->96 with a residual, L0 3->32 and L2 128->128 and as dx at the train
batch's L0 (gm with flip-transposed 128->96 weights: the body of kernel 4's
dx), each with kernel 1 on the same inputs in turns (6, 1, 1, 6). CUDA
events, median of 10 launches a turn. Prints one line per case and, last,
one JSON object of every time. The scenes, data and seeds are fixed: run it
in two checkouts in turns to compare them on one card. `--save` writes each
case's output row fingerprints (a 64-bit hash of each row's bits) to FILE;
`--compare` says, per case, how many rows of two such files differ, so two
checkouts' outputs can be held bitwise equal.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from unscene3d_torch.bench.timing import clock_name, device_ms
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.ops.conv3 import conv3_fwd, flip_transpose, level_order
from unscene3d_torch.ops.csr_conv import csr_conv3_fwd
from unscene3d_torch.ops.k_apply import k_apply
from unscene3d_torch.runtime import resolve_device

# bench.py's headline inference scene and its batch-8 train batch, as
# chip_smoke.py builds them
BENCH_SCENE = dict(num_points=250_000, num_objects=12, extent=8.0, seed=0)
TRAIN_SCENE = dict(num_points=125_000, num_objects=12, extent=8.0)
TRAIN_BATCH = 8
CSR_LEVELS = (0, 1, 2)
DTYPES = (torch.float32, torch.bfloat16)


def fingerprint(out: torch.Tensor) -> torch.Tensor:
    """One int64 per row of `out`: its bits times fixed odd multipliers,
    summed (wrapping); rows with equal bits give equal fingerprints."""
    bits = out.contiguous().view(torch.int16 if out.element_size() == 2
                                 else torch.int32).to(torch.int64)
    g = torch.Generator().manual_seed(1)
    mult = torch.randint(1, 2**31, (bits.shape[1],), generator=g) * 2 + 1
    return (bits * mult.to(bits.device)).sum(1).cpu()


def run(device="cuda", bench=BENCH_SCENE, train=TRAIN_SCENE,
        train_batch=TRAIN_BATCH, voxel=0.02, rows=None) -> dict:
    """Name of each case -> milliseconds (see the top); `rows`, a dict,
    receives each case's output row fingerprints under the same name."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(0)
    out = {}
    rows = {} if rows is None else rows

    def ms(name, fn):
        rows[name] = fingerprint(fn())
        return device_ms(fn, dev, spin=True)

    batch, _ = FreeMaskCollator(voxel_size=voxel, fine_buckets=True,
                                fps_queries=100, csr_levels=CSR_LEVELS)(
        [make_scene(**bench)])
    L = [lv.to(dev) for lv in batch.graph.levels]
    scenes = [make_scene(**train, seed=100 + i) for i in range(train_batch)]
    tbatch, _ = FreeMaskCollator(voxel_size=voxel, fps_queries=100,
                                 csr_levels=(0,))(scenes)
    tlvl = tbatch.graph.levels[0].to(dev)
    del batch, tbatch, scenes
    for dtype in DTYPES:
        tag = str(dtype)[6:]

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

        def affine(cout, n=None):
            kw = dict(scale=torch.rand(cout, generator=g).add(0.5).to(dev),
                      shift=torch.randn(cout, generator=g).to(dev), relu=True)
            if n is not None:
                kw["residual"] = rnd(n, cout)
            return kw

        for lv, cin, cout, res in ((0, 3, 32, False), (0, 128, 96, True),
                                   (3, 384, 256, False)):
            lvl = L[lv]
            x = rnd(lvl.num_padded, cin)
            w = rnd(27, cin, cout, scale=cin ** -.5)
            kw = affine(cout, lvl.num_padded if res else None)
            name = (f"{tag} conv3_fwd L{lv} {cin}->{cout}"
                    + (" +res" if res else ""))
            order = level_order(lvl)
            out[name] = ms(name, lambda: conv3_fwd(x, w, lvl.nbr_idx,
                                                   lvl.valid, **kw,
                                                   order=order))
        xu, wu = rnd(L[1].num_padded, 96), rnd(8, 96, 96, scale=96 ** -.5)
        name = f"{tag} k_apply up2 L1->L0 96->96"
        out[name] = ms(name, lambda: k_apply(xu, L[0].up_idx, wu, L[0].valid))

        def beside_kernel_1(case, x, w, lvl, kw):
            """Kernel 6 and kernel 1 on the same inputs, in turns 6, 1, 1,
            6."""
            order = level_order(lvl)
            k6 = lambda: csr_conv3_fwd(x, w, lvl.csr, lvl.valid, **kw)  # noqa
            k1 = lambda: conv3_fwd(x, w, lvl.nbr_idx, lvl.valid, **kw,  # noqa
                                   order=order)
            n6 = f"{tag} csr_conv3 {case}"
            n1 = f"{tag} conv3_fwd beside it, {case}"
            t6, t1, t1b, t6b = ms(n6, k6), ms(n1, k1), ms(n1, k1), ms(n6, k6)
            out[n6] = (t6 + t6b) / 2
            out[n1] = (t1 + t1b) / 2

        for lv, cin, cout, res in ((0, 128, 96, True), (0, 3, 32, False),
                                   (2, 128, 128, False)):
            lvl = L[lv]
            x = rnd(lvl.num_padded, cin)
            w = rnd(27, cin, cout, scale=cin ** -.5)
            beside_kernel_1(f"L{lv} {cin}->{cout}" + (" +res" if res else ""),
                            x, w, lvl,
                            affine(cout, lvl.num_padded if res else None))
        gm = rnd(tlvl.num_padded, 96) * tlvl.valid[:, None].to(dtype)
        wf = flip_transpose(rnd(27, 128, 96, scale=128 ** -.5))
        beside_kernel_1("as dx, train L0 128->96", gm, wf, tlvl, {})
        del x, w, xu, wu, gm, wf
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def compare(path_a: str, path_b: str) -> dict:
    """Case -> rows whose fingerprints differ between two --save files."""
    a, b = torch.load(path_a), torch.load(path_b)
    return {name: int((a[name] != b[name]).sum()) if name in b
            else "missing" for name in a}


def main(argv: list[str]) -> int:
    from unscene3d_torch.runtime import gpu_name_and_power_limit

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save", help="write the output row fingerprints here")
    ap.add_argument("--compare", nargs=2, metavar="FILE",
                    help="rows differing between two --save files")
    args = ap.parse_args(argv)
    if args.compare:
        diff = compare(*args.compare)
        for name, n in diff.items():
            print(f"{name:52s} rows differing: {n}")
        print(json.dumps({"rows_differing": diff}))
        return 0
    rows = {}
    times = run(rows=rows)
    if args.save:
        torch.save(rows, args.save)
    card = gpu_name_and_power_limit().splitlines()[0]
    for name, t in times.items():
        print(f"{name:52s} {t:.4f} ms")
    print(card)
    print(json.dumps({"card": card, "clock": clock_name("cuda"),
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
