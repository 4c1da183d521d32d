"""Device times of the bf16 ring gather-GEMM body at the shapes
chip_smoke.py times it, with kernel 6 beside kernel 1 on the same inputs.

    python3 -m unscene3d_torch.bench.ring_times

Kernel 1 (`conv3_fwd`) at the bench scene's L0 3->32, L0 128->96 with a
residual and L3 384->256, and kernel 2's up2 L1->L0 96->96 (`k_apply`);
kernel 6 (`csr_conv3_fwd`) at the bench scene's L0 128->96 with a
residual, L0 3->32 and L2 128->128 and as dx at the train batch's L0 (gm
with flip-transposed 128->96 weights), each with kernel 1 on the same
inputs in turns (6, 1, 1, 6). CUDA events, median of 10 launches a turn.
Prints one line per case and, last, one JSON object of every time. The
scenes, data and seeds are fixed: run it in two checkouts in turns to
compare them on one card.
"""

from __future__ import annotations

import json
import sys

import torch

from unscene3d_torch.bench.timing import clock_name, device_ms
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_scene
from unscene3d_torch.ops.conv3 import conv3_fwd, flip_transpose
from unscene3d_torch.ops.csr_conv import csr_conv3_fwd
from unscene3d_torch.ops.k_apply import k_apply
from unscene3d_torch.runtime import resolve_device

# bench.py's headline inference scene and its batch-8 train batch, as
# chip_smoke.py builds them
BENCH_SCENE = dict(num_points=250_000, num_objects=12, extent=8.0, seed=0)
TRAIN_SCENE = dict(num_points=125_000, num_objects=12, extent=8.0)
TRAIN_BATCH = 8
CSR_LEVELS = (0, 1, 2)


def run(device="cuda", bench=BENCH_SCENE, train=TRAIN_SCENE,
        train_batch=TRAIN_BATCH, voxel=0.02) -> dict:
    """Name of each case -> milliseconds (see the top)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev,
                                                             torch.bfloat16)

    def affine(cout, n=None):
        kw = dict(scale=torch.rand(cout, generator=g).add(0.5).to(dev),
                  shift=torch.randn(cout, generator=g).to(dev), relu=True)
        if n is not None:
            kw["residual"] = rnd(n, cout)
        return kw

    def ms(fn):
        return device_ms(fn, dev)

    out = {}
    batch, _ = FreeMaskCollator(voxel_size=voxel, fine_buckets=True,
                                fps_queries=100, csr_levels=CSR_LEVELS)(
        [make_scene(**bench)])
    L = [lv.to(dev) for lv in batch.graph.levels]
    for lv, cin, cout, res in ((0, 3, 32, False), (0, 128, 96, True),
                               (3, 384, 256, False)):
        lvl = L[lv]
        x, w = rnd(lvl.num_padded, cin), rnd(27, cin, cout, scale=cin ** -.5)
        kw = affine(cout, lvl.num_padded if res else None)
        out[f"conv3_fwd L{lv} {cin}->{cout}" + (" +res" if res else "")] = (
            ms(lambda: conv3_fwd(x, w, lvl.nbr_idx, lvl.valid, **kw)))
    xu, wu = rnd(L[1].num_padded, 96), rnd(8, 96, 96, scale=96 ** -.5)
    out["k_apply up2 L1->L0 96->96"] = ms(
        lambda: k_apply(xu, L[0].up_idx, wu, L[0].valid))

    def beside_kernel_1(name, x, w, lvl, kw):
        """Kernel 6 and kernel 1 on the same inputs, in turns 6, 1, 1, 6."""
        k6 = lambda: csr_conv3_fwd(x, w, lvl.csr, lvl.valid, **kw)  # noqa
        k1 = lambda: conv3_fwd(x, w, lvl.nbr_idx, lvl.valid, **kw)  # noqa
        t6, t1, t1b, t6b = ms(k6), ms(k1), ms(k1), ms(k6)
        out[f"csr_conv3 {name}"] = (t6 + t6b) / 2
        out[f"conv3_fwd beside it, {name}"] = (t1 + t1b) / 2

    for lv, cin, cout, res in ((0, 128, 96, True), (0, 3, 32, False),
                               (2, 128, 128, False)):
        lvl = L[lv]
        x, w = rnd(lvl.num_padded, cin), rnd(27, cin, cout, scale=cin ** -.5)
        beside_kernel_1(f"L{lv} {cin}->{cout}" + (" +res" if res else ""), x,
                        w, lvl, affine(cout, lvl.num_padded if res else None))
    del batch, L, x, w, xu, wu
    scenes = [make_scene(**train, seed=100 + i) for i in range(train_batch)]
    tbatch, _ = FreeMaskCollator(voxel_size=voxel, fps_queries=100,
                                 csr_levels=(0,))(scenes)
    lvl = tbatch.graph.levels[0].to(dev)
    gm = rnd(lvl.num_padded, 96) * lvl.valid[:, None].to(torch.bfloat16)
    wf = flip_transpose(rnd(27, 128, 96, scale=128 ** -.5))
    beside_kernel_1("as dx, train L0 128->96", gm, wf, lvl, {})
    return out


def main() -> int:
    from unscene3d_torch.runtime import gpu_name_and_power_limit

    times = run()
    card = gpu_name_and_power_limit().splitlines()[0]
    for name, t in times.items():
        print(f"{name:44s} {t:.4f} ms")
    print(card)
    print(json.dumps({"card": card, "clock": clock_name("cuda"),
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
