"""The work of one Mask3D(Res16UNet34C) train step, counted from a
batch's shapes and table hits.

`shape_summary` reads the counts from a collated batch's host tables;
`train_step` turns them into the step's FLOPs (the model's products:
forward once, backward twice; the rematerialised forward and the
elementwise work are not counted) and the items of its sparse-conv work
that run on the port's conv kernels (kernels 1, 2, 4, 5), each as (flops,
bytes), for the conv roofline.
"""

from __future__ import annotations

import numpy as np

from portbench.work import sparse

_WIDTHS = dict(planes=(32, 64, 128, 256, 256, 128, 96, 96),
               layers=(2, 3, 4, 6, 2, 2, 2, 2), init_dim=32, in_channels=3,
               out_channels=2)


def shape_summary(levels, scene_valid, seg_valid) -> dict:
    """levels: per level (valid (N,), nbr_idx (27, N), child_idx (8, N),
    up_idx (8, N) or None); scene_valid: per level (B, n_max) bool;
    seg_valid (B, S) bool. Plain counts, no tensors."""
    out = []
    for (valid, nbr, child, up), sv in zip(levels, scene_valid):
        out.append(dict(
            n=int(np.asarray(valid).shape[0]),
            n_valid=int(np.asarray(valid).sum()),
            pairs=sparse.hits(nbr),
            child_pairs=sparse.hits(child),
            up_pairs=None if up is None else sparse.hits(up),
            per_scene=np.asarray(sv).sum(1).astype(int).tolist()))
    return dict(levels=out,
                segments=np.asarray(seg_valid).sum(1).astype(int).tolist())


def _backbone(s, it):
    """(FLOPs of the backbone's products, conv-kernel items)."""
    lv = s["levels"]
    w = _WIDTHS
    flops, items = 0.0, []

    def k3(level, cin, cout, stem=False):
        nonlocal flops
        L = lv[level]
        f = sparse.k3_fwd(L["n"], L["pairs"], cin, cout, it)
        b = (sparse.k3_dw if stem else sparse.k3_dx_dw)(
            L["n"], L["pairs"], cin, cout, it)
        items.extend([f, b])
        flops += f[0] + b[0]

    def k1(level, cin, cout):
        nonlocal flops
        flops += 3 * 2 * lv[level]["n_valid"] * cin * cout

    def down2(fine, cin, cout):
        nonlocal flops
        F, C = lv[fine], lv[fine + 1]
        f = sparse.k2_gemm(F["n"], C["n"], C["child_pairs"], cin, cout, it)
        dx = sparse.k2_gemm(C["n"], F["n"], F["up_pairs"], cout, cin, it)
        items.extend([f, dx])
        # dW: one gathered product per valid fine row, plain torch
        flops += f[0] + dx[0] + 2 * F["n_valid"] * cin * cout

    def up2(coarse, cin, cout):
        nonlocal flops
        C, F = lv[coarse], lv[coarse - 1]
        f = sparse.k2_gemm(C["n"], F["n"], F["up_pairs"], cin, cout, it)
        dx = sparse.k2_gemm(F["n"], C["n"], C["child_pairs"], cout, cin, it)
        items.extend([f, dx])
        flops += f[0] + dx[0] + 2 * F["n_valid"] * cin * cout

    def blocks(level, cin, planes, n):
        for _ in range(n):
            k3(level, cin, planes)
            k3(level, planes, planes)
            if cin != planes:
                k1(level, cin, planes)
            cin = planes
        return planes

    p, layers = w["planes"], w["layers"]
    k3(0, w["in_channels"], w["init_dim"], stem=True)
    inp = w["init_dim"]
    for st in range(4):
        down2(st, inp, inp)
        inp = blocks(st + 1, inp, p[st], layers[st])
    skips = [p[2], p[1], p[0], w["init_dim"]]
    for u in range(4):
        up2(4 - u, inp, p[4 + u])
        inp = blocks(3 - u, p[4 + u] + skips[u], p[4 + u], layers[4 + u])
    # the final k1 head runs forward only (outside the loss)
    flops += 2 * lv[0]["n_valid"] * inp * w["out_channels"]
    return flops, items


def _decoder(s, model):
    """FLOPs of the decoder's dense products: forward once plus twice
    backward where a gradient flows; the block-mask readout forward only."""
    D, Q = model["hidden_dim"], model["num_queries"]
    F_, C = model["dim_feedforward"], model["num_classes"]
    B = len(s["segments"])
    fpn = [_WIDTHS["planes"][i] for i in (3, 4, 5, 6, 7)]
    lv = s["levels"]
    grad = 0.0
    grad += 2 * lv[0]["n_valid"] * fpn[-1] * D          # mask features
    grad += 2 * B * Q * D * D * 2                        # query projection
    n_sets = model["num_decoders"] * len(model["hlevels"]) + 1
    mask_module = (2 * B * Q * D * D * 2 + 2 * B * Q * D * C
                   + sum(2 * seg * Q * D for seg in s["segments"]))
    grad += n_sets * mask_module
    readout = 0.0
    for _ in range(model["num_decoders"]):
        for h in model["hlevels"]:
            ss = model["sample_sizes"][h]
            P = sum(min(ss, n) for n in lv[4 - h]["per_scene"])
            readout += 2 * P * Q * D
            grad += 2 * P * fpn[h] * D                   # squeeze
            grad += 2 * B * Q * D * D * 2 + 2 * P * D * D * 2   # cross q,o,k,v
            grad += 2 * 2 * Q * P * D                    # logits, attn @ v
            grad += 2 * B * Q * D * D * 4 + 2 * 2 * B * Q * Q * D   # self
            grad += 2 * 2 * B * Q * D * F_               # FFN
    return 3 * grad + readout


def train_step(summary: dict, model: dict, itemsize: int = 4) -> dict:
    """dict(flops=the step's model FLOPs, conv_items=[(flops, bytes)] of
    the work on the port's conv kernels)."""
    bb_flops, items = _backbone(summary, itemsize)
    return dict(flops=bb_flops + _decoder(summary, model), conv_items=items)
