"""What the per-layer metric files (`portbench/metrics/<name>.py`) read,
shared by the metrics of one quantity in cells that report different
end-to-end metrics. Each function takes the traced run's context and
returns None where it finds nothing to read."""

from __future__ import annotations

import statistics

from portbench.work import PEAK_FLOPS, least_seconds

# the entry points of csrc/gather_gemm.cuh (kernel 1, kernel 4's dx, the
# weighted kernel 2) and csrc/conv3_bwd.cu (kernel 5 and its reduction)
CONV_KERNELS = ("gather_gemm_fma_ring_kernel", "gather_gemm_ring_kernel",
                "dw_pairs_kernel", "dw_reduce_kernel")


def idle_share(ctx):
    """1 - (union of the device intervals) / window, in %."""
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0 or tr["device_events"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu_f32(ctx):
    """The window's model FLOPs (`ctx["work"]`) over the window, as a share
    of one H100's published f32 rate outside the tensor cores, in %."""
    w = ctx["work"]
    if not w or not w["steps"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * w["flops"] / ctx["window_s"] / PEAK_FLOPS["float32"]


def conv_roofline(ctx):
    """The least time of the work on the conv kernels over their device
    time by name, in %."""
    tr, w = ctx["trace"], ctx["work"]
    if not tr or not w or not w["conv_items"]:
        return None
    device_s = sum(s for name, s in tr["by_name"].items()
                   if any(k in name for k in CONV_KERNELS))
    if device_s <= 0:
        return None
    return 100.0 * sum(least_seconds(f, b)
                       for f, b in w["conv_items"]) / device_s


def span_ms(ctx, name):
    """Mean device time of the named CUDA-event span, in ms."""
    ms = ctx["spans"].get(name)
    return statistics.fmean(ms) if ms else None
