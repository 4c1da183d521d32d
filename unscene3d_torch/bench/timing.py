"""Timing of one function on a device: CUDA events on the card, the host
clock on the CPU (where the result is no device time and is labelled so)."""

from __future__ import annotations

import statistics
import time

import torch


def device_ms(fn, device, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `reps` runs after `warmup` runs."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def clock_name(device) -> str:
    return ("CUDA events" if torch.device(device).type == "cuda"
            else "host clock, CPU twins: no device time")
