"""Timing of one function on a device: CUDA events on the card, the host
clock on the CPU (where the result is no device time and is labelled so).

A kernel is timed `spin=True`: each run then starts behind a spin kernel of
about a millisecond (`torch.cuda._sleep`), queued before the start event.
The card is still busy with it while the host queues the start event, the
call and the end event, so the interval holds the call's device work and
not the host's time to issue it (a Python wrapper's checks and launch take
tens of microseconds, longer than a small kernel runs). Without it, as for
a whole forward, the interval also holds the host's issue time wherever the
card waits for it."""

from __future__ import annotations

import statistics
import time

import torch

SPIN_CYCLES = 2_000_000   # ~1 ms at the H100's clocks


def device_ms(fn, device, reps: int = 10, warmup: int = 2,
              spin: bool = False) -> float:
    """Median milliseconds of fn() over `reps` runs after `warmup` runs;
    `spin`: each run behind a spin kernel (see the top)."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
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
