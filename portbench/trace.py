"""The traced window: torch.profiler over the card (CUDA activity only, so
that the host's work is not slowed by recording every operator), reduced
to what the per-layer readers need.

- device intervals: every kernel, copy and set on the card, on the
  profiler's clock;
- `busy_s`: the length of their union inside the window, `window_s` the
  window's length; the idle share is 1 - busy / window;
- device time by kernel name, and the idle gaps labelled by the host span
  (the benchmark's own, recorded on the host clock) that was open when
  each gap began.

The host clock and the profiler's are aligned at a `cudaDeviceSynchronize`
issued at a known host time at the window's start.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch


def _ns(ev, what):
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(1000 * getattr(ev, what + "_us")())


class HostSpans:
    """Named host-clock intervals (perf_counter_ns), open one at a time."""

    def __init__(self):
        self.marks = []          # (start_ns, name)

    def mark(self, name):
        self.marks.append((time.perf_counter_ns(), name))


class CudaSpans:
    """Device time between CUDA events recorded around a named call."""

    def __init__(self):
        self.open = {}
        self.done = collections.defaultdict(list)

    def start(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.open[name] = ev

    def stop(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.done[name].append((self.open.pop(name), ev))

    def ms(self) -> dict:
        """name -> [milliseconds of each call] (synchronise first)."""
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self.done.items()}


class Trace:
    def __init__(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.host0 = None

    def start(self):
        self.prof.start()
        torch.cuda.synchronize()
        self.host0 = time.perf_counter_ns()
        torch.cuda.synchronize()

    def stop(self):
        self.prof.stop()

    def reduce(self, t0_ns: int, t1_ns: int, spans: HostSpans) -> dict:
        """The window [t0_ns, t1_ns] on the host clock -> dict(busy_s,
        window_s, by_name {kernel: seconds}, gaps {host span: seconds},
        device_events, clock_offset_ns)."""
        events = self.prof.profiler.kineto_results.events()
        dev, syncs = [], []
        for ev in events:
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((_ns(ev, "start"), _ns(ev, "duration"),
                            ev.name()))
            elif ev.name() == "cudaDeviceSynchronize":
                syncs.append(_ns(ev, "start"))
        # the second synchronize in start() began right after host0; with
        # no runtime events recorded the two clocks are taken as one
        syncs.sort()
        offset = syncs[1] - self.host0 if len(syncs) >= 2 else 0
        iv = sorted((s - offset, s - offset + d, n) for s, d, n in dev)
        out = reduce_intervals(iv, t0_ns, t1_ns, spans.marks)
        out["clock_offset_ns"] = offset
        return out


def reduce_intervals(iv, t0_ns: int, t1_ns: int, marks) -> dict:
    """Device intervals (start_ns, end_ns, name), sorted by start, on the
    host clock, cut to the window [t0_ns, t1_ns]; marks: sorted (start_ns,
    host span name). -> dict(busy_s, window_s, by_name, gaps,
    device_events)."""
    iv = [(max(s, t0_ns), min(e, t1_ns), n) for s, e, n in iv
          if e > t0_ns and s < t1_ns]
    by_name = collections.Counter()
    gaps = collections.Counter()
    starts = [m[0] for m in marks]
    busy, end = 0, t0_ns
    for s, e, n in iv:
        by_name[n] += (e - s) / 1e9
        if s > end:
            gaps[_label(marks, starts, end)] += (s - end) / 1e9
        if e > end:
            busy += e - max(s, end)
            end = e
    if t1_ns > end:
        gaps[_label(marks, starts, end)] += (t1_ns - end) / 1e9
    return dict(busy_s=busy / 1e9, window_s=(t1_ns - t0_ns) / 1e9,
                by_name=dict(by_name), gaps=dict(gaps),
                device_events=len(iv))


def _label(marks, starts, t):
    i = bisect.bisect_right(starts, t) - 1
    return marks[i][1] if i >= 0 else "before the first step"


def breakdown(reduced: dict, n: int = 10) -> dict:
    """The `breakdown` of a traced run's result line."""
    ops = sorted(reduced["by_name"].items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(reduced["gaps"].items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
