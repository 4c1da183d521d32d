"""Spans and counters of the port's train step, kept in memory.

    from unscene3d_torch.utils import trace

    with trace.recording():
        trainer.train_step(batch, gen)
    trace.summary()   # {"spans": {name: {"n", "host_ms", "device_ms"}},
                      #  "counters": {name: total}}
    trace.reset()

The tracer records only while it is on: inside `recording()`, or while a
`torch.profiler` session runs (`torch.autograd.profiler._is_profiler_enabled`,
the flag `record_function` follows too). Off, a span or a count costs one
check of those two flags and records nothing.

A span records its name, its parent (the innermost span open in its thread),
the step it belongs to (the `step` span carries `Trainer.step`; a span opened
under it takes that index) and its start and end on `time.perf_counter_ns()`.
Once the process has initialised CUDA it also records a `Timer` (two CUDA
events on the current stream), whose milliseconds `summary()` reads. Spans
add no device work and no profiler range: a GPU-side annotation would count
as device time in a profiler's busy union.

A counter is a named integer added where the work happens, once per call
with the call's total. `host_syncs.<site>` counts the device-to-host reads on
the train step's path, one name per site. A count may be a 0-d device tensor
times a host integer (`conv3.dense_macs`, `conv3.pair_macs`: ops/conv3.py):
the tracer keeps the tensor, adds the multipliers of each one, and reads the
tensors back in `summary()`, after the window, so counting reads nothing
back in the step.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import torch
from torch.autograd import profiler as _profiler


class Timer:
    """Milliseconds between construction and `stop()`: two CUDA events on
    the current stream where `cuda` (read when `ms()` is called, which
    waits for the second), the host clock otherwise."""

    __slots__ = ("cuda", "events", "t0", "t1")

    def __init__(self, cuda: bool):
        self.cuda = cuda
        if cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self.events[1].record()
        else:
            self.t1 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            self.events[1].synchronize()
            return self.events[0].elapsed_time(self.events[1])
        return 1e3 * (self.t1 - self.t0)


@dataclasses.dataclass
class SpanRecord:
    """One finished span; `device` is its Timer, or its milliseconds once
    read, or None without CUDA."""

    name: str
    parent: str | None
    step: int | None
    start_ns: int
    end_ns: int
    device: Timer | float | None

    def device_ms(self) -> float | None:
        if isinstance(self.device, Timer):
            self.device = self.device.ms()
        return self.device


_lock = threading.Lock()
_local = threading.local()
_records: list[SpanRecord] = []
_counters: collections.Counter = collections.Counter()
# name -> {id(tensor): [tensor, multiplier]}: device counts not read yet
_pending: dict = {}
_recording = 0          # depth of open recording() blocks


class _Span:
    __slots__ = ("name", "step", "parent", "start_ns", "timer")

    def __init__(self, name, step):
        self.name, self.step = name, step

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        outer = stack[-1] if stack else None
        self.parent = outer.name if outer else None
        if self.step is None and outer is not None:
            self.step = outer.step
        stack.append(self)
        self.timer = Timer(True) if torch.cuda.is_initialized() else None
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        if self.timer is not None:
            self.timer.stop()
        _local.stack.pop()
        rec = SpanRecord(self.name, self.parent, self.step, self.start_ns,
                         end_ns, self.timer)
        with _lock:
            _records.append(rec)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_OFF = _Off()


def span(name: str, step: int | None = None):
    """A context manager that records the span `name` while the tracer is
    on; `step` marks the step span (its children inherit it)."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, step)


def count(name: str, n: int | torch.Tensor = 1, times: int = 1) -> None:
    """Add `n` x `times` to the counter `name` while the tracer is on; `n`
    may be a 0-d integer tensor on any device, read in `summary()`."""
    if not (_recording or _profiler._is_profiler_enabled):
        return
    with _lock:
        if isinstance(n, torch.Tensor):
            held = _pending.setdefault(name, {}).setdefault(id(n), [n, 0])
            held[1] += times
        else:
            _counters[name] += n * times


def _read_pending() -> None:
    """Fold the device counts into the counters: one read a device. Called
    under the lock."""
    by_device = collections.defaultdict(list)
    for name, held in _pending.items():
        for t, times in held.values():
            by_device[t.device].append((name, t, times))
    for items in by_device.values():
        values = torch.stack([t for _, t, _ in items]).tolist()
        for (name, _, times), v in zip(items, values):
            _counters[name] += int(v) * times
    _pending.clear()


@contextlib.contextmanager
def recording():
    """Turn the tracer on for the block."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def records() -> list[SpanRecord]:
    """The finished spans, in the order they ended."""
    with _lock:
        return list(_records)


def summary() -> dict:
    """{"spans": {name: {"n", "host_ms": [...], "device_ms": [...]}},
    "counters": {name: total}}; device_ms is empty without CUDA. Reading
    device times waits for each span's end event."""
    spans = {}
    for r in records():
        s = spans.setdefault(r.name, {"n": 0, "host_ms": [], "device_ms": []})
        s["n"] += 1
        s["host_ms"].append((r.end_ns - r.start_ns) / 1e6)
        ms = r.device_ms()
        if ms is not None:
            s["device_ms"].append(ms)
    with _lock:
        _read_pending()
        counters = dict(_counters)
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Forget every span and counter recorded so far."""
    with _lock:
        _records.clear()
        _counters.clear()
        _pending.clear()
