"""What the per-layer metric files read from the program's own tracer
(`unscene3d_torch/utils/trace.py`): its spans and counters, recorded while
the traced run's profiler covers the window. Each function returns None
where the program has no tracer or recorded nothing, as a program from
before the tracer does."""

from __future__ import annotations

import importlib
import importlib.util
import statistics

TRACER = "unscene3d_torch.utils.trace"


def _trace():
    try:
        if importlib.util.find_spec(TRACER) is None:
            return None
    except ModuleNotFoundError:
        return None
    return importlib.import_module(TRACER)


def summary():
    """`trace.summary()`, or None."""
    trace = _trace()
    if trace is None:
        return None
    s = trace.summary()
    return s if s["spans"] or s["counters"] else None


def span_ms(name):
    """Mean device milliseconds of the program's span `name`."""
    s = summary()
    ms = s and s["spans"].get(name, {}).get("device_ms")
    return statistics.fmean(ms) if ms else None


def per_step(name):
    """The counter `name`, with every `name.<site>` added to it, over the
    count of `step` spans."""
    s = summary()
    steps = s and s["spans"].get("step", {}).get("n")
    if not steps:
        return None
    return sum(v for k, v in s["counters"].items()
               if k == name or k.startswith(name + ".")) / steps


def marks():
    """(start_ns, name) of the innermost open span at each span's start and
    end, sorted, as `portbench.trace.reduce_intervals` labels idle gaps by
    them; a step's end marks "between steps"."""
    trace = _trace()
    if trace is None or not trace.records():
        return None
    events = []
    for r in trace.records():
        events.append((r.start_ns, 1, r.name))
        events.append((r.end_ns, 0, r.parent or "between steps"))
    # at one instant an end sorts before a start
    return [(t, name) for t, _, name in sorted(events)]
