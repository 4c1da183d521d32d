"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload train.mask3d.b8 --seed 12345 \
        --seconds 30 --trace 0

Set-up (imports, the kernels' build, inputs and weights from the seed, the
warm-up steps) runs first and counts as `setup_s`; then the cell's runner
repeats its unit of work until `--seconds` have passed and the card has
finished it. With `--trace 0` the line holds the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics, read from a profiler
trace of the window and from the benchmark's own spans. After the window
the program is freed and the plain reference decides `correct`; each
compared number and its limit are the last lines on standard error and the
last key of the line.

Exits nonzero with no result line when the machine has fewer CUDA devices
than the cell asks for, when a module of JAX, flax or the JAX package was
loaded, or when the program is not there.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from portbench import guard, manifest  # noqa: E402


def _cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", sub)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def _device(torch, cell, trace_reduced=None) -> dict:
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": cell.chips,
         "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                  for i in range(cell.chips)),
         "power_limit": _power_limit()}
    if trace_reduced is not None:
        d["busy_s"] = trace_reduced["busy_s"]
        d["window_s"] = trace_reduced["window_s"]
    return d


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, log=print) -> dict:
    """The cell's result dict (the last key `checks`)."""
    import torch

    from portbench import trace as tracing

    cuda = torch.device(device).type == "cuda"
    run = manifest.runner(cell).setup(cell, seed, device)
    spans = marks = tr = None
    if trace:
        spans, marks = tracing.CudaSpans(), tracing.HostSpans()
        run.instrument(spans, marks)
        tr = tracing.Trace()
        tr.start()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t0_ns = time.perf_counter_ns()
    setup_s = t0 - t_process
    units = steps = 0
    while True:
        units += run.step()
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    t1_ns = time.perf_counter_ns()
    window_s = t1 - t0
    reduced = None
    if trace:
        tr.stop()
        reduced = tr.reduce(t0_ns, t1_ns, marks)
        log(f"trace: {reduced['device_events']} device events, clock "
            f"offset {reduced['clock_offset_ns']} ns, busy "
            f"{reduced['busy_s']:.3f} of {reduced['window_s']:.3f} s",
            file=sys.stderr)
    dev = _device(torch, cell, reduced)
    failed = run.failed()
    log(f"window: {steps} steps, {units} {run.unit} in {window_s:.3f} s; "
        f"set-up {setup_s:.3f} s; peak {dev['memory_peak_bytes']} bytes",
        file=sys.stderr)

    metrics = {}
    if not trace:
        have = {"setup_s": setup_s,
                cell.traffic["rate_metric"]: units / window_s,
                "peak_mem_gib": dev["memory_peak_bytes"] / 2 ** 30}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": have[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = dict(trace=reduced, spans=spans.ms(), work=run.work(),
                   window_s=window_s, steps=steps, units=units)
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    run.release()
    t_ref = time.perf_counter()
    numbers = run.check()
    log(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in cell.limits.items()}
    correct = (steps > 0 and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": steps, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = tracing.breakdown(reduced)
    for k, v in numbers.items():
        if k not in checks:
            log(f"reading (not compared): {k} {v!r}", file=sys.stderr)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = manifest.ROOT
    _cache_dirs(root)
    cell = manifest.find_cell(manifest.load_manifest(root), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_PROCESS, log=print)
    bad = guard.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
