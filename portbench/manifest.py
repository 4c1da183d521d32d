"""`BENCHMARK.json` and the files it names.

Every configuration, traffic mix and per-layer metric is found by its name:
a configuration at the `file` its entry gives, a traffic mix at
`portbench/traffic/<traffic>.json` (whose `runner` key names
`portbench/runners/<runner>.py`), a per-layer metric's reader at
`portbench/metrics/<name>.py`, and a cell's correctness limits at
`portbench/limits/<workload>.json`. A new cell or metric is new files and
new entries, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # portbench/traffic/<traffic>.json
    end_to_end: list      # the manifest's metric entries this cell reports
    per_layer: list
    limits: dict          # compared number -> limit


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path):
    with open(path) as f:
        return json.load(f)


def find_cell(manifest: dict, workload: str, root: str = ROOT) -> Cell:
    """The cell of that name with its files read; KeyError if absent."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    w = by_name[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    e2e = [m for m in manifest["end_to_end"] if _reports(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _reports(m, workload)
                 and m["moves"] in e2e_names]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(root, "portbench", "traffic",
                                   w["traffic"] + ".json")),
        end_to_end=e2e, per_layer=per_layer,
        limits=_json(os.path.join(root, "portbench", "limits",
                                  workload + ".json")))


def runner(cell: Cell):
    """The module that runs the cell's traffic."""
    return importlib.import_module(
        "portbench.runners." + cell.traffic["runner"])


def metric_reader(name: str, root: str = ROOT):
    """`read(ctx)` of portbench/metrics/<name>.py."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(manifest: dict) -> list[str]:
    """What in the manifest breaks the naming and reference rules (empty
    when none)."""
    out = []
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[group]:
            n = e["name"]
            if not NAME.match(n):
                out.append(f"{group}: bad name {n!r}")
            if (group, n) in names:
                out.append(f"{group}: {n} twice")
            names.add((group, n))
            if "unit" in e and not UNIT.match(e["unit"]):
                out.append(f"{n}: bad unit {e['unit']!r}")
            if "source" in e and group in ("end_to_end", "per_layer") \
                    and e["source"] not in SOURCES:
                out.append(f"{n}: bad source {e['source']!r}")
            for k in e.get("reduced", ()):
                if not NAME.match(k):
                    out.append(f"{n}: bad reduced key {k!r}")
    e2e = {m["name"] for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    confs = {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        if w["config"] not in confs:
            out.append(f"{w['name']}: unknown config {w['config']}")
        for k in ("config", "traffic"):
            if not NAME.match(w[k]):
                out.append(f"{w['name']}: bad {k} {w[k]!r}")
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown {m['moves']}")
        for c in m.get("workloads", ()):
            if c not in cells:
                out.append(f"{m['name']}: unknown cell {c}")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    return out
