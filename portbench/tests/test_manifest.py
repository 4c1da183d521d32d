"""BENCHMARK.json: names and units, and every file a cell needs found by
name; a new cell or metric is new files and entries only."""

import json
import os
import shutil

import pytest

from portbench import manifest


@pytest.fixture(scope="module")
def bench():
    return manifest.load_manifest()


def test_names_units_and_sources_allowed(bench):
    assert manifest.problems(bench) == []
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("workload", ["train.mask3d.b8",
                                      "train.mask3d.b8-small"])
def test_cell_files_found_by_name(bench, workload):
    cell = manifest.find_cell(bench, workload)
    assert manifest.runner(cell).setup is not None
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(manifest.metric_reader(m["name"]))
    assert cell.limits and all(v > 0 for v in cell.limits.values())


def test_a_new_cell_and_metric_are_files_and_entries_only(tmp_path, bench):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell,
    its limits and a per-layer metric by adding files and entries: no file
    that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "portbench")
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in (root / "portbench").rglob("*"))
              if os.path.isfile(p)}
    b = json.loads(json.dumps(bench))
    conf = dict(b["configs"][0], name="dummy-config",
                file="portbench/configs/dummy-config.json")
    b["configs"].append(conf)
    b["workloads"].append({"name": "dummy.cell", "config": "dummy-config",
                           "traffic": "dummy_mix", "chips": 1,
                           "why": "a test cell"})
    b["end_to_end"].append({"name": "dummy_scenes_per_s", "unit": "scenes/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["dummy.cell"]})
    b["per_layer"].append({"name": "dummy_ms.train", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "loss", "moves": "dummy_scenes_per_s",
                           "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    shutil.copy(root / "portbench/configs/mask3d-r16unet34c.json",
                root / "portbench/configs/dummy-config.json")
    mix = json.loads((root / "portbench/traffic/train_b8.json").read_text())
    mix["scene"]["num_points"] = 1000
    mix["rate_metric"] = "dummy_scenes_per_s"
    (root / "portbench/traffic/dummy_mix.json").write_text(json.dumps(mix))
    (root / "portbench/limits/dummy.cell.json").write_text(
        '{"loss_gap": 1e-4}')
    (root / "portbench/metrics/dummy_ms.train.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    got = manifest.load_manifest(str(root))
    assert manifest.problems(got) == []
    cell = manifest.find_cell(got, "dummy.cell", root=str(root))
    assert cell.traffic["scene"]["num_points"] == 1000
    assert [m["name"] for m in cell.end_to_end] == [
        "peak_mem_gib", "setup_s", "dummy_scenes_per_s"]
    assert [m["name"] for m in cell.per_layer] == ["dummy_ms.train"]
    assert manifest.metric_reader("dummy_ms.train", str(root))({}) == 1.5
    # the other cells do not report the new metric
    old = manifest.find_cell(got, "train.mask3d.b8", root=str(root))
    assert "dummy_ms.train" not in [m["name"] for m in old.per_layer]
    for p, data in before.items():
        assert open(p, "rb").read() == data, p
