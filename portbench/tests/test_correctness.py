"""The reference against the port's plain twins (the port on the CPU runs
its kernels' plain twins), and whole runs of a train cell with the timed
path broken underneath, which must come out not correct. All on the CPU,
at tiny sizes."""

import dataclasses

import pytest
import torch

from portbench import manifest, run
from portbench.runners import train_step


def _tiny(workload="train.mask3d.b8", **traffic):
    cell = manifest.find_cell(manifest.load_manifest(), workload)
    tr = dict(cell.traffic, batch_size=2, batches=2, reference_steps=2,
              scene=dict(num_points=4000, num_objects=3, extent=2.5))
    tr.update(traffic)
    return dataclasses.replace(cell, traffic=tr)


def test_reference_follows_the_port_on_a_28k_voxel_scene():
    """One f32 step of the port (plain twins on the CPU) and of the
    reference from the same weights on chip_smoke's parity-sized scene."""
    cell = _tiny(batch_size=1, batches=1, reference_steps=1,
                 scene=dict(num_points=30_000, num_objects=6, extent=4.0))
    r = train_step.setup(cell, 7, "cpu")
    voxels = int(r.host[0].graph.levels[0].valid.sum())
    assert 26_000 < voxels < 30_000
    r.release()
    got = r.check()
    assert got["loss_gap"] < 1e-6
    assert got["grad_gap"] < 1e-5
    assert got["change_gap"] < 1e-5


def test_reference_collate_equals_the_ports_tables():
    """The reference's own collate (its torch neighbour search and FPS)
    gives the port collator's tables bit for bit."""
    import numpy as np
    from unscene3d_torch.data.collate import FreeMaskCollator

    from portbench.reference.collate import collate

    scenes = train_step.make_scenes(
        dict(batch_size=3, batches=1,
             scene=dict(num_points=20_000, num_objects=5, extent=4.0)), 3)[0]
    port, _ = FreeMaskCollator(voxel_size=0.02, fps_queries=100)(scenes)
    ref = collate(scenes, 0.02, 100)
    for lp, lr in zip(port.graph.levels, ref.levels):
        for f in ("coords", "valid", "nbr_idx", "child_idx", "parent_idx",
                  "parent_offset", "up_idx"):
            a, b = getattr(lp, f), getattr(lr, f)
            assert (a is None) == (b is None), f
            assert a is None or torch.equal(a, b), f
    for f in ("features", "raw_coords", "point2segment", "seg_valid",
              "level_bounds", "seg_counts", "fps_idx"):
        assert torch.equal(getattr(port, f), getattr(ref, f)), f
    for a, b in zip(port.scene_idx + port.scene_valid,
                    ref.scene_idx + ref.scene_valid):
        assert torch.equal(a, b)
    t = port.target
    assert torch.equal(t.labels, ref.labels)
    assert torch.equal(t.valid, ref.t_valid)
    assert torch.equal(t.seg_masks, ref.seg_masks)
    assert np.array_equal(ref.fps_idx[:, 0].numpy(), np.zeros(3))


def _run(cell, seed=2**31 + 11):
    out = run.run_cell(cell, seed, 0.0, False, "cpu", 0.0,
                       log=lambda *a, **k: None)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    return out


def test_sound_run_is_correct():
    out = _run(_tiny())
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0


def _no_update(self, params, grads):
    self.count += 1


def _half_batch(collate):
    def f(self, scenes):
        return collate(self, scenes[:len(scenes) // 2])
    return f


def _loss_altered(call):
    def f(self, outputs, batch):
        out = call(self, outputs, batch)
        return dict(out, total=out["total"] * 1.01)
    return f


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "loss_altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    from unscene3d_torch.data.collate import FreeMaskCollator
    from unscene3d_torch.losses.criterion import SetCriterion
    from unscene3d_torch.train.loop import AdamW

    if fault == "state_unchanged":
        monkeypatch.setattr(AdamW, "step", _no_update)
    elif fault == "half_batch":
        monkeypatch.setattr(FreeMaskCollator, "collate",
                            _half_batch(FreeMaskCollator.collate))
    else:
        monkeypatch.setattr(SetCriterion, "__call__",
                            _loss_altered(SetCriterion.__call__))
    out = _run(_tiny())
    assert not out["correct"], out["checks"]


def test_the_reference_imports_nothing_of_the_program():
    import ast
    import pathlib

    ref = pathlib.Path(manifest.HERE) / "reference"
    for path in ref.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "math",
                                           "dataclasses", "itertools",
                                           "__future__", "portbench"), \
                    (path.name, n)
                if n.startswith("portbench"):
                    assert n.startswith("portbench.reference"), n


@pytest.mark.cuda
def test_control_fails_and_program_passes_on_the_card(card):
    """The control (the reference with TF32 products) and the half-batch
    fault at a small size on the card: the program's numbers within the
    cell's limits, the control's and the fault's outside one of them."""
    from portbench import control

    cell = _tiny(batch_size=2, batches=3, reference_steps=3,
                 scene=dict(num_points=40_000, num_objects=8, extent=4.0))
    got = control.readings(cell, 2**31 + 5, device=card)
    lim = cell.limits
    assert all(got["program"][k] <= v for k, v in lim.items())
    assert any(got["control"][k] > v for k, v in lim.items())
    assert any(got["half"][k] > v for k, v in lim.items())
