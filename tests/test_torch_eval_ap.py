"""The port's AP evaluation against the JAX package's: `evaluate_instances`
on random fixtures and on tests/test_ap_reference_oracle.py's fixtures
(equal dicts, and equal to that file's control-flow-faithful oracle of the
reference's evaluator), `boxes_from_masks` / `eval_det`, and the
ScanNet-benchmark export files byte for byte."""

import filecmp
import os

import numpy as np
import pytest

from tests.test_ap_reference_oracle import _random_case, oracle_evaluate
from unscene3d_tpu.eval import benchmark_export as jax_export
from unscene3d_tpu.eval import box_eval as jax_box
from unscene3d_tpu.eval.instance_eval import \
    evaluate_instances as jax_evaluate
from unscene3d_torch.eval import benchmark_export, box_eval
from unscene3d_torch.eval.instance_eval import evaluate_instances


def _equal_results(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _equal_results(got[k], v)
        else:
            np.testing.assert_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("min_region", [100, 10])
def test_evaluate_instances_equal_jax_random(seed, min_region):
    preds, gts = _random_case(seed)
    got = evaluate_instances(preds, gts, min_region_size=min_region)
    _equal_results(got, jax_evaluate(preds, gts, min_region_size=min_region))
    want = oracle_evaluate(preds, gts, min_region_size=min_region)
    for key in ("all_ap", "all_ap_50%", "all_ap_25%"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-9)


def test_evaluate_instances_equal_jax_multiclass():
    preds, gts = _random_case(11, classes=(3, 5), k_gt=4)
    kw = dict(valid_class_ids=(3, 5), class_labels=("a", "b"),
              min_region_size=100)
    _equal_results(evaluate_instances(preds, gts, **kw),
                   jax_evaluate(preds, gts, **kw))


def _directed_fixtures():
    p = 1000
    gt = np.zeros(p, np.int64)
    gt[:300] = 1000 + 1
    gt[700:] = 999 * 1000
    masks = np.zeros((p, 3), bool)
    masks[:300, 0] = True
    masks[700:950, 1] = True
    masks[550:800, 2] = True
    void = ({"s": dict(masks=masks, classes=np.ones(3, np.int64),
                       scores=np.array([0.9, 0.8, 0.7]))}, {"s": gt})
    gt2 = np.zeros(p, np.int64)
    gt2[:400] = 1000 + 1
    m2 = np.zeros((p, 2), bool)
    m2[:400, 0] = True
    m2[500:550, 1] = True
    small = ({"s": dict(masks=m2, classes=np.ones(2, np.int64),
                        scores=np.array([0.9, 0.95]))}, {"s": gt2})
    empty = ({"s": dict(masks=np.zeros((p, 0), bool),
                        classes=np.zeros(0, np.int64),
                        scores=np.zeros(0))}, {"s": gt2})
    return {"void": void, "small": small, "no_predictions": empty}


@pytest.mark.parametrize("name", ["void", "small", "no_predictions"])
def test_evaluate_instances_equal_jax_directed(name):
    preds, gts = _directed_fixtures()[name]
    got = evaluate_instances(preds, gts, min_region_size=100)
    _equal_results(got, jax_evaluate(preds, gts, min_region_size=100))
    want = oracle_evaluate(preds, gts, min_region_size=100)
    for key in ("all_ap", "all_ap_50%", "all_ap_25%"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_boxes_and_eval_det_equal_jax(seed):
    r = np.random.RandomState(seed)
    preds, gts = {}, {}
    for s in range(3):
        coords = r.rand(2000, 3) * 5
        masks = r.rand(2000, 6) > 0.9
        classes = r.randint(1, 3, 6)
        scores = r.rand(6)
        got = box_eval.boxes_from_masks(coords, masks, classes, scores)
        want = jax_box.boxes_from_masks(coords, masks, classes, scores)
        assert len(got) == len(want)
        for (c1, b1, s1), (c2, b2, s2) in zip(got, want):
            assert c1 == c2 and s1 == s2
            np.testing.assert_array_equal(b1, b2)
        gt_masks = r.rand(2000, 4) > 0.85
        preds[f"s{s}"] = got
        gts[f"s{s}"] = box_eval.boxes_from_masks(coords, gt_masks,
                                                 np.ones(4, np.int64))
    for th in (0.25, 0.5):
        assert (box_eval.eval_det(preds, gts, ovthresh=th)
                == jax_box.eval_det(preds, gts, ovthresh=th))


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_export_predictions_byte_equal(tmp_path, threshold):
    r = np.random.RandomState(0)
    masks = r.rand(300, 5) > 0.7
    classes = np.ones(5, np.int64)
    scores = r.rand(5)
    for mod, d in ((benchmark_export, "port"), (jax_export, "jax")):
        mod.export_predictions(str(tmp_path / d), "scene0000_00", masks,
                               classes, scores, score_threshold=threshold)
    cmp = filecmp.dircmp(tmp_path / "port", tmp_path / "jax")
    assert not cmp.left_only and not cmp.right_only
    files = ["scene0000_00.txt"] + [
        os.path.join("pred_mask", f) for f in
        sorted(os.listdir(tmp_path / "jax" / "pred_mask"))]
    for f in files:
        assert filecmp.cmp(tmp_path / "port" / f, tmp_path / "jax" / f,
                           shallow=False), f
