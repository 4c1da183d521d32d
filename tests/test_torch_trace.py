"""The port's tracer (unscene3d_torch/utils/trace.py) on the CPU: what a
train step of the tiny model records, the auction's counters against hand
counts, the spans as idle-gap labels through the benchmark's reducer, and
the benchmark's readers of the tracer (portbench/program.py)."""

import math
import sys
import threading

import pytest
import torch

import unscene3d_torch.utils
from portbench import program
from portbench.trace import reduce_intervals
from unscene3d_torch.data.collate import FreeMaskCollator
from unscene3d_torch.data.synthetic import make_batch
from unscene3d_torch.losses.matcher import solve_lsap_auction
from unscene3d_torch.train.loop import build_trainer
from unscene3d_torch.utils import trace

TINY = dict(num_classes=3, hidden_dim=32, num_queries=10, num_heads=2,
            dim_feedforward=64, num_decoders=1, hlevels=(0, 1, 2, 3),
            sample_sizes=(4096,) * 5)
# each span of a train step and the span it opens under
PARENTS = {"step": None, "mask3d.backbone": "step", "mask3d.decoder": "step",
           "step.criterion": "step", "criterion.matcher": "step.criterion",
           "step.backward": "step", "step.bn_stats": "step",
           "step.adamw": "step"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def step_records():
    """Records and counters of the tiny model's second train step (the
    first runs untraced), and what was recorded by the first."""
    batch, _ = FreeMaskCollator(voxel_size=0.12, fps_queries=10)(
        make_batch(2, num_points=1500))
    trainer = build_trainer(torch.float32, seed=0, backbone="Res16UNet14A",
                            solver="auction", device="cpu", **TINY)
    gen = torch.Generator().manual_seed(0)
    trace.reset()
    trainer.train_step(batch, gen)
    untraced = trace.summary()
    with trace.recording():
        trainer.train_step(batch, gen)
    out = dict(untraced=untraced, records=trace.records(),
               summary=trace.summary())
    trace.reset()
    return out


def test_nothing_is_recorded_outside_recording(step_records):
    assert step_records["untraced"] == {"spans": {}, "counters": {}}
    assert trace.span("step") is trace.span("step.adamw")


def test_a_step_records_each_span_once_under_its_parent(step_records):
    recs = step_records["records"]
    assert sorted(r.name for r in recs) == sorted(PARENTS)
    assert {r.name: r.parent for r in recs} == PARENTS
    # the step span carries Trainer.step before the update, its children too
    assert {r.step for r in recs} == {1}
    for r in recs:
        assert r.end_ns >= r.start_ns and r.device_ms() is None
    s = step_records["summary"]["spans"]
    assert all(s[n]["n"] == 1 and s[n]["device_ms"] == [] for n in PARENTS)


def test_a_step_counts_rounds_and_convergence_reads(step_records):
    c = step_records["summary"]["counters"]
    assert set(c) == {"auction_rounds", "auction_capped",
                      "host_syncs.matcher_converged",
                      "host_syncs.matcher_neg_inf",
                      "host_syncs.criterion_eos_weight"}
    # one auction a step: a read every 8 rounds, the last one converged
    assert c["auction_rounds"] % 8 == 0 and c["auction_capped"] == 0
    assert c["host_syncs.matcher_converged"] == c["auction_rounds"] // 8 + 1
    assert c["host_syncs.matcher_neg_inf"] == 1
    assert c["host_syncs.criterion_eos_weight"] == 1


@pytest.mark.parametrize("n,valid,rounds,reads,capped", [
    # nothing to assign: converged at the first read
    (4, False, 0, 1, 0),
    # equal costs: round k gives query k to target k, so n rounds, run on
    # to the next multiple of 8, where the read finds them all assigned
    (3, True, 8, 2, 0),
    (10, True, 16, 3, 0),
    (17, True, 24, 4, 0),
])
def test_auction_rounds_equal_the_hand_count(n, valid, rounds, reads, capped):
    cost = torch.zeros(1, n, n)
    v = torch.full((1, n), valid)
    with trace.recording():
        out = solve_lsap_auction(cost, v)
    if valid:
        assert sorted(out[0].tolist()) == list(range(n))
    assert trace.summary()["counters"] == {
        "auction_rounds": rounds, "auction_capped": capped,
        "host_syncs.matcher_converged": reads,
        "host_syncs.matcher_neg_inf": 1}


def test_an_auction_that_cannot_converge_counts_the_cap():
    """Two targets over one query bid against each other until the cap
    (3,000 rounds); the greedy pass gives what is left."""
    with trace.recording():
        solve_lsap_auction(torch.zeros(1, 1, 2))
    assert trace.summary()["counters"] == {
        "auction_rounds": 3000, "auction_capped": 1,
        "host_syncs.matcher_converged": math.ceil(3000 / 8),
        "host_syncs.matcher_neg_inf": 1}


def test_spans_label_idle_gaps_through_the_benchmark_reducer(step_records,
                                                           monkeypatch):
    """A 1 ns gap in synthetic device work at each span's start is labelled
    by that span, one after the step's end by "between steps"."""
    recs = step_records["records"]
    monkeypatch.setattr(trace, "records", lambda: recs)
    marks = program.marks()
    assert marks == sorted(marks)
    end = max(r.end_ns for r in recs)
    t0, t1 = min(r.start_ns for r in recs) - 100, end + 100
    gaps = sorted([r.start_ns for r in recs] + [end + 10])
    iv, at = [], t0
    for g in gaps:
        iv.append((at, g, "kernel"))
        at = g + 1
    iv.append((at, t1, "kernel"))
    out = reduce_intervals(iv, t0, t1, marks)
    want = {n: 1e-9 for n in PARENTS}
    want["between steps"] = 1e-9
    assert out["gaps"] == pytest.approx(want)
    assert out["busy_s"] == pytest.approx((t1 - t0 - len(gaps)) / 1e9)


def test_program_readers_read_nothing_before_a_record():
    assert program.summary() is None and program.marks() is None
    assert program.span_ms("step") is None
    assert program.per_step("host_syncs") is None


def test_program_readers_return_none_without_the_tracer(monkeypatch,
                                                       tmp_path):
    """A program from before the tracer: its `unscene3d_torch.utils` has
    no `trace` module."""
    monkeypatch.setattr(unscene3d_torch.utils, "__path__", [str(tmp_path)])
    monkeypatch.delattr(unscene3d_torch.utils, "trace")
    monkeypatch.delitem(sys.modules, "unscene3d_torch.utils.trace")
    assert program.summary() is None and program.marks() is None
    assert program.span_ms("mask3d.decoder") is None
    assert program.per_step("auction_rounds") is None


def test_program_readers_take_per_step_means(monkeypatch):
    s = {"spans": {"step": {"n": 4, "host_ms": [1.0] * 4,
                            "device_ms": [9.0] * 4},
                   "step.adamw": {"n": 4, "host_ms": [0.1] * 4,
                                  "device_ms": [1.0, 2.0, 3.0, 6.0]}},
         "counters": {"auction_rounds": 40, "host_syncs.a": 10,
                      "host_syncs.b": 2, "host_syncs_other": 100}}
    monkeypatch.setattr(trace, "summary", lambda: s)
    assert program.span_ms("step.adamw") == 3.0
    assert program.span_ms("step.backward") is None
    assert program.per_step("auction_rounds") == 10.0
    assert program.per_step("host_syncs") == 3.0


def test_a_profiler_session_turns_the_tracer_on():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("inside"):
            trace.count("n", 2)
    with trace.span("after"):
        trace.count("n", 5)
    s = trace.summary()
    assert list(s["spans"]) == ["inside"] and s["counters"] == {"n": 2}


def test_threads_keep_their_own_parents_and_every_count():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors = []

    def work(i):
        try:
            for _ in range(200):
                with trace.span(f"outer{i}", step=i):
                    with trace.span(f"inner{i}"):
                        trace.count("hits")
        except Exception as e:  # noqa: BLE001 - reported by the assert
            errors.append(e)

    try:
        with trace.recording():
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads)
    assert trace.summary()["counters"] == {"hits": 16 * 200}
    recs = trace.records()
    assert len(recs) == 16 * 200 * 2
    for r in recs:
        i = int(r.name.removeprefix("outer").removeprefix("inner"))
        assert r.step == i
        assert r.parent == (None if r.name.startswith("outer")
                            else f"outer{i}")
