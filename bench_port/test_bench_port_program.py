"""The readers of the program's own spans and counters
(``program_trace.py`` and the metrics that use it) on hand-made events
and records: program spans never count as device work, a gap takes the
innermost span's name, and each reader finds nothing without its spans.

    python3 -m pytest -q bench_port
"""
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench_port import harness, program_trace  # noqa: E402
from bench_port import trace as tr  # noqa: E402
from repro_torch import tracing  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
MS = 1e3                      # event times are in microseconds
NEW = ("driver_self_ms_per_round.fl", "executor_stage_ms_per_round.fl",
       "executor_device_ms_per_step.fl", "device_wait_ms_per_round.fl",
       "optimizer_share.fl", "optimizer_share.train")


def _event(name, start_ms, end_ms, device=CPU, annotation=False):
    return SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=SimpleNamespace(start=start_ms * MS, end=end_ms * MS))


def _events(program: bool, flagged: bool = True):
    """A window of 100 ms: kernels at 10–40 and 60–70 ms, a harness
    span over 0–100 ms; with ``program``, the program's fl.steps span
    over 5–50 ms and fl.optimizer over 30–45 ms, on the host and on the
    device (the device annotation flagged as one when ``flagged``)."""
    out = [_event(tr.WINDOW_SPAN, 0, 100),
           _event("bench.round", 0, 100),
           _event("kernel_a", 10, 40, CUDA), _event("kernel_b", 60, 70, CUDA)]
    if program:
        out += [_event("fl.steps", 5, 50), _event("fl.optimizer", 30, 45),
                _event("fl.steps", 10, 40, CUDA, flagged),
                _event("fl.optimizer", 30, 40, CUDA, flagged)]
    return out


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


@pytest.mark.parametrize("flagged", [True, False])
def test_program_spans_are_not_device_work(flagged):
    plain = tr.reduce(_Prof(_events(False)))
    spanned = program_trace.reduce(_Prof(_events(True, flagged)),
                                   tracing.SPANS)
    assert spanned.busy_s == pytest.approx(plain.busy_s) == \
        pytest.approx(0.040)
    assert spanned.top_ops() == plain.top_ops()
    assert spanned.under_span_s("fl.steps") == pytest.approx(0.030)
    if flagged:      # the harness's own reduce files flagged ones alike
        assert tr.reduce(_Prof(_events(True))).top_ops() == plain.top_ops()


def test_a_gap_takes_the_innermost_program_span():
    t = program_trace.reduce(_Prof(_events(True)), tracing.SPANS)
    gaps = dict(t.idle_gaps())
    # idle 0–10 (the harness's round: fl.steps opens at 5), 40–60 (in
    # fl.optimizer, the innermost open at 40), 70–100 (the round)
    assert gaps == pytest.approx({"bench.round": 0.040,
                                  "fl.optimizer": 0.020})
    assert dict(tr.reduce(_Prof(_events(True))).idle_gaps()) == \
        pytest.approx({"bench.round": 0.060})


def _record(name, parent, rnd, start_ms, end_ms):
    return tracing.SpanRecord(name, parent, int(start_ms * 1e6),
                              int(end_ms * 1e6), {"round": rnd})


def _fl_records():
    """Two rounds of 100 and 120 ms: stage 10, steps 50 and an aggregate
    of 20 holding a device wait of 15 (round 0); stage 12, steps 60 and
    an aggregate of 18 holding a wait of 16 (round 1)."""
    out = []
    for rnd, t0, (stage, steps, agg, wait, total) in (
            (0, 0, (10, 50, 20, 15, 100)), (1, 200, (12, 60, 18, 16, 120))):
        out += [_record("fl.stage", "fl.round", rnd, t0 + 1, t0 + 1 + stage),
                _record("fl.optimizer", "fl.steps", rnd, t0 + 20, t0 + 21),
                _record("fl.steps", "fl.round", rnd, t0 + 15,
                        t0 + 15 + steps),
                _record("fl.device_wait", "fl.aggregate", rnd, t0 + 80,
                        t0 + 80 + wait),
                _record("fl.aggregate", "fl.round", rnd, t0 + 79,
                        t0 + 79 + agg),
                _record("fl.round", None, rnd, t0, t0 + total)]
    return out, {"fl.local_steps": 210}


def _run(kind, trace=None):
    cell = SimpleNamespace(name="hand-made")
    return harness.RunRecord(cell, kind, trace=trace)


def _read(name, run):
    return harness.reader(name)(run)


def test_readers_find_nothing_without_their_spans(monkeypatch):
    monkeypatch.setattr(tracing, "drain", lambda: ([], {}))
    plain = tr.reduce(_Prof(_events(False)))
    for kind in ("fl", "train"):
        for trace in (None, plain):
            run = _run(kind, trace)
            for name in NEW:
                assert _read(name, run) is None, (name, kind)


def test_readers_without_the_tracing_module(monkeypatch):
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(repro_torch, "tracing")
    run = _run("fl", tr.reduce(_Prof(_events(True))))
    for name in ("driver_self_ms_per_round.fl",
                 "executor_stage_ms_per_round.fl",
                 "executor_device_ms_per_step.fl",
                 "device_wait_ms_per_round.fl"):
        assert _read(name, run) is None, name


def test_readers_on_hand_made_records(monkeypatch):
    records, counts = _fl_records()
    drains = []

    def drain():
        drains.append(1)
        return list(records), dict(counts)
    monkeypatch.setattr(tracing, "drain", drain)
    t = program_trace.reduce(_Prof(_events(True)), tracing.SPANS)
    run = _run("fl", t)
    # driver: (100 − 10 − 50 − 20) and (120 − 12 − 60 − 18), a round
    assert _read("driver_self_ms_per_round.fl", run) == pytest.approx(25.0)
    assert _read("executor_stage_ms_per_round.fl", run) == \
        pytest.approx(11.0)
    assert _read("device_wait_ms_per_round.fl", run) == pytest.approx(15.5)
    # 30 ms of kernels under fl.steps over 210 steps
    assert _read("executor_device_ms_per_step.fl", run) == \
        pytest.approx(30.0 / 210)
    # no kernel starts inside fl.optimizer's device range (30–40 ms)
    assert _read("optimizer_share.fl", run) is None
    assert drains == [1]                  # drained once for the run
    assert _read("optimizer_share.train", run) is None


def test_optimizer_shares():
    ops = [("k_grad", 0.0, 0.030), ("k_adam", 0.030, 0.040)]
    for kind, span in (("fl", "fl.optimizer"), ("train", "train.optimizer")):
        t = tr.DeviceTrace((0.0, 0.050), list(ops), {span: [(0.030, 0.041)]},
                           [])
        got = _read(f"optimizer_share.{kind}", _run(kind, t))
        assert got == pytest.approx(100.0 * 0.010 / 0.040)
        other = "train" if kind == "fl" else "fl"
        assert _read(f"optimizer_share.{other}", _run(other, t)) is None


def test_busy_under_a_span_counts_overlapping_operations_once():
    # two operations of 10 ms overlapping by 5 ms start under fl.steps,
    # one after its range does not
    ops = [("a", 0.000, 0.010), ("b", 0.005, 0.015), ("c", 0.030, 0.040)]
    t = tr.DeviceTrace((0.0, 0.050), ops, {"fl.steps": [(0.0, 0.020)]}, [])
    assert t.under_span_s("fl.steps") == pytest.approx(0.020)
    assert program_trace.busy_under_s(t, "fl.steps") == pytest.approx(0.015)
    assert program_trace.busy_under_s(t, "fl.optimizer") == 0.0
