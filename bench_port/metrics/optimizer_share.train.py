"""Busy device time under the program's ``train.optimizer`` spans (the
optimizer and the apply of each train step) over the
busy device time of the traced window (train cells)."""
from bench_port import program_trace


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or t.busy_s <= 0:
        return None
    under = program_trace.busy_under_s(t, "train.optimizer")
    return 100.0 * under / t.busy_s if under > 0 else None
