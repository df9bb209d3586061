"""Busy device time under the program's ``fl.optimizer`` spans (the
proximal term, the optimizer and the apply of each executor step) over the
busy device time of the traced window (fl cells)."""
from bench_port import program_trace


def read(run):
    t = run.trace
    if run.kind != "fl" or t is None or t.busy_s <= 0:
        return None
    under = program_trace.busy_under_s(t, "fl.optimizer")
    return 100.0 * under / t.busy_s if under > 0 else None
