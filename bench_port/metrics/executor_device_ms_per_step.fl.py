"""Device ms an executor step: the busy device time under the program's
``fl.steps`` spans over its ``fl.local_steps`` counter, in the traced
rounds."""
from bench_port import program_trace


def read(run):
    t = run.trace
    if run.kind != "fl" or t is None:
        return None
    steps = program_trace.counter(run, "fl.local_steps")
    under = program_trace.busy_under_s(t, "fl.steps")
    return 1e3 * under / steps if steps and under > 0 else None
