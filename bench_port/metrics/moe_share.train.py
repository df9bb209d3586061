"""The MoE layers' forward passes' share of the busy device time, not the
layers' whole cost: busy device time under the program's ``moe`` spans (a
'moe' block's router, dispatch, held experts, combine and shared expert,
in each forward pass: the first and remat's rerun) over the busy device
time of the traced window (train cells).  Autograd's backward of the
layer runs outside the span and is not counted, so the layers' share of
the step is larger than this reads."""
from bench_port import program_trace


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or t.busy_s <= 0:
        return None
    under = program_trace.busy_under_s(t, "moe")
    return 100.0 * under / t.busy_s if under > 0 else None
