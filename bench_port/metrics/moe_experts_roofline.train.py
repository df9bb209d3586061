"""The held experts' least time over the device time under the program's
``moe.experts`` spans in the traced steps (forward passes: the first and
remat's rerun): 4·D·F operations a routed pair (``moe.routed_pairs``,
counted in the same passes) at the bf16 peak, or the held experts'
weights read once a call, whichever is larger (flops_hybrid.experts_work).
"""
from bench_port import flops, flops_hybrid, program_trace


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    got = program_trace.drained(run)
    spans = [r for r in got[0] if r.name == "moe.experts"] if got else []
    pairs = program_trace.counter(run, "moe.routed_pairs")
    device_s = program_trace.busy_under_s(t, "moe.experts")
    if not spans or not pairs or device_s <= 0:
        return None
    ops, nbytes = flops_hybrid.experts_work(run.cell.config, pairs,
                                            len(spans))
    return 100.0 * flops.least_s(nbytes, ops, run.part, "bf16") / device_s
