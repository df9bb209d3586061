"""fed_agg's least time over its device time, in the traced rounds: each
call's bytes are (K + 1)·P·itemsize with K the rows it merged."""
from bench_port import flops


def read(run):
    t = run.trace
    calls = [] if t is None else t.calls.get("fed_agg", [])
    device_s = 0.0 if t is None else t.kernel_s("fed_agg_kernel")
    if not calls or device_s <= 0:
        return None
    least = sum(flops.least_s(flops.fed_agg_bytes(k, p, size),
                              flops.fed_agg_flops(k, p), run.part, "fp32")
                for k, p, size in calls)
    return 100.0 * least / device_s
