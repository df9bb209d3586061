"""The routing's skew over the held experts in the traced steps: the
largest held expert's rows (``moe.max_expert_rows``, summed over the
layer calls) over a held expert's mean rows (``moe.routed_pairs`` over
the held experts).  1 is even; the largest expert paces a grouped
product."""
from bench_port import program_trace


def read(run):
    if run.kind != "train":
        return None
    pairs = program_trace.counter(run, "moe.routed_pairs")
    top = program_trace.counter(run, "moe.max_expert_rows")
    if not pairs or not top:
        return None
    return top / (pairs / run.cell.config["n_routed_experts"])
