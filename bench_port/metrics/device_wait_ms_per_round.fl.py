"""Host ms a traced round in the program's ``fl.device_wait`` span: the
merge waiting for the card before it uploads anything."""
from bench_port import program_trace


def read(run):
    if run.kind != "fl":
        return None
    return program_trace.host_ms_per_round(run, "fl.device_wait")
