"""Host ms a traced round in the program's ``fl.stage`` spans: the
executor's inputs built on the host and uploaded, a group at a time."""
from bench_port import program_trace


def read(run):
    if run.kind != "fl":
        return None
    return program_trace.host_ms_per_round(run, "fl.stage")
