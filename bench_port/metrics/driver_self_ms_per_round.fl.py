"""Host ms a traced round in the driver's own work: the program's
``fl.round`` span less its child spans (the executor's ``fl.stage`` and
``fl.steps``, the strategy's ``fl.aggregate``), over the traced rounds."""
from bench_port import program_trace


def read(run):
    if run.kind != "fl":
        return None
    return program_trace.self_ms_per_round(run)
