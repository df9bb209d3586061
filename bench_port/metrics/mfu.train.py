"""Model FLOPs of the measured window over its time times the published
peak for the cell's precision (train cells; see flops.py for the count)."""
from bench_port import flops


def read(run):
    if run.kind != "train" or not run.window_s or not run.model_flops:
        return None
    peak = flops.PEAK_FLOPS[run.part][run.peak_precision]
    return 100.0 * run.model_flops / (run.window_s * peak)
