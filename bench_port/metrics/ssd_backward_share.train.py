"""Device time under the program's ssd_scan_plain_backward spans over the
busy device time of the traced window (train cells)."""


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or t.busy_s <= 0:
        return None
    under = t.under_span_s("ssd_scan_plain_backward")
    return 100.0 * under / t.busy_s if under > 0 else None
