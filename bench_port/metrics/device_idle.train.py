"""The traced window's share with no operation on the device: one less
the union of the device operations' intervals over the window (train)."""


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
