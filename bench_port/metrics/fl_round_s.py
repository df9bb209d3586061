"""Wall seconds a round: the window over the whole rounds it ran."""


def read(run):
    if run.kind != "fl" or not run.units:
        return None
    return run.window_s / run.units
