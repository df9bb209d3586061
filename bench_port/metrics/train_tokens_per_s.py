"""Tokens of the steps completed in the window over the window's time."""


def read(run):
    if run.kind != "train" or not run.window_s:
        return None
    return run.tokens / run.window_s
