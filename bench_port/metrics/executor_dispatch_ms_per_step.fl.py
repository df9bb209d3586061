"""Host ms to enqueue one executor step: the program's dispatch-time
counter (each group's launch latency) over the group's local steps."""


def read(run):
    if run.kind != "fl" or not run.dispatch_s or not run.group_steps:
        return None
    n = len(run.dispatch_s)
    return 1e3 * sum(run.dispatch_s) / sum(run.group_steps[:n])
