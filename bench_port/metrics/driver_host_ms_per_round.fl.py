"""Host ms a round in the driver: the host time of the window's
run_round calls less the executor's dispatch (its dispatch-time counter)
and the strategy's aggregate (the harness's span), over the window's
rounds (the traced rounds after it are not counted)."""


def read(run):
    if run.kind != "fl" or not run.units or not run.dispatch_s:
        return None
    spans = run.window_span_s
    own = (spans.get("round", 0.0) - sum(run.dispatch_s)
           - spans.get("aggregate", 0.0))
    return 1e3 * own / run.units
