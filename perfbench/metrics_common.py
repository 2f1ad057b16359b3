"""Arithmetic the metric readers share."""


def roofline_share(run, match, bound_s):
    """The least time ``bound_s`` of the work the kernels ``match``
    accepts did in the traced window, over their device time in the
    trace, in %; None where the trace holds no such kernel."""
    if run.trace is None or not run.trace.count(match):
        return None
    return 100.0 * bound_s / run.trace.op_seconds(match)


def idle_share(run):
    """The share of the traced window in which no operation ran on the
    device (averaged over the ranks), in %."""
    if run.trace is None:
        return None
    busy = run.busy_s if run.busy_s is not None else run.trace.busy_s()
    if not busy:
        return None
    return 100.0 * (1.0 - busy / run.trace.window_s)
