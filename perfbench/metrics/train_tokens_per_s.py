"""Tokens trained in the window (summed over the ranks) over the
window's time, the device waited for at its end; host clock."""


def read(run):
    if not run.steps:
        return None
    return run.tokens / run.window_s
