"""Prompt tokens of the requests completed in the window over the
window's time; host clock."""


def read(run):
    if not run.lengths:
        return None
    return sum(run.lengths) / run.window_s
