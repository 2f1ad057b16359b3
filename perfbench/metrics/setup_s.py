"""Set-up time: from the process's start to the window's, loading,
drawing the weights, building (and, in a run that builds, compiling)
and warming; host clock."""


def read(run):
    return run.setup_s
