"""The share of the traced window in which no operation ran on the
device (averaged over the cell's cards), from the device trace, in %."""
from perfbench.metrics_common import idle_share


def read(run):
    return idle_share(run)
