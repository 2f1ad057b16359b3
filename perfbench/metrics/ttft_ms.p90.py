"""The 90th percentile, over every request of the window, of the time
from when the request was due to its first token on the host, in ms;
host clock."""
import statistics


def read(run):
    if len(run.ttft_s) < 2:
        return None
    return statistics.quantiles(run.ttft_s, n=10, method="inclusive")[8] * 1e3
