"""The selective-scan kernel (``csrc/mamba_scan.cu``) in the prefill:
the scan's bound (``roofline.counts.scan_bound_s``) of every mamba
layer of every traced request at its length, over the kernel's device
time in the trace, in %."""
from perfbench import layout
from perfbench.metrics_common import roofline_share
from perfbench.roofline import counts


def _scan(name):
    return "mamba_scan" in name


def read(run):
    if run.trace is None or not run.traced_lengths:
        return None
    z = layout.dims(run.cfg)
    n = sum(m == "mamba" for m, _ in layout.layer_kinds(run.cfg))
    bound = sum(n * counts.scan_bound_s(1, s, z["Di"], z["S"])
                for s in run.traced_lengths)
    return roofline_share(run, _scan, bound)
