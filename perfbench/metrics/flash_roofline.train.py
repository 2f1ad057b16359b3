"""The flash kernel (``csrc/flash_attention.cu``) in the train step:
the causal forward's bound (``roofline.counts.flash_bound_s`` at the
cell's B, S and heads) times the kernel's launches in the trace (the
forward and its remat recompute), over their device time, in %."""
from perfbench import layout
from perfbench.metrics_common import roofline_share
from perfbench.roofline import counts


def _flash(name):
    return "flash_attention" in name


def read(run):
    if run.trace is None:
        return None
    z, p = layout.dims(run.cfg), run.wl["params"]
    one = counts.flash_bound_s(p["batch"], p["seq"], z["H"], z["K"], z["D"])
    return roofline_share(run, _flash, one * run.trace.count(_flash))
