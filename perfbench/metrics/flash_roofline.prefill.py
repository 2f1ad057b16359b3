"""The flash kernel (``csrc/flash_attention.cu``) in the prefill: the
causal forward's bound (``roofline.counts.flash_bound_s``) of every
attention layer of every traced request at its length, over the
kernel's device time in the trace, in %."""
from perfbench import layout
from perfbench.metrics_common import roofline_share
from perfbench.roofline import counts


def _flash(name):
    return "flash_attention" in name


def read(run):
    if run.trace is None or not run.traced_lengths:
        return None
    z = layout.dims(run.cfg)
    n = counts.attention_layers(run.cfg)
    bound = sum(n * counts.flash_bound_s(1, s, z["H"], z["K"], z["D"])
                for s in run.traced_lengths)
    return roofline_share(run, _flash, bound)
