"""The prefill's model FLOPs (``roofline.counts.prefill_flops``: 2 x
active parameters a token, the causal attention products, the head once
a request) over the measured window's time (untraced, as
``prefill_tokens_per_s`` takes it) at the published bf16 peak, in %."""
from perfbench.roofline import counts, peaks


def read(run):
    if not run.lengths:
        return None
    flops = sum(counts.prefill_flops(run.cfg, n) for n in run.lengths)
    return 100.0 * flops / (run.window_s * run.chips * peaks.BF16_FLOPS)
