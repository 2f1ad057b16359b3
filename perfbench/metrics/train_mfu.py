"""The train step's model FLOPs (``roofline.counts.train_flops``: 6 x
parameters a token plus the causal attention products, no recompute)
over the measured window's time (untraced, as ``train_tokens_per_s``
takes it) and the cell's cards at the published bf16 peak, in %."""
from perfbench.roofline import counts, peaks


def read(run):
    if not run.steps:
        return None
    p = run.wl["params"]
    flops = counts.train_flops(run.cfg, p["batch"] * run.chips, p["seq"])
    return (100.0 * flops * run.steps
            / (run.window_s * run.chips * peaks.BF16_FLOPS))
