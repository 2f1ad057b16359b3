"""Time a step in which rank 0's device runs NCCL kernels (the gradient
sync's rounds and the loss and count sums) and no other kernel, from
the device trace, in ms."""


def _nccl(name):
    return "nccl" in name.lower()


def read(run):
    if run.trace is None or not run.traced_steps or run.chips < 2 \
            or not run.trace.count(_nccl):
        return None
    return 1e3 * run.trace.alone_s(_nccl) / run.traced_steps
