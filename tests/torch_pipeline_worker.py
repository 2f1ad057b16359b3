"""One stage of the port's GPipe test (tests/test_torch_pipeline.py).

Spawned by ``torch.multiprocessing.spawn``: joins an S-rank gloo group
through a ``file://`` rendezvous, runs ``core.pipeline.gpipe`` with its
own stage's weights (``tanh(h @ W + b)``), backpropagates a weighted
sum of the outputs, and saves the outputs and its weights' gradients
(with and without ``return_to_first``).  Imports torch and the port
only.
"""
import torch
import torch.distributed as dist

from repro_torch.core import pipeline as pl


def stage_fn(p, h):
    return torch.tanh(h @ p[0] + p[1])


def run(rank: int, n: int, init: str, inputs: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    try:
        out = {}
        for back in (False, True):
            W = inputs["W"][rank].clone().requires_grad_()
            b = inputs["b"][rank].clone().requires_grad_()
            # only stage 0's stream is read: the others pass zeros
            xs = inputs["x"] if rank == 0 else torch.zeros_like(inputs["x"])
            y = pl.gpipe(stage_fn, (W, b), xs, None, return_to_first=back)
            loss = (y * inputs["w"]).sum()
            gW, gb = torch.autograd.grad(loss, (W, b))
            out[back] = {"y": y.detach(), "gW": gW, "gb": gb}
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{out_dir}/rank{rank}.pt")
