"""Serve a small model with batched requests: the prompts fed through the
KV-cache decode step one token a step, then greedy decode, measuring
the time a step.

    PYTHONPATH=src python examples_torch/serve_batch.py --device cpu
    PYTHONPATH=src python examples_torch/serve_batch.py           # a card

The run is that of ``examples/serve_batch.py``: qwen3-14b's smoke
config, batch 8, prompts of 24 tokens, 24 generated tokens (47 decode
steps), weights drawn from seed 0 and requests from seed 1 (here
``torch.Generator`` streams), and the same two lines printed.  The
decode path runs no kernel.  ``run`` takes a config, injected weights
and requests, so a caller can serve the published config or the
reference's weights.  The default device is ``cuda``; without a card
the script exits with an error.
"""
import argparse
import statistics
import time

import torch

from repro_torch import configs
from repro_torch.launch.mesh import local_device
from repro_torch.models import model as M
from repro_torch.serve.step import (ServeOptions, init_serve_cache,
                                    make_decode_step)

ARCH = "qwen3-14b"          # smoke-sized variant of the qwen3 family
BATCH, PROMPT, GEN = 8, 24, 24


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def make_weights(cfg, device: torch.device, dtype=torch.bfloat16):
    """The port's init from ``torch.Generator`` seed 0 (bf16), cast to
    ``dtype``."""
    g = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, generator=g, device=device)
    if dtype != torch.bfloat16:
        params = M.from_state(cfg, {k: t.to(dtype) for k, t in
                                    params.state_dict().items()})
    return params


def make_requests(cfg, batch: int, prompt: int, device: torch.device):
    """Prompt tokens in [2, vocab) from ``torch.Generator`` seed 1."""
    g = torch.Generator(device=device).manual_seed(1)
    return torch.randint(2, cfg.vocab_size, (batch, prompt), generator=g,
                         device=device)


def run(cfg, batch: int, prompt: int, gen: int, device: torch.device,
        params=None, requests=None, dtype=torch.bfloat16,
        keep_logits: bool = False) -> dict:
    """Serve ``batch`` requests of ``prompt`` tokens and ``gen`` greedy
    tokens each.  The KV cache takes ``dtype`` (the weights' dtype).
    Returns the generated tokens [batch, gen], the requests, the time (ms
    a step over the whole loop, tok/s, and each step's ms: CUDA events at
    the step boundaries on a card, the host clock on the CPU), the
    printed lines, and with ``keep_logits`` every step's logits
    [steps, batch, V] (step i's follow token i of the fed sequence)."""
    params = make_weights(cfg, device, dtype) if params is None else params
    reqs = (make_requests(cfg, batch, prompt, device) if requests is None
            else requests.to(device))
    cache = init_serve_cache(cfg, batch, prompt + gen, device=device,
                             dtype=dtype)
    decode = make_decode_step(cfg, ServeOptions())
    cuda = device.type == "cuda"
    steps = prompt + gen - 1
    marks = []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    if cuda:
        torch.cuda.synchronize(device)
    tok = reqs[:, :1]
    t0 = time.perf_counter()
    out, logits = [], []
    mark()
    for i in range(steps):
        nxt, cache, last = decode(params, cache, tok)
        mark()
        if keep_logits:
            logits.append(last)
        tok = reqs[:, i + 1: i + 2] if i + 1 < prompt else nxt
        if i + 1 >= prompt:
            out.append(nxt[:, 0])
    if cuda:
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    step_ms = ([a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
               if cuda else [(b - a) * 1e3 for a, b in zip(marks, marks[1:])])
    tokens = torch.stack(out, 1).cpu()
    lines = [f"batch={batch} prompt={prompt} gen={gen}: "
             f"{dt/steps*1e3:.1f} ms/step, "
             f"{batch*steps/dt:.0f} tok/s aggregate"]
    print(lines[-1], flush=True)
    _check(tuple(tokens.shape) == (batch, gen),
           f"generated {tuple(tokens.shape)}, want {(batch, gen)}")
    _check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
           "a generated token lies outside the vocabulary")
    lines.append("serve_batch OK")
    print(lines[-1], flush=True)
    return {"tokens": tokens, "requests": reqs,
            "logits": torch.stack(logits) if keep_logits else None,
            "ms_per_step": dt / steps * 1e3, "tok_s": batch * steps / dt,
            "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
            "lines": lines}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="default cuda; cpu serves on the CPU")
    args = ap.parse_args(argv)
    device = local_device(args.device)
    return run(configs.get_smoke(ARCH), BATCH, PROMPT, GEN, device)


if __name__ == "__main__":
    main()
