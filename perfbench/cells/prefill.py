"""The prefill cell: one client sends prompts in a closed loop, batch 1,
through the port's prefill step (``repro_torch.serve.step.
make_prefill_step``); a request's first token is the greedy choice at
its last position, read on the host.

Set-up draws the weights on the device from the seed and runs one
prefill at each length of the traffic's grid, the longest first.  In
the window each request is due when the previous one has its first
token; the time to first token runs from then to the token on the
host.  After the window, with the program's weights freed, the plain
reference (``reference/jamba.py``) runs a sample of the finished prompts drawn from the seed, the longest among
them, layer by layer in float32, and judges the program's greedy token
at every position (the served first token at the last) by how far its
reference logit lies below the reference's best.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import harness, layout, program, weights
from perfbench.reference import check, common, jamba


def _to_device(ids: np.ndarray, device):
    t = torch.from_numpy(ids)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.to(device)[None]


def run(ctx) -> None:
    from repro_torch.models import model as M
    from repro_torch.serve.step import ServeOptions, make_prefill_step

    wl, cfg, dev, seed = ctx.wl, ctx.cfg, ctx.device, ctx.args.seed
    traffic = harness.load_file(harness.BENCH / "traffic"
                                / f"{wl['kind']}.py")
    mcfg = program.port_config(cfg)
    params = weights.make(cfg, seed, dev)
    program.check_layout(mcfg, params)
    model = M.from_state(mcfg, params)
    del params
    prefill = make_prefill_step(mcfg, ServeOptions(**wl["options"]))
    stream = traffic.Stream(wl["params"], seed, cfg["vocab_size"])
    for n in sorted(set(traffic.length_grid(wl["params"])), reverse=True):
        ids = (np.arange(n, dtype=np.int64) * 7919) % cfg["vocab_size"]
        int(torch.argmax(prefill(model, _to_device(ids, dev))[0, -1]))

    reqs = []

    def one_request():
        due = time.perf_counter()
        with ctx.span("batch"):
            x = _to_device(stream.next(), dev)
        with ctx.span("prefill"):
            logits = prefill(model, x)
        with ctx.span("first_token"):
            first = int(torch.argmax(logits[0, -1]))
        ttft = time.perf_counter() - due
        with ctx.span("argmax"):
            chosen = torch.argmax(logits[0], -1)
            chosen[-1] = first
        reqs.append({"x": x[0], "tokens": chosen, "ttft": ttft})

    done, traced = ctx.measure(one_request)
    r = ctx.run
    r.traced_lengths = [int(q["x"].numel()) for q in reqs[done:done + traced]]
    r.traced_tokens = sum(r.traced_lengths)
    del reqs[done:]
    r.attempted = len(reqs)
    r.lengths = [int(q["x"].numel()) for q in reqs]
    r.ttft_s = [q["ttft"] for q in reqs]
    r.tokens = sum(r.lengths)

    # the check, with the program's weights freed
    del model, prefill
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    common.exact_f32()
    picked = sample(r.lengths, seed, wl["check_requests"])
    nums = check.prefill_numbers(
        token_gaps(cfg, seed, dev, [reqs[i] for i in picked]))
    for k, lim in wl["limits"].items():
        r.checks[k] = (nums.pop(k), lim)
    r.notes = {"checked_lengths": [r.lengths[i] for i in picked], **nums,
               "reference_s": time.perf_counter() - t_ref}


def sample(lengths: list, seed: int, n: int) -> list[int]:
    """``n`` finished requests drawn from the seed, the longest (its
    first) always among them."""
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2 ** 64 - 1), 0xC4]))
    k = min(n - 1, len(rest))
    return sorted([longest, *rng.choice(rest, size=k, replace=False)])


def reference_prefill(cfg, seed, device, prompts, judge,
                      precision="f32") -> None:
    """The reference's logits of each prompt, handed to ``judge``; the
    weights drawn again from the seed, group by group, in float32."""
    z = layout.dims(cfg)

    def load_group(name):
        return {k: v.float() for k, v in
                weights.make_group(cfg, seed, name, device).items()}

    jamba.prefill(load_group, z, layout.layer_kinds(cfg), prompts, judge,
                  precision)


def token_gaps(cfg, seed, device, reqs) -> list:
    """The program's tokens judged at every position of each request
    (``check.judge``)."""
    out = []

    def judge(j, logits):
        out.append(check.judge(logits, reqs[j]["tokens"]))

    reference_prefill(cfg, seed, device, [q["x"] for q in reqs], judge)
    return out
