"""Serving launcher: greedy decode on one device, with a KV cache for
attention layers and the O(1) recurrent state for rwkv and mamba layers.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --one-card --batch 4 --prompt-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --smoke --device cpu

The prompt is fed token by token through the decode step (teacher
forced), then ``--gen`` tokens are generated greedily.  ``--one-card``
takes the config's cut for one card (jamba: one period, experts 0-7 of
16; see its config file).  Weights and prompts are random, drawn from
seeded generators on the device.  The default device is ``cuda``;
without a card the launcher stops with an error instead of running on
the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.serve.step import (ServeOptions, init_serve_cache,
                                    make_decode_step)


def generate(params, cfg, prompts: torch.Tensor, gen: int, *,
             opts: ServeOptions = ServeOptions()):
    """Teacher-forced prefill through the decode step, then ``gen``
    greedy tokens.  Returns (tokens [B, gen] int32, logits [B, P+gen-1,
    V]): step i's logits follow token i of the fed sequence.  The KV
    cache and the rwkv token-shift carries take the weights' dtype (bf16,
    as in the reference); the rwkv state ``s`` and the mamba state ``h``
    are f32, the mamba conv window bf16."""
    B, P = prompts.shape
    max_len = P + gen
    cache = init_serve_cache(cfg, B, max_len, device=prompts.device,
                             dtype=params.embed.dtype)
    decode = make_decode_step(cfg, opts)
    tok = prompts[:, :1]
    outs, logits = [], []
    for i in range(max_len - 1):
        nxt, cache, last = decode(params, cache, tok)
        logits.append(last)
        if i + 1 < P:
            tok = prompts[:, i + 1: i + 2]              # teacher-forced
        else:
            tok = nxt
            outs.append(nxt[:, 0])
    return torch.stack(outs, 1), torch.stack(logits, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", action="store_true")
    size.add_argument("--one-card", action="store_true",
                      help="the config's cut for one card (jamba-1.5-"
                           "large-398b: one period, experts 0-7 of 16)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs every "
                         "kernel's plain version)")
    args = ap.parse_args(argv)

    # ---- argument validation (fail loudly, never deep in the loop) ----
    if args.gen < 1:
        ap.error(f"--gen must be >= 1 (got {args.gen}): generating "
                 f"zero tokens leaves nothing to stack or serve")
    if args.prompt_len < 1:
        ap.error(f"--prompt-len must be >= 1 (got {args.prompt_len})")
    if args.batch < 1:
        ap.error(f"--batch must be >= 1 (got {args.batch})")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available; pass "
            f"--device cpu to run the plain versions on the CPU")

    try:
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get_one_card(args.arch) if args.one_card
               else configs.get_config(args.arch))
    except KeyError as e:
        ap.error(e.args[0])
    g = torch.Generator(device=device)
    g.manual_seed(0)
    params = M.init_params(cfg, generator=g, device=device)
    g.manual_seed(1)
    prompts = torch.randint(2, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g, device=device)

    t0 = time.perf_counter()
    out, _ = generate(params, cfg, prompts, args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    steps = args.prompt_len + args.gen - 1
    print(f"generated {tuple(out.shape)} on {device} in {dt:.2f}s "
          f"({steps * args.batch / dt:.1f} tok/s)")
    print(out[:, :12].cpu().numpy())
    return out


if __name__ == "__main__":
    main()
