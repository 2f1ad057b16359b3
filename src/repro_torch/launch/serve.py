"""Serving launcher: greedy decode on one device, with a KV cache for
attention layers and the O(1) recurrent state for rwkv and mamba layers;
and the continuous-batching path over disaggregated KV pools.

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

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --continuous --kv-transport kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --smoke --continuous --device cpu --kv-transport kernel

The prompt is fed token by token through the decode step (teacher
forced), then ``--gen`` tokens are generated greedily.  ``--one-card``
takes the config's cut for one card (jamba: one period, experts 0-7 of
16; see its config file).  Weights and prompts are random, drawn from
seeded generators on the device.  The default device is ``cuda``;
without a card the launcher stops with an error instead of running on
the CPU.

``--continuous`` drives the continuous-batching engine through a seeded
Poisson multi-tenant trace instead: 8 ranks in two pods of 4 (prefill
pod, decode pool pod), ``--kv-blocks`` paged blocks of 8 tokens a rank,
each token's KV ``head_dim`` wide, the pool on ``--device``; every
batch of KV blocks moves prefill -> decode through a ragged neighbor
plan on ``--kv-transport`` (``kernel``: one launch of the transport
kernel a batch; ``dist``: one ``batch_isend_irecv`` a round, every rank
of a ``torchrun`` group driving the same engine) and is verified bitwise
against the gather oracle.  ``--resilience canary|full`` arms the
recovery ladder on those transfers: led by ``--kv-transport``, then the
numpy ``sim`` and ``reference`` rungs; the count of degradation reports
is printed.  It protects nothing without ``--continuous`` (the
single-shot decode runs no collective), so the launcher refuses that.
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


def _run_continuous(args, cfg, device: torch.device) -> dict:
    """Continuous batching: drive the engine through a seeded Poisson
    multi-tenant trace; KV blocks move prefill pool -> decode pool via
    ragged neighbor plans on ``--kv-transport`` (``dist``: over the
    ``torchrun`` group, which this creates and ends when none exists)."""
    from repro_torch.core import api as mpix_api

    mpix_api.set_default_policy(args.select_policy)
    group, created = None, False
    if args.kv_transport == "dist":
        import os

        import torch.distributed as dist
        if device.type == "cuda":        # one card per rank
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            # torchrun's environment: MASTER_ADDR/PORT, RANK, WORLD_SIZE
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo")
            created = True
        group = dist.group.WORLD
    try:
        metrics = _drive_engine(args, cfg, device, group)
    finally:
        if created:
            dist.destroy_process_group()
    return metrics


def _drive_engine(args, cfg, device: torch.device, group) -> dict:
    from repro_torch.serve.engine import ContinuousBatchingEngine, \
        EngineConfig
    from repro_torch.serve.traffic import poisson_workload, run_workload

    resilience = None
    if args.resilience != "off":
        # lead the ladder with the requested substrate; then the host
        # rungs, which run whatever the card does
        lead = args.kv_transport if args.kv_transport != "reference" \
            else "sim"
        ladder = tuple(dict.fromkeys((lead, "sim", "reference")))
        resilience = {"verify": args.resilience, "ladder": ladder,
                      "backoff_s": 1e-4}
    ecfg = EngineConfig(
        blocks_per_rank=args.kv_blocks,
        block_feat=(getattr(cfg, "head_dim", None) or 16),
        transport=args.kv_transport, policy=args.select_policy,
        resilience=resilience, device=str(device))
    engine = ContinuousBatchingEngine(ecfg, group=group)
    trace = poisson_workload(args.seed, arrival_rate=args.arrival_rate,
                             tenants=args.tenants,
                             n_requests=args.requests,
                             max_prompt=args.kv_blocks
                             * ecfg.block_tokens // 2)
    t0 = time.perf_counter()
    metrics = run_workload(engine, trace)
    dt = time.perf_counter() - t0
    if group is not None and group.rank() != 0:
        return metrics                  # every rank ran the same engine
    kv = metrics["kv_transfer"]
    print(f"continuous: {metrics['completed']}/{metrics['submitted']} "
          f"requests over {args.tenants} tenants in "
          f"{metrics['steps']} steps ({dt:.2f}s), "
          f"{metrics['tokens']} tokens "
          f"({metrics['tokens_per_step']} tok/step, "
          f"{metrics['tokens_per_s']} tok/s)")
    print(f"ttft: mean {metrics['ttft_steps']['mean']} steps, "
          f"p99 {metrics['ttft_steps']['p99']}; "
          f"preemptions {metrics['preemptions']}")
    print(f"kv-transfer: {kv['plans']} plans, {kv['blocks']} blocks, "
          f"{kv['bytes']}B ({kv['dcn_bytes']}B dcn / "
          f"{kv['ici_bytes']}B ici) via {kv['plan_names']} on "
          f"{args.kv_transport} ({device}), {kv['wall_s']}s wall, every "
          f"batch bitwise against the gather oracle")
    if metrics["degradations"]:
        degraded = sum(1 for r in engine.degradations if r.degraded)
        print(f"resilience: {metrics['degradations']} degradation "
              f"report(s) collected, {degraded} degraded")
    return metrics


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
    ap.add_argument("--select-policy", default="model",
                    choices=["fixed", "model"],
                    help="selection policy for algorithm='auto' "
                         "collectives and the KV plans' standard-vs-"
                         "locality-aware mode")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching mode: drive the "
                         "disaggregated prefill/decode engine through "
                         "a seeded Poisson multi-tenant trace; KV "
                         "blocks move between pools via ragged "
                         "neighbor plans")
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="continuous mode: mean requests/sec of the "
                         "Poisson arrival process")
    ap.add_argument("--tenants", type=int, default=2,
                    help="continuous mode: tenant count of the bursty "
                         "traffic mix (each tenant has its own "
                         "prompt/gen length skew)")
    ap.add_argument("--requests", type=int, default=32,
                    help="continuous mode: trace length")
    ap.add_argument("--kv-transport", default="kernel",
                    choices=["sim", "reference", "dist", "kernel"],
                    help="continuous mode: substrate executing the KV "
                         "block-transfer schedules (dist runs under "
                         "torchrun with one process per engine rank)")
    ap.add_argument("--resilience", default="off",
                    choices=["off", "canary", "full"],
                    help="continuous mode: arm the recovery ladder on the "
                         "KV transfers (led by --kv-transport, then sim "
                         "and reference); canary/full set the "
                         "verification mode")
    ap.add_argument("--kv-blocks", type=int, default=32,
                    help="continuous mode: KV blocks per engine rank")
    ap.add_argument("--seed", type=int, default=0,
                    help="continuous mode: trace seed")
    args = ap.parse_args(argv)

    # ---- argument validation (fail loudly, never deep in the loop) ----
    if args.gen < 1:
        ap.error(f"--gen must be >= 1 (got {args.gen}): generating "
                 f"zero tokens leaves nothing to stack or serve")
    if args.prompt_len < 1:
        ap.error(f"--prompt-len must be >= 1 (got {args.prompt_len})")
    if args.batch < 1:
        ap.error(f"--batch must be >= 1 (got {args.batch})")
    if args.continuous:
        if args.arrival_rate <= 0:
            ap.error(f"--arrival-rate must be > 0 "
                     f"(got {args.arrival_rate})")
        if args.tenants < 1:
            ap.error(f"--tenants must be >= 1 (got {args.tenants})")
        if args.requests < 1:
            ap.error(f"--requests must be >= 1 (got {args.requests})")
        if args.kv_blocks < 1:
            ap.error(f"--kv-blocks must be >= 1 (got {args.kv_blocks})")
    if args.resilience != "off" and not args.continuous:
        # resilience threads through the KV transfer collectives only;
        # without them it would silently protect nothing
        raise SystemExit(
            f"--resilience {args.resilience} has nothing to protect: "
            f"the single-shot decode path runs no mpix collectives. "
            f"Arm a protected path with --continuous (KV-cache "
            f"transfers), or drop --resilience.")
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
    if args.continuous:
        return _run_continuous(args, cfg, device)
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
