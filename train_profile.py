"""Where one training step of the port's launcher goes, on one NVIDIA
GPU.

    python3 train_profile.py [--arch smollm-360m] [--batch 8] [--seq 2048]
                             [--model-axis N [--model-rank R]]

Builds the launcher's step (``launch.train.build``: fsdp on one rank,
remat on, the flash kernel) for the full-size config with random
weights from seed 0 and the launcher's data stream or, with
``--model-axis N``, model rank (0, R) (default N - 1, the block with the
most causal work) of the sequence-split sharded step on a (1, N)
``MeshLayout``, as ``chip_smoke.py`` (M2) builds it: its collectives are
recorded and return the stand-ins of ``train.comm``, whose device and
host time the profile reports on their own ("layout stand-in").  It
takes 3 warm-up steps, then:

1. one step under ``torch.cuda.set_sync_debug_mode("warn")``: the count
   of operations that made the host wait for the card;
2. over 3 steps, synchronized between them, the median host time from
   a step's call to its return and its device time (CUDA events); at
   this size the card's launch queue fills, so the host waits for the
   card and the first follows the second;
3. one step under ``torch.profiler`` (CPU and CUDA): the device time by
   kernel summed into groups (flash, matmuls, the rest by name), the
   device busy time against the step's wall time, the count of device
   operations, the host time in the launch calls, and the top kernels;
4. the same config at ``--small-batch`` x ``--small-seq`` (1 x 128),
   where the card keeps up with the host: the median host time to issue
   a step over 5 steps (the host's own cost), its device time, and (1
   step under the profiler) its count of device operations.

Prints one JSON line at the end with every figure and the card's name
and power limit.  Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

GROUPS = (                # (group, substrings of a kernel's name)
    ("flash", ("flash_attention",)),
    ("matmul", ("gemm", "cutlass", "sm90_xmma", "nvjet", "ampere_",
                "cublas")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce_kernel", "Reduce")),
    ("index", ("index", "gather", "scatter", "embedding")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _group(name: str) -> str:
    for g, keys in GROUPS:
        if any(k in name for k in keys):
            return g
    return "other"


STAND_IN = "layout stand-in"


def _tag_stand_ins(torch) -> None:
    """Runs each of a layout's collective stand-ins in a profiler range
    of its own (``STAND_IN``)."""
    from repro_torch.train import comm
    inner = comm._stand_in

    def tagged(*a, **kw):
        with torch.profiler.record_function(STAND_IN):
            return inner(*a, **kw)
    comm._stand_in = tagged


def _profile(torch, step, state, batch):
    """One step under ``torch.profiler`` (CPU and CUDA), ending in a
    synchronize: (state, metrics, figures)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_group: dict = {}
    rows = []
    busy, kernels, launch_cpu = 0.0, 0, 0.0
    stand_in = {"calls": 0, "device_ms": 0.0, "host_ms": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            if ev.key.startswith("cuda") and "Launch" in ev.key:
                launch_cpu += ev.self_cpu_time_total / 1e3
            if ev.key == STAND_IN:
                stand_in = {"calls": ev.count,
                            "device_ms": getattr(ev, "device_time_total",
                                                 0.0) / 1e3,
                            "host_ms": ev.cpu_time_total / 1e3}
            continue
        dt = getattr(ev, "device_time_total", None)
        if dt is None:
            dt = getattr(ev, "cuda_time_total", 0.0)
        if not dt:
            continue
        ms = dt / 1e3
        busy += ms
        kernels += ev.count
        grp = _group(ev.key)
        by_group[grp] = by_group.get(grp, 0.0) + ms
        rows.append((ms, ev.count, ev.key[:90]))
    rows.sort(reverse=True)
    return state, m, {
        "profiled_wall_ms": wall * 1e3, "device_busy_ms": busy,
        "idle_share": max(0.0, 1 - busy / (wall * 1e3)),
        "device_ops": kernels, "launch_api_cpu_ms": launch_cpu,
        "stand_in": stand_in,
        "device_ms_by_group": {k: round(v, 3) for k, v in sorted(
            by_group.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"ms": round(ms, 3), "count": n, "name": k}
                        for ms, n, k in rows[:15]]}


def _issue(torch, step, state, batches):
    """Per step, synchronized between steps: the host time from the
    call to its return and the device time (CUDA events)."""
    issue, device = [], []
    for b in batches:
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        e0.record()
        state, _ = step(state, b)
        e1.record()
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        device.append(e0.elapsed_time(e1))
    return state, statistics.median(issue), statistics.median(device)


def _split_step(torch, args, dev):
    """Model rank (0, ``--model-rank``) of the sequence-split step on a
    (1, ``--model-axis``) layout, and its sharded state."""
    from repro_torch import configs
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.train import shard
    from repro_torch.train.sharding import batch_specs
    from repro_torch.train.step import (TrainOptions, init_train_state,
                                        sharded_train_step)
    n = args.model_axis
    r = n - 1 if args.model_rank is None else args.model_rank
    layout = MeshLayout((1, n), ("data", "model"),
                        coords={"data": 0, "model": r})
    cfg = configs.get_config(args.arch)
    opts = TrainOptions(remat=True, use_kernel=True)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    full = init_train_state(g, cfg, opts, device=dev)
    step, sspec = sharded_train_step(cfg, layout, opts, full,
                                     batch_specs(layout))

    def run(state, batch):
        del layout.log[:]
        return step(state, batch)
    return cfg, run, shard.cut_tree(full, sspec, layout)


def _setup(torch, train, args, batch, seq, dev, n_batches):
    from repro_torch.data import DataPipeline, PipelineConfig
    if args.model_axis > 1:
        cfg, step, state = _split_step(torch, args, dev)
    else:
        targs = train._parser().parse_args(
            ["--arch", args.arch, "--batch", str(batch), "--seq", str(seq),
             "--steps", "20"])
        cfg, mesh, opts = train.build(targs, dev)
        from repro_torch.train.step import init_train_state, make_train_step
        step = make_train_step(cfg, mesh, opts)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        state = init_train_state(g, cfg, opts, device=dev)
    pipe = DataPipeline(PipelineConfig(vocab_size=cfg.vocab_size,
                                       seq_len=seq, global_batch=batch))
    batches = [pipe.batch(i, device=dev) for i in range(n_batches)]
    for i in range(3):
        state, _ = step(state, batches[i])
    torch.cuda.synchronize()
    return step, state, batches


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--small-batch", type=int, default=1)
    ap.add_argument("--small-seq", type=int, default=128)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--model-rank", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train
    from repro_torch.launch.mesh import ensure_process_group

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    created = args.model_axis == 1 and ensure_process_group(dev)
    if args.model_axis > 1:
        _tag_stand_ins(torch)
    step, state, batches = _setup(torch, train, args, args.batch,
                                  args.seq, dev, 10)

    # 1. synchronizing operations inside a step
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, _ = step(state, batches[3])
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]

    # 2. call-to-return host time and device time, full size
    state, call_ms, device_ms = _issue(torch, step, state, batches[4:7])

    # 3. the profiler, full size
    state, m, prof = _profile(torch, step, state, batches[7])
    loss = float(m["loss"])
    del state, m, batches
    torch.cuda.empty_cache()

    # 4. the same at a size where the card keeps up with the host: the
    # host's own time to issue a step
    step, state, batches = _setup(torch, train, args, args.small_batch,
                                  args.small_seq, dev, 9)
    state, small_issue, small_device = _issue(torch, step, state,
                                              batches[3:8])
    state, _, small = _profile(torch, step, state, batches[8])

    out = {"card": card, "arch": args.arch, "batch": args.batch,
           "seq": args.seq, "model_axis": args.model_axis,
           "model_rank": (args.model_axis - 1 if args.model_rank is None
                          else args.model_rank) if args.model_axis > 1
           else None,
           "syncs_in_a_step": len(syncs),
           "sync_kinds": sorted(set(syncs))[:8],
           "call_to_return_ms": call_ms, "device_ms_events": device_ms,
           **prof, "loss": loss,
           "small": {"batch": args.small_batch, "seq": args.small_seq,
                     "issue_ms": small_issue,
                     "device_ms_events": small_device,
                     **{k: small[k] for k in (
                         "profiled_wall_ms", "device_busy_ms",
                         "idle_share", "device_ops",
                         "launch_api_cpu_ms", "stand_in")}}}
    for k in ("syncs_in_a_step", "call_to_return_ms", "device_ms_events",
              "profiled_wall_ms", "device_busy_ms", "idle_share",
              "device_ops", "launch_api_cpu_ms", "stand_in"):
        print(f"{k}: {out[k]}")
    print(f"small: {out['small']}")
    for k, v in out["device_ms_by_group"].items():
        print(f"  {k:12s} {v:10.3f} ms")
    for r in out["top_kernels"]:
        print(f"  {r['ms']:10.3f} ms x{r['count']:5d}  {r['name']}")
    print(json.dumps(out))
    if created:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
