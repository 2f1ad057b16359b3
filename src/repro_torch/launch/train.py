"""Training launcher: data pipeline + train step + fault-tolerant loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 20 --batch 8 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --device cpu --steps 50 --batch 4 --seq 64 --ckpt-dir run1
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch smollm-360m --smoke --device cpu --steps 6 --batch 8 \
        --seq 32 --dp-mode explicit --dp-algorithm ring_rs_ag

Without ``--smoke`` the config is the published one at full width and
depth.  The default device is ``cuda`` (one card a rank); without a card
the launcher stops with an error, and ``--device cpu`` runs the plain
versions of the kernels on the CPU.  The step runs with
``use_kernel=True``: on the card each causal attention layer runs the
flash kernel (each rwkv layer the wkv6 kernel, each mamba layer the
scan kernel), and with ``--remat`` (on unless ``--smoke``, as in the
reference) every period is recomputed in the backward pass, kernels
included.

``--mesh local`` puts every rank of the group on the data axis: the
group of ``torchrun`` (its environment), or without one a group of this
process alone (NCCL on the card, gloo on the CPU); ``--model-axis M``
puts M of them on the ``model`` axis, where the fsdp step splits the
sequence (each model rank runs its ``--seq`` / M rows).  Each rank reads its
own rows of the global batch (``--batch`` must divide by the rank
count).  ``--dp-mode explicit`` syncs the gradients through
``mpix_allreduce`` (``--dp-algorithm``, ``--grad-buckets``,
``--dp-transport dist|kernel|auto``); ``fsdp`` on more than one rank
stores each rank's share of every parameter and both moments
(``train.step.sharded_train_step``: the native all-gather and
reduce-scatter), on one rank it is the plain step.  Restart the same command after a crash or preemption: with
``--ckpt-dir`` it resumes from the newest committed checkpoint (with
more ranks than one, each rank keeps its own copy under
``rank{r}/``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import api as mpix_api
from repro_torch.data import DataPipeline, PipelineConfig
from repro_torch.launch.mesh import (ensure_process_group, local_device,
                                     make_local_mesh, make_production_mesh)
from repro_torch.runtime import FaultTolerantLoop, PreemptionSignal
from repro_torch.train import shard
from repro_torch.train.sharding import batch_specs
from repro_torch.train.step import (TrainOptions, data_axes,
                                    init_train_state, make_train_step,
                                    sharded_train_step)


@dataclasses.dataclass
class TrainRun:
    """What ``main`` ran: the loss of each step it took, the step it
    started from (after a resume), and per step the device time (CUDA
    events around the step; None on the CPU) and the host time from the
    step's call to its return, in ms (the time to issue it only while
    the device keeps up: once the card's launch queue is full the host
    waits for it); the peak device memory (bytes, None on the CPU)."""
    losses: list
    start_step: int
    step_ms: list
    host_ms: list
    peak_bytes: int | None


def build(args, device: torch.device):
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.mesh == "local":
        mesh = make_local_mesh(device, args.model_axis)
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device_type=device.type)
    opts = TrainOptions(
        dp_mode=args.dp_mode, dp_algorithm=args.dp_algorithm,
        grad_buckets=args.grad_buckets, moe_mode=args.moe_mode,
        ep_alltoall=args.ep_alltoall, ep_policy=args.select_policy,
        ep_transport=args.ep_transport, dp_transport=args.dp_transport,
        resilience=(None if args.resilience == "off"
                    else args.resilience),
        remat=not args.smoke, use_kernel=True,
        peak_lr=args.lr, warmup_steps=max(1, args.steps // 20),
        total_steps=args.steps)
    return cfg, mesh, opts


def mesh_topologies(mesh):
    """The topologies the run's collectives query: one per single
    non-pod axis of more than one rank, plus one per ("pod", axis) pair,
    deduplicated (the whole mesh's when no axis has more than one)."""
    from repro_torch.core.topology import Topology, flat_topology
    topos = {}
    npods = mesh.shape.get("pod", 1)
    for a in (a for a in mesh.axis_names if a != "pod"):
        size = mesh.shape[a]
        if size > 1:
            t = flat_topology(size)
            topos[t.fingerprint()] = t
            if npods > 1:
                t = Topology(nranks=npods * size, ranks_per_pod=size)
                topos[t.fingerprint()] = t
    if not topos:
        t = flat_topology(mesh.size)
        topos[t.fingerprint()] = t
    return list(topos.values())


def autotune_mesh(mesh, repeats: int = 3, full: bool = False,
                  probe: bool = False):
    """Tune (or heal) every topology of ``mesh_topologies`` (see
    ``launch.serve.autotune_topology``)."""
    from repro_torch.launch.serve import autotune_topology
    return [autotune_topology(t, repeats=repeats, full=full,
                              probe=probe)[1]
            for t in mesh_topologies(mesh)]


def heal_daemons(mesh, heal_every: int):
    """One ``TuningDaemon`` per mesh topology, probing every
    ``heal_every`` steps: the drift-healing heartbeat the loop ticks."""
    from repro_torch.runtime import TuningDaemon
    return [TuningDaemon(topo, probe_every=heal_every)
            for topo in mesh_topologies(mesh)]


def make_elastic(mesh, policy: str):
    """(RankLossSignal, on_rank_loss, schedules) for
    ``FaultTolerantLoop``: on rank loss, re-derive the launcher's staged
    schedules (grad sync + EP dispatch) for the shrunk topology and swap
    them in place; the loop keeps stepping."""
    from repro_torch.core import selector
    from repro_torch.runtime import ElasticScheduleSet, RankLossSignal

    topo = max(mesh_topologies(mesh), key=lambda t: t.nranks)
    nbytes = 1 << 20
    entries = {}
    for name, coll in (("grad_sync", "allreduce"),
                       ("ep_dispatch", "alltoall")):
        algo = selector.select(coll, topo, nbytes, policy=policy)
        if algo == "xla":          # schedule sets hold IR plans only
            algo = selector.select(coll, topo, nbytes, policy="model")
        entries[name] = (coll, algo)
    schedules = ElasticScheduleSet(topo, entries)
    signal = RankLossSignal()

    def on_rank_loss(state, step, lost):
        in_range = [r for r in lost if r < schedules.topo.nranks]
        if not in_range or len(in_range) >= schedules.topo.nranks:
            print(f"rank loss {lost} outside schedule topology; no swap")
            return None
        rep = schedules.shrink(in_range)
        print(f"elastic swap @step {step}: lost {rep.lost_ranks}, "
              f"{rep.old_fingerprint} -> {rep.new_fingerprint}, "
              f"re-derived {len(rep.rederived)} schedule(s), evicted "
              f"{rep.invalidated} stale executor(s)", flush=True)
        return None                # state and step_fn unchanged

    return signal, on_rank_loss, schedules


def _parser():
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs every "
                         "kernel's plain version)")
    ap.add_argument("--mesh", default="local",
                    choices=["local", "single", "multi"])
    ap.add_argument("--model-axis", type=int, default=1,
                    help="--mesh local: ranks on the model axis (the "
                         "sequence split of the fsdp step)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dp-mode", default="fsdp",
                    choices=["fsdp", "explicit"])
    ap.add_argument("--dp-algorithm", default="xla")
    ap.add_argument("--select-policy", default="model",
                    choices=["fixed", "model", "tuned"],
                    help="algorithm selection policy for algorithm="
                         "'auto' collectives (tuned reads the persisted "
                         "tuner table; see repro_torch.core.tuner)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune this mesh's topologies before training; "
                         "an existing table is healed in place")
    ap.add_argument("--autotune-full", action="store_true",
                    help="ignore any persisted table and re-measure "
                         "everything (implies --autotune)")
    ap.add_argument("--probe-links", action="store_true",
                    help="probe per-level link models before tuning; "
                         "tables key on the probed geometry")
    ap.add_argument("--heal-every", type=int, default=0,
                    help="re-probe every N steps and heal tuned tables "
                         "on drift (0 = off)")
    ap.add_argument("--elastic", action="store_true",
                    help="on rank loss, re-derive the staged schedules "
                         "for the shrunk topology and swap them in place")
    ap.add_argument("--grad-buckets", type=int, default=1)
    ap.add_argument("--moe-mode", default="dropless",
                    choices=["dense", "dropless", "mpix_ep"])
    ap.add_argument("--ep-alltoall", default="xla")
    ap.add_argument("--ep-transport", default="dist",
                    choices=list(mpix_api.TRANSPORTS),
                    help="substrate of schedule-backed EP collectives: "
                         "one exchange per round (dist), the whole "
                         "schedule as one launch of the transport kernel "
                         "(kernel), or the tuner's per-size choice (auto)")
    ap.add_argument("--dp-transport", default="dist",
                    choices=list(mpix_api.TRANSPORTS),
                    help="substrate of the explicit-mode gradient sync "
                         "(same choices as --ep-transport)")
    ap.add_argument("--resilience", default="off",
                    choices=["off", "canary", "full"],
                    help="arm the API's recovery ladder on the EP "
                         "dispatch and the explicit-mode gradient sync")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None) -> TrainRun:
    args = _parser().parse_args(argv)
    device = local_device(args.device)
    created = ensure_process_group(device)
    try:
        return _train(args, device)
    finally:
        if created:
            dist.destroy_process_group()


def _train(args, device: torch.device) -> TrainRun:
    mpix_api.set_default_policy(args.select_policy)
    cfg, mesh, opts = build(args, device)
    if args.autotune or args.autotune_full:
        autotune_mesh(mesh, full=args.autotune_full, probe=args.probe_links)
    daemons = heal_daemons(mesh, args.heal_every) if args.heal_every \
        else []
    d_axes = data_axes(mesh)
    pipe = DataPipeline(PipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch), num_shards=mesh.axis_size(d_axes),
        shard=mesh.axis_index(d_axes))
    g = torch.Generator(device=device)
    g.manual_seed(0)
    state = init_train_state(g, cfg, opts, device=device)
    if opts.dp_mode == "fsdp" and mesh.size > 1:
        step_fn, sspec = sharded_train_step(cfg, mesh, opts, state,
                                            batch_specs(mesh))
        state = shard.cut_tree(state, sspec, mesh)
    else:
        step_fn = make_train_step(cfg, mesh, opts)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    losses, events, host_ms = [], [], []
    t_last = [time.perf_counter()]

    def one_step(state, step):
        batch = pipe.batch(step, device=device)
        t0 = time.perf_counter()
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        state, metrics = step_fn(state, batch)
        if cuda:
            ev[1].record()
            events.append(ev)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
        if (step + 1) % args.log_every == 0:
            dt = (time.perf_counter() - t_last[0]) / args.log_every
            t_last[0] = time.perf_counter()
            print(f"step {step + 1:5d}  loss {float(losses[-1]):.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"{dt * 1e3:.0f} ms/step", flush=True)
        return state

    def on_step(step, state):
        for d in daemons:
            rep = d.tick(step)
            if rep is not None and rep.healed:
                print(f"drift healed @step {step}: levels "
                      f"{rep.drifted_levels}, re-measured "
                      f"{len(rep.retuned_cells)}/{rep.total_cells} "
                      f"cell(s), generation {rep.generation}", flush=True)

    start = 0
    if args.ckpt_dir:
        rank_loss = on_rank_loss = None
        if args.elastic:
            rank_loss, on_rank_loss, _ = make_elastic(mesh,
                                                      args.select_policy)
        ckpt_dir = (args.ckpt_dir if dist.get_world_size() == 1 else
                    os.path.join(args.ckpt_dir, f"rank{dist.get_rank()}"))
        loop = FaultTolerantLoop(ckpt_dir, ckpt_every=args.ckpt_every,
                                 preemption=PreemptionSignal(True),
                                 rank_loss=rank_loss,
                                 on_rank_loss=on_rank_loss)
        try:
            state, start = loop.resume_or_init(state)
            if start:
                print(f"resumed from step {start}")
            state, _ = loop.run(state, one_step, start_step=start,
                                num_steps=max(0, args.steps - start),
                                on_step=on_step if daemons else None)
        finally:
            loop.preemption.uninstall()
    else:
        for s in range(args.steps):
            state = one_step(state, s)
            on_step(s + 1, state)
    if cuda:
        torch.cuda.synchronize(device)
    losses = [float(v) for v in losses]
    run = TrainRun(losses=losses, start_step=start,
                   step_ms=[a.elapsed_time(b) for a, b in events],
                   host_ms=host_ms,
                   peak_bytes=(torch.cuda.max_memory_allocated(device)
                               if cuda else None))
    if losses:
        print(f"final loss {np.mean(losses[-5:]):.4f} "
              f"(first {np.mean(losses[:5]):.4f})")
    else:
        print("nothing to do (already past --steps; checkpoint is "
              "complete)")
    return run


if __name__ == "__main__":
    main()
