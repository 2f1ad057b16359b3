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
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --one-card --batch 4 --prompt-len 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-small --batch 4 --prompt-len 32 --gen 16

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --continuous --kv-transport kernel
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --smoke --continuous --device cpu --kv-transport kernel

The prompt is fed token by token through the decode step (teacher
forced), then ``--gen`` tokens are generated greedily.  ``--mesh
local|single|multi`` runs that decode on a mesh of ranks
(``serve.step.mesh_decode_step``; under ``torchrun`` for more than one):

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch gemma2-2b --smoke --device cpu --mesh local --batch 4
  ``--one-card``
takes the config's cut for one card (jamba: one period, experts 0-7 of
16; deepseek-v3: layers 0-3, experts 0-7 of 256; see the config files).
Weights and prompts are random, drawn from seeded generators on the
device.  An encoder-decoder (whisper) encodes seeded random frames
[batch, n_frames, d_model] in bf16 once and every decode step reads
that output; a VLM (qwen2-vl) is served text-only, as in the reference,
whose decode step takes no vision input.  The default device is ``cuda``;
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

``--autotune`` tunes the engine's topology before serving (a persisted
table is healed in place instead; ``--autotune-full`` re-measures
everything) on the ``--kv-transport`` substrate: the card's transport
kernel for ``kernel`` (the model on ``--device cpu``), the ``torchrun``
group for ``dist``, the model for ``sim`` and ``reference``; then
``--select-policy tuned`` reads the table for every plan's mode.
``--probe-links`` keys the table by probed link models, and the engine
builds its plans on that probed topology (one card holds no wire: there
the probe prices with the model and says so).  ``--heal-interval N``
(``--kv-transport dist`` only: elsewhere the probe prices with the model,
which cannot drift) builds the drift-healing tuner daemon on the
engine's topology and runs it between engine ticks every N seconds; the
engine follows the healed topology.  These tune what ``--continuous``
queries, so without it the launcher refuses them too.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --continuous --kv-transport kernel --autotune --select-policy tuned
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.launch.mesh import local_device
from repro_torch.models import model as M
from repro_torch.serve.step import (ServeOptions, init_serve_cache,
                                    make_decode_step)


def generate(params, cfg, prompts: torch.Tensor, gen: int, *,
             opts: ServeOptions = ServeOptions(), cross_src=None):
    """Teacher-forced prefill through the decode step, then ``gen``
    greedy tokens.  Returns (tokens [B, gen] int32, logits [B, P+gen-1,
    V]): step i's logits follow token i of the fed sequence.  The KV
    cache, MLA's latent cache and the rwkv token-shift carries take the
    weights' dtype (bf16, as in the reference); the rwkv state ``s`` and
    the mamba state ``h`` are f32, the mamba conv window bf16.
    ``cross_src`` (the encoder output) goes to every decode step of an
    encoder-decoder."""
    B, P = prompts.shape
    cache = init_serve_cache(cfg, B, P + gen, device=prompts.device,
                             dtype=params.embed.dtype)
    return _loop(make_decode_step(cfg, opts), params, cache, prompts, gen,
                 cross_src)


def _loop(decode, params, cache, prompts, gen, cross_src):
    P = prompts.shape[1]
    max_len = P + gen
    tok = prompts[:, :1]
    outs, logits = [], []
    for i in range(max_len - 1):
        nxt, cache, last = decode(params, cache, tok, cross_src)
        logits.append(last)
        if i + 1 < P:
            tok = prompts[:, i + 1: i + 2]              # teacher-forced
        else:
            tok = nxt
            outs.append(nxt[:, 0])
    return torch.stack(outs, 1), torch.stack(logits, 1)


MESH_RANKS = {"single": 256, "multi": 512}


def mesh_generate(args, cfg, device: torch.device):
    """``generate`` on a mesh of ranks through ``mesh_decode_step``:
    ``--mesh local`` is every rank of the group on the data axis, (n, 1)
    over ``("data", "model")``, or with ``--model-axis M`` (n / M, M),
    where each parameter block cut over ``model`` stays where it is
    stored; ``single`` / ``multi`` the production meshes (256 / 512
    ranks).  Every rank draws the same weights and
    prompts, stores its share (``train.shard``) and decodes its own rows
    of the batch.  Returns this rank's tokens."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (ensure_process_group,
                                         make_local_mesh,
                                         make_production_mesh)
    from repro_torch.serve.step import mesh_decode_step
    from repro_torch.train import shard
    from repro_torch.train.sharding import data_axes
    created = ensure_process_group(device)
    try:
        world = dist.get_world_size()
        need = MESH_RANKS.get(args.mesh)
        if need is not None and world != need:
            raise SystemExit(
                f"--mesh {args.mesh} needs {need} ranks (one a mesh "
                f"position of {'2 x 16 x 16' if need == 512 else '16 x 16'}"
                f"); the group has {world}. Start {need} ranks under "
                f"torchrun, or use --mesh local")
        mesh = (make_local_mesh(device, args.model_axis)
                if args.mesh == "local" else
                make_production_mesh(multi_pod=args.mesh == "multi",
                                     device_type=device.type))
        d_axes = data_axes(mesh)
        n_data = mesh.axis_size(d_axes)
        if args.batch % n_data:
            raise SystemExit(f"--batch {args.batch} does not divide over "
                             f"the {n_data} ranks of the data axes")
        params, prompts, cross = _inputs(args, cfg, device)
        P = prompts.shape[1]
        full = init_serve_cache(cfg, args.batch, P + args.gen,
                                device="meta", dtype=params.embed.dtype)
        step, (pspec, cspec) = mesh_decode_step(cfg, mesh, ServeOptions(),
                                                params, full)
        blocks = shard.cut_tree(params.state_dict(), pspec, mesh)
        del params
        cache = shard.zeros_tree(full, cspec, mesh, device=device)
        rows = args.batch // n_data
        r0 = mesh.axis_index(d_axes) * rows
        mine = prompts[r0:r0 + rows]
        cross = None if cross is None else cross[r0:r0 + rows]
        out, _ = _loop(step, blocks, cache, mine, args.gen, cross)
        if mesh.rank == 0:
            print(f"mesh {dict(mesh.shape)}: rank 0 decoded rows "
                  f"[{r0}, {r0 + rows}) of {args.batch}")
            print(out[:, :12].cpu().numpy())
        return out
    finally:
        if created:
            dist.destroy_process_group()


def _inputs(args, cfg, device):
    """Seeded weights, prompts and (an encoder-decoder's) encoder
    output."""
    g = torch.Generator(device=device)
    g.manual_seed(0)
    params = M.init_params(cfg, generator=g, device=device)
    g.manual_seed(1)
    prompts = torch.randint(2, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g, device=device)
    cross = None
    if cfg.encoder is not None:
        g.manual_seed(2)
        frames = torch.randn((args.batch, cfg.encoder.n_frames,
                              cfg.encoder.d_model), generator=g,
                             device=device).to(torch.bfloat16)
        with torch.no_grad():
            cross = M.encode(params, cfg, frames)
    return params, prompts, cross


def _substrate(args, device: torch.device) -> str | None:
    """What ``--autotune`` measures on: the ``--kv-transport``'s own
    substrate where it has one, else None (the model)."""
    if args.kv_transport == "kernel" and device.type == "cuda":
        return "kernel"
    return "dist" if args.kv_transport == "dist" else None


def autotune_topology(topo, *, substrate: str | None = None,
                      force_model: bool = False, repeats: int = 3,
                      full: bool = False, probe: bool = False):
    """Tune (or heal) the topology the launcher's collectives query (the
    counterpart of the reference's ``autotune_mesh``).

    With no persisted table it runs a full ``tuner.autotune`` (dense
    collectives, neighbor aggregate-vs-standard, partitioned chunking,
    overlap and transport cells); a persisted table is *healed* instead
    (``tuner.heal_table``): guideline violations and cells missing newly
    registered algorithms are re-measured, nothing else.  ``full=True``
    re-tunes from scratch.  ``probe=True`` runs the link-probe pass
    first (``core.linkprobe``): the table is keyed by the probed
    geometry (``lm[...]`` in its fingerprint).  Returns ``(topo,
    table)``: the topology the table is keyed by, which the engine must
    build its plans on for ``policy="tuned"`` to read the table.
    """
    from repro_torch.core import linkprobe, tuner
    if probe:
        res = linkprobe.probe_links(topo, repeats=repeats)
        measured = linkprobe.measured_topology(topo, res)
        print(f"probed links ({res.source}): {topo.fingerprint()} -> "
              f"{measured.fingerprint()}")
        topo = measured
    kw = dict(repeats=repeats, substrate=substrate, force_model=force_model)
    t0 = time.perf_counter()
    table = (None if full else tuner.load_table(tuner.substrate_fingerprint(
        topo, substrate=substrate, force_model=force_model)))
    # a table without the sections autotune writes beside the dense
    # collectives (``ensure_table``'s, dense only) is tuned afresh
    sections = {tuner.NEIGHBOR, tuner.PARTITIONED, tuner.OVERLAP,
                tuner.TRANSPORT}
    if table is None or not sections <= set(table.entries):
        table = tuner.autotune(topo, **kw)
        print(f"autotuned {table.fingerprint} ({table.source}) in "
              f"{time.perf_counter() - t0:.2f} s: {sorted(table.entries)}")
    else:
        healed = tuner.heal_table(table, topo, **kw)
        print(f"reused {table.fingerprint} ({table.source}, generation "
              f"{table.generation}): {len(healed)} cell(s) repaired")
    for v in table.violations:
        print(f"  guideline violation: {v}")
    return topo, table


def heal_heartbeat(daemon, engine, interval_s: float, group=None):
    """The drift-healing heartbeat (the counterpart of the reference's
    ``heal_daemons``), as a ``run_workload`` ``on_step`` hook: between
    engine ticks, once ``interval_s`` seconds have passed, the daemon
    re-probes the wire and heals its table, and the engine builds its
    next plans on the daemon's topology.  It runs on the serving
    thread, so its probes never overlap the engine's exchanges on the
    group, and on a group the "due" flag is agreed with
    ``all_reduce(MAX)``: every rank probes at the same tick."""
    from repro_torch.core import tuner

    last = [time.perf_counter()]

    def on_step(step: int) -> None:
        due = float(time.perf_counter() - last[0] >= interval_s)
        if group is not None:
            due = tuner._agree(due, "dist", group)
        if due:
            daemon.probe_and_heal(step=step)
            engine.topo = daemon.topo
            last[0] = time.perf_counter()
    return on_step


def ep_prefill(args, cfg, params, prompts, device: torch.device):
    """``--ep-transport``: one batched prefill of the prompts with the
    expert-parallel MoE dispatch (experts sharded over every rank of the
    group on the ``model`` axis, each rank routing its slice of the
    tokens), held against the dense-dispatch prefill; the largest
    |logit| difference is printed.  Returns the EP prefill's logits."""
    from repro_torch.launch.mesh import Mesh, ensure_process_group
    from repro_torch.serve.step import make_prefill_step
    from repro_torch.train.moe_dispatch import EPOptions

    if cfg.moe is None:
        raise SystemExit(f"--ep-transport: {cfg.name} has no MoE layers "
                         f"to dispatch")
    import torch.distributed as dist
    created = ensure_process_group(device)
    try:
        mesh = Mesh((1, dist.get_world_size()), ("data", "model"),
                    device_type=device.type)
        opts = ServeOptions(
            ep_options=EPOptions(alltoall=args.ep_alltoall,
                                 transport=args.ep_transport,
                                 policy=args.select_policy),
            resilience=(None if args.resilience == "off"
                        else args.resilience))
        t0 = time.perf_counter()
        got = make_prefill_step(cfg, opts, mesh)(params, prompts)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        want = make_prefill_step(cfg, ServeOptions())(params, prompts)
        err = float((got.float() - want.float()).abs().max())
        print(f"EP prefill ({args.ep_alltoall} on {args.ep_transport}, "
              f"{mesh.shape['model']} rank(s)): {tuple(got.shape)} in "
              f"{dt:.2f}s, max |logit - dense dispatch| {err:.4g}")
    finally:
        if created:
            dist.destroy_process_group()
    return got


def _run_continuous(args, cfg, device: torch.device) -> dict:
    """Continuous batching: drive the engine through a seeded Poisson
    multi-tenant trace; KV blocks move prefill pool -> decode pool via
    ragged neighbor plans on ``--kv-transport`` (``dist``: over the
    ``torchrun`` group, which this creates and ends when none exists).
    ``--heal-interval`` builds the tuner daemon on the engine's topology
    (its probe keys the table), ``--autotune`` tunes that topology, and
    the engine builds its plans on it; the heal count is printed however
    serving ends."""
    from repro_torch.core import api as mpix_api

    mpix_api.set_default_policy(args.select_policy)
    group, created = None, False
    if args.kv_transport == "dist":
        import torch.distributed as dist
        if not dist.is_initialized():
            # torchrun's environment: MASTER_ADDR/PORT, RANK, WORLD_SIZE
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo")
            created = True
        group = dist.group.WORLD
    ecfg = _engine_config(args, cfg, device)
    sub = _substrate(args, device)
    tune_kw = dict(substrate=sub, force_model=sub is None)
    topo, daemon = ecfg.topology(), None
    try:
        if args.heal_interval > 0:
            # the daemon probes the wire and ensures a table keyed by the
            # probed geometry
            from repro_torch.runtime import TuningDaemon
            daemon = TuningDaemon(topo, **tune_kw)
            topo = daemon.topo
        if args.autotune or args.autotune_full:
            topo, table = autotune_topology(
                topo, full=args.autotune_full,
                probe=args.probe_links and daemon is None, **tune_kw)
            if daemon is not None:
                daemon.table = table    # heal what the engine reads
        ecfg = dataclasses.replace(ecfg, topo=topo)
        metrics = _drive_engine(args, ecfg, device, group, daemon)
    finally:
        if daemon is not None:
            healed = sum(1 for r in daemon.reports if r.healed)
            print(f"tuner daemon: {len(daemon.reports)} probe pass(es), "
                  f"{healed} heal(s) on {daemon.topo.fingerprint()}")
        if created:
            dist.destroy_process_group()
    return metrics


def _engine_config(args, cfg, device: torch.device):
    from repro_torch.serve.engine import EngineConfig

    resilience = None
    if args.resilience != "off":
        # lead the ladder with the requested substrate; then the host
        # rungs, which run whatever the card does
        lead = args.kv_transport if args.kv_transport != "reference" \
            else "sim"
        ladder = tuple(dict.fromkeys((lead, "sim", "reference")))
        resilience = {"verify": args.resilience, "ladder": ladder,
                      "backoff_s": 1e-4}
    return EngineConfig(
        blocks_per_rank=args.kv_blocks,
        block_feat=(getattr(cfg, "head_dim", None) or 16),
        transport=args.kv_transport, policy=args.select_policy,
        resilience=resilience, device=str(device))


def _drive_engine(args, ecfg, device: torch.device, group,
                  daemon=None) -> dict:
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.traffic import poisson_workload, run_workload

    engine = ContinuousBatchingEngine(ecfg, group=group)
    trace = poisson_workload(args.seed, arrival_rate=args.arrival_rate,
                             tenants=args.tenants,
                             n_requests=args.requests,
                             max_prompt=args.kv_blocks
                             * ecfg.block_tokens // 2)
    on_step = (None if daemon is None else
               heal_heartbeat(daemon, engine, args.heal_interval, group))
    t0 = time.perf_counter()
    metrics = run_workload(engine, trace, on_step=on_step)
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
                           "large-398b: one period, experts 0-7 of 16; "
                           "deepseek-v3-671b: layers 0-3, experts 0-7 of "
                           "256)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs every "
                         "kernel's plain version)")
    ap.add_argument("--select-policy", default="model",
                    choices=["fixed", "model", "tuned"],
                    help="selection policy for algorithm='auto' "
                         "collectives and the KV plans' standard-vs-"
                         "locality-aware mode (tuned reads the persisted "
                         "tuner table; see repro_torch.core.tuner)")
    ap.add_argument("--autotune", action="store_true",
                    help="continuous mode: tune the engine's topology on "
                         "the --kv-transport substrate before serving "
                         "(persists winners for --select-policy tuned); "
                         "an existing table is healed in place — only "
                         "guideline-violating cells are re-measured")
    ap.add_argument("--autotune-full", action="store_true",
                    help="ignore any persisted table and re-measure "
                         "everything from scratch (implies --autotune)")
    ap.add_argument("--probe-links", action="store_true",
                    help="probe per-level link models before tuning; "
                         "tables key on probed geometry (lm[] "
                         "fingerprints) and the engine plans on it")
    ap.add_argument("--heal-interval", type=float, default=0.0,
                    help="run the drift-healing tuner daemon between "
                         "engine ticks every N seconds while serving "
                         "(0 = off; --kv-transport dist only); heals are "
                         "scoped to drifted cells and the engine plans "
                         "on the healed topology")
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
    ap.add_argument("--ep-alltoall", default="xla",
                    help="mpix algorithm of the expert-parallel prefill "
                         "dispatch (used with --ep-transport)")
    ap.add_argument("--ep-transport", default=None,
                    choices=["dist", "kernel", "auto"],
                    help="run one batched prefill of the prompts with the "
                         "expert-parallel MoE dispatch on this substrate, "
                         "experts sharded over every rank of the group "
                         "(torchrun's, or this process alone), beside the "
                         "dense-dispatch prefill: one exchange per round "
                         "(dist), the whole schedule as one launch of the "
                         "transport kernel (kernel), or the tuner's "
                         "per-size choice (auto)")
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
    ap.add_argument("--mesh", default=None,
                    choices=["local", "single", "multi"],
                    help="decode on a mesh of ranks (mesh_decode_step): "
                         "local = every rank of the group on the data "
                         "axis (torchrun's group, or this process "
                         "alone); single / multi = the 16x16 / 2x16x16 "
                         "production meshes (256 / 512 ranks). Each rank "
                         "stores its share of the weights and cache and "
                         "decodes its rows (--batch must divide)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="--mesh local: ranks on the model axis (their "
                         "parameter blocks stay where they are stored)")
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
    if args.mesh is not None and (args.continuous
                                  or args.ep_transport is not None):
        ap.error("--mesh drives the single-shot decode; it does not "
                 "combine with --continuous or --ep-transport")
    if args.resilience != "off" and not args.continuous \
            and args.ep_transport is None:
        # resilience threads through the KV transfer collectives and the
        # EP dispatch only; without them it would silently protect nothing
        raise SystemExit(
            f"--resilience {args.resilience} has nothing to protect: "
            f"the single-shot decode path runs no mpix collectives. "
            f"Arm a protected path with --ep-transport dist|kernel|auto "
            f"(EP prefill dispatch) or --continuous (KV-cache "
            f"transfers), or drop --resilience.")
    tuning = [f for f, on in (
        ("--autotune", args.autotune), ("--autotune-full", args.autotune_full),
        ("--probe-links", args.probe_links),
        (f"--heal-interval {args.heal_interval}", args.heal_interval > 0))
        if on]
    if tuning and not args.continuous:
        # the tuner's tables are read by the KV transfer plans only
        raise SystemExit(
            f"{' '.join(tuning)} has nothing to tune: the single-shot "
            f"decode path runs no mpix collectives. Tune the KV-cache "
            f"transfers with --continuous, or drop {tuning[0]}.")
    if args.probe_links and not (args.autotune or args.autotune_full):
        ap.error("--probe-links keys the tables --autotune writes; pass "
                 "--autotune with it")
    if args.heal_interval < 0:
        ap.error(f"--heal-interval must be >= 0 (got {args.heal_interval})")
    if args.heal_interval > 0 and args.kv_transport != "dist":
        # off a group the probe prices the links with the model, which
        # never drifts: the daemon could never heal
        raise SystemExit(
            f"--heal-interval with --kv-transport {args.kv_transport}: "
            f"nothing can drift. The daemon heals what its link probe "
            f"measures on the wire, and only a group of ranks has one "
            f"(--kv-transport dist under torchrun); elsewhere the probe "
            f"prices with the model. Re-tune between runs with --autotune "
            f"instead.")
    device = local_device(args.device)

    try:
        cfg = (configs.get_smoke(args.arch) if args.smoke
               else configs.get_one_card(args.arch) if args.one_card
               else configs.get_config(args.arch))
    except KeyError as e:
        ap.error(e.args[0])
    if args.continuous:
        return _run_continuous(args, cfg, device)
    if args.mesh is not None:
        return mesh_generate(args, cfg, device)
    params, prompts, cross = _inputs(args, cfg, device)
    if args.ep_transport is not None:
        ep_prefill(args, cfg, params, prompts, device)

    t0 = time.perf_counter()
    out, _ = generate(params, cfg, prompts, args.gen, cross_src=cross)
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
