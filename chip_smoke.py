"""Drive the PyTorch/CUDA port's collective and serving paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. build   — compile ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a
             into ``build/repro_torch/`` (one nvcc per source, in
             parallel) and print the build time;
2. parity  — every REGISTRY schedule on four topologies, random floats,
             at slots [4, 33] (bf16 rows, and every row at chunks=2,
             are no whole 16 B: the ragged path), [4, 64] (the aligned
             TMA path) and [2, 65536] (more column tiles than the
             persistent grid has CTAs): the transport kernel bitwise
             against its plain PyTorch version (f32, bf16) and, at the
             two small shapes, against the numpy oracle
             ``run_reference`` (f32); chunks=2 bit-identical; one launch
             per run; every copy-only schedule also forced onto the
             gather body, bitwise.  Then both flash-attention kernels
             against their plain version on random floats: head_dim
             64/128/256, GQA groups 1/2/8, causal, window and softcap
             alone and together, non-causal, f32 and bf16, head dims
             padded to 128 and 256 (the gather kernel with a random
             permutation and 1/8 of the rows at -1, which must come out
             exact zeros), each call's body (Hopper wgmma or CUDA
             cores) counted and required: wgmma for every aligned bf16
             call;
3. main    — launch counters reset, then the collective path once at
             sizes users run: Topology -> selector -> builder ->
             executor -> ``KernelTransport.run_global`` for a 25 MiB-
             per-rank gradient allreduce on 8 and 16 ranks and a MoE
             alltoall dispatch (each printed with the transport kernel's
             tile, buffers, CTAs per SM, grid and path, which must be
             the aligned TMA path), and the fused ``rmsnorm_allreduce`` /
             plain ``rmsnorm`` ops at qwen3-14b and gemma2-2b widths;
             counters read (every rmsnorm launch on the vector body,
             each case printed with its tiling); every output checked
             against its plain version and the collective's meaning;
3n. neighbor — random neighbor graphs on Topology(8,8), (8,4), (16,4)
             and (12,3), both plan modes, f32 and bf16 with negative
             zeros, slots [2, 64] and [3, 7]: ``KernelTransport.run_global``
             bitwise equal to ``SimTransport.run`` (on the raw bits: the
             plans only copy) and to the plain version; every body of the
             transport kernel that can hold each plan (shared where it
             fits, global, gather) forced on it and equal; one KV plan
             over 1,700 rows on the gather body;
3k. kv     — the continuous-batching engine at a real size: 8 ranks in
             two pods of 4, 1024 blocks a rank of 16 tokens x 2048
             floats (gemma2-2b's K and V of one layer, f32: a 1.07 GB
             pool on the card), the Poisson trace of 40 requests (seed
             0, rate 6.0, 3 tenants, mean prompt 2048) on the kernel
             transport: counters reset, the trace run, counters read (one
             launch per batch; the gather body on every batch too tall
             for shared memory; every batch verified bitwise by the
             engine); the transfer log, metrics and final pool equal to
             the same engine on the numpy transport; each batch replayed
             (host ms from cold caches, kernel ms beside its bound and
             the ``g.clone()`` copy floor); the largest batch's composed
             row map held against ``SimTransport`` on row ids, the batch
             timed against its plain version, ``index_select`` of its
             row map and ``g.clone()``, and the round-by-round global
             body forced on it (the gather and global bodies' rows of
             the kernels line);
3r. resilience — the recovery ladder (``core.resilient``) on
             ``KernelTransport`` with the ladder kernel -> sim ->
             reference: the main path's three collectives at their sizes
             under ``verify`` off / canary (and full for the flat-8
             allreduce): one launch, recovered on the kernel rung,
             undegraded, bitwise ``run_global``; host ms of each beside
             the kernel ms and ``tuner.verify_overhead_s``'s modeled
             figure (a model, not a card time); seeded campaigns
             (corrupt nan / bitflip, fail, hang with a deadline, mixed;
             seeds 0-4) with the kernel rung chaos-wrapped, verify full,
             on a flat-8 allreduce of 1 MiB a rank: every result bitwise
             the numpy oracle, every report equal to the same plan's on
             the CPU with the sim rung wrapped; the canary row bitwise
             through every body that holds a canary'd plan (shared,
             global, gather); a persistent fail walking to sim, bitwise;
             phase (k)'s KV trace with ``FaultPlan(0, "corrupt",
             times=1, mode="nan")`` round the kernel rung under verify
             canary: 40/40 served, every batch bitwise, the transfer log
             equal to phase (k)'s, the degraded batches and their rung
             printed, then each batch replayed for the host ms of its
             checks;
3p. partitioned — ``partitioned_schedule(8, shift by one, P)`` for P in
             1, 2, 4, 8 through ``KernelTransport.run_global`` at 25 MiB
             f32 a rank: bitwise ``SimTransport.run`` and the monolithic
             shift, bit-identical across P, one launch each (body
             printed), ms beside the bound and ``g.clone()``;
3t. tuning — the tuner on the card, with a temporary table cache: (a)
             counters reset, ``tune(flat_topology(8))`` and ``tune(Topology(8,
             4))`` at ``DEFAULT_SIZES`` on the ``kernel`` substrate (source
             measured, the fingerprint naming the card, one transport-kernel
             launch a call: warm-up + 3 repeats of every candidate of every
             cell, the guideline findings recorded), each cell's measured
             ms printed beside the model's, the winners unlike the model's
             counted, each winner bitwise ``SimTransport.run`` on random
             floats with negative zeros (at its cell's size up to 1 MiB a
             rank); each table tuned once more, and twice at
             ``STABLE_REPEATS`` repeats, counting the cells whose winner
             agrees across the two runs and each cell's runner-up over its
             best; (b) ``tune_neighbor`` on the KV engine's topology, then
             phase (k)'s trace with ``policy="tuned"``: 40/40, every batch
             bitwise, one launch a batch, and each batch's host ms from
             cold caches under the tuned and the model policy; (c)
             ``measure_schedule(deadline_s=1e-6)`` raises
             ``MeasurementTimeout``; (d) a ``TuningDaemon`` (model-timed,
             ``LinkFault`` DCN beta x16) heals only the affected cells and
             the healed topology's allreduce runs one launch, bitwise; (e)
             the launcher with ``--autotune --select-policy tuned`` in a
             subprocess serves every request;
3c. launcher — ``python -m repro_torch.launch.serve --arch gemma2-2b
             --continuous --kv-transport kernel`` in a subprocess: exit 0,
             every request served;
4. serve   — gemma2-2b at full width (26 layers, random weights from a
             seeded generator on the card): (a) counters reset, the
             kernel prefill of one 8192-token prompt, counters read (26
             flash launches, all on the wgmma body), each layer's kernel
             output checked against the plain ``core_attention`` on the
             same q/k/v and the logits against the plain prefill, then
             the prefill timed alone (CUDA events, median of 3); (b) the launcher's
             loop at batch 4, prompt 32, gen 16, in bf16 (reported,
             beside the plain prefill as the control) and with the same
             weights widened to f32, where the teacher-forced decode
             logits must match the kernel prefill's at the reference's
             model tolerance.  Then the dispatch-gather op
             ``flash_attention(q_rows=...)`` at a gemma2 layer's shape
             (one launch, on the wgmma body);
5. rwkv    — the wkv6 kernel against its plain version on random floats
             (the reference's sweep shapes, head size 64 at 40 heads, a T
             that is no multiple of 64; f32, bf16 and the model's mix of
             bf16 r/k/v with f32 w), the chunk-parallel scan's edges (T
             below, at and one past a chunk, a multiple of it, 200 and
             8192, head size 128, B = 2) and decay extremes (exact 0s
             and 1s, whole chunks of zero decay), then rwkv6-3b at full
             width and depth (32 layers, random bf16 weights from a
             seeded generator on the card): (a) counters reset, the
             kernel prefill of one 8192-token prompt, counters read (32
             wkv6 calls, each printed with its chunking), each layer's
             kernel output checked against ``wkv6_plain`` on the same
             inputs, the prefill timed alone (CUDA events, median of 3)
             and the logits reported against the plain prefill; (b) the
             launcher's loop at batch
             4, prompt 32, gen 16 on the O(1) decode state, in bf16
             (reported) and with the weights widened to f32 (held to the
             model tolerance against the kernel prefill);
6. jamba   — the selective-scan kernel against its plain version on
             random floats (the reference's sweep shapes, T that are no
             multiple of 64, T of 1 and either side of the 32-step tile,
             Di tails, S of 4, 8 and 16; f32, bf16 and the f32 model's
             mix of bf16 dt with f32 xc/B/C; strided views on the
             plain-load path; dt A of -90, flushed to zero) and its
             CPU twin (bit for bit with A = 0), then the
             earlier models freed and jamba-1.5-large-398b's one-card cut (one
             period of 8 layers at full width, experts 0-7 of 16, random
             bf16 weights from a seeded generator on the card): (a)
             counters reset, the kernel prefill of one 8192-token
             prompt, counters read (7 mamba_scan and 1 flash launches,
             the flash one on the wgmma body), the prefill timed alone,
             each mamba layer's kernel output checked against
             ``selective_scan_plain`` on the same inputs, the largest
             |residual| after each layer printed and the logits reported
             against the plain prefill; (b) the launcher's loop at batch
             4, prompt 32, gen 16 in bf16 (reported; the capacity
             dispatch drops pairs there); (c) layers 0-4 with the same
             weights widened to f32 at batch 1, where the teacher-forced
             decode logits must match the kernel prefill's at the
             reference's model tolerance;
7. timing  — per case, the kernel, its plain version and a library
             call: CUDA events around 20 calls enqueued back to back,
             divided by 20, median of 5 such batches (after warm-up;
             fewer for calls over 100 ms, stated in the line); the
             kernel's own device time per call read by name from
             ``torch.profiler`` (summed over the call's kernels: wkv6's
             phases, each printed); for rmsnorm the host us per call
             (200 calls enqueued without a synchronize); wkv6's chunk,
             grids, scratch bytes and share of the prefill; beside the
             bound (bytes at 3.35 TB/s,
             or operations at 67 TFLOP/s f32 / 989 TFLOP/s bf16 tensor
             cores for attention / the exps of the scan at 16 per clock
             per SM on the special-function units, at the card's top SM
             clock); for attention also the TFLOP/s, the share of the
             bound and the k/v bytes the body's tiling reads (from L2
             or device memory: each CTA reads its visited kv tiles).

The last two lines of standard output are the kernels JSON object and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository around it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores
BF16_TC_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
REPS = 20                        # calls per timed batch
BATCHES = 5
LONG_CALL_MS = 100.0             # calls longer than this get fewer reps
LONG_REPS, LONG_BATCHES = 3, 3
MIB = 1 << 20
ROOT = Path(__file__).resolve().parent


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import cuda

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cuda.library()
    built = ("reused" if cuda.BUILD_SECONDS is None
             else f"nvcc {cuda.BUILD_SECONDS:.2f} s")
    print(f"build: {time.perf_counter() - t0:.2f} s ({built}; "
          f"{', '.join(s.name for s in cuda.sources())} -> "
          f"{os.path.relpath(cuda.library_path(), ROOT)})", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    parity(torch, dev)
    neighbor_parity(torch, dev)
    attn_err = attention_parity(torch, dev)
    wkv_err = wkv6_parity(torch, dev)
    cases = main_path(torch, dev)
    kvrun = kv_path(torch, dev)
    gather_row, global_row = gather_body_timing(torch, kvrun)
    kv_log, kv_batches = kvrun["log"], kvrun["batches"]
    del kvrun
    torch.cuda.empty_cache()
    resilience(torch, dev, cases, kv_log, kv_batches)
    partitioned(torch, dev)
    torch.cuda.empty_cache()
    tuned = tuning(torch, dev, kv_batches)
    torch.cuda.empty_cache()
    launcher_continuous(torch)
    served = serve_path(torch, dev)
    gathered = gather_path(torch, dev, served)
    rwkv_served = rwkv_serve_path(torch, dev)
    scan_err = mamba_scan_parity(torch, dev)
    jamba_served = jamba_serve_path(torch, dev)
    # the kernels timed last are profiled before anything else is timed:
    # profiled after the long plain versions, their traces held no
    # device records (see device_ms)
    early = early_device_ms(torch, rwkv_served, jamba_served)
    kernels = timing(torch, cases)
    transport = next(k for k in kernels if k["name"] == "schedule_exec")
    transport["gather_body"] = gather_row
    transport["global_body"] = global_row
    # phase (t) counted apart: its launches time the tuner's candidates,
    # they are not the main path's
    transport["tuning_launches"] = tuned["launches"]
    transport["tuning"] = tuned
    kernels += attention_timing(torch, served, gathered, attn_err)
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    flash["cases"].append(jamba_attention_timing(torch, jamba_served,
                                                 early["jamba_attention"]))
    kernels += wkv6_timing(torch, rwkv_served, wkv_err, early["wkv6"],
                           early["wkv6_split"])
    kernels += mamba_scan_timing(torch, jamba_served, scan_err,
                                 early["mamba_scan"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


PARITY_SLOTS = [
    # (per-rank slot shape, what it exercises, checked against the oracle)
    ((4, 33), "ragged path in bf16 and at chunks=2", True),
    ((4, 64), "aligned TMA path", True),
    ((2, 1 << 16), "aligned, more column tiles than CTAs", False),
]


def parity(torch, dev) -> None:
    from repro_torch.core.algorithms import REGISTRY
    from repro_torch.core.kernel_lowering import (get_kernel_exec,
                                                  schedule_exec_plain)
    from repro_torch.core.schedule import NotApplicable
    from repro_torch.core.topology import (Topology, flat_topology,
                                           torus_topology)
    from repro_torch.core.transport import SimTransport

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for slot, what, oracle in PARITY_SLOTS:
        t0 = time.perf_counter()
        checked = 0
        paths = set()
        for topo in (flat_topology(8), Topology(8, 4),
                     torus_topology(2, 2, 2), torus_topology(2, 4, 2)):
            n = topo.nranks
            for coll, algos in REGISTRY.items():
                for name, builder in algos.items():
                    try:
                        sched = builder(topo)
                    except NotApplicable:
                        continue
                    label = f"{topo.fingerprint()} {coll}.{name} {slot}"
                    shape = (n, sched.num_slots) + slot
                    if oracle:
                        buf = rng.standard_normal(shape).astype(np.float32)
                        buf.reshape(-1)[::7] = -0.0
                        want = SimTransport(n).run_reference(sched, buf)
                        buf = torch.from_numpy(buf).to(dev)
                    else:            # large: drawn on the card, no oracle
                        buf = torch.randn(shape, generator=gen, device=dev)
                        buf.view(-1)[::7] = -0.0
                        want = None
                    kex = get_kernel_exec(sched, topo=topo)
                    for dtype, itype in ((torch.float32, torch.int32),
                                         (torch.bfloat16, torch.int16)):
                        g = buf.to(dtype)
                        before = kex.launches
                        got = kex.run(g)
                        torch.cuda.synchronize()
                        _require(kex.launches == before + 1,
                                 f"{label}: not one launch per run")
                        paths.add(kex.last_launch["path"])
                        plain = schedule_exec_plain(kex.ex, g)
                        _require(torch.equal(got.view(itype),
                                             plain.view(itype)),
                                 f"{label} {dtype}: kernel != plain version")
                        _require(torch.equal(kex.run(g, chunks=2).view(itype),
                                             got.view(itype)),
                                 f"{label} {dtype}: chunks=2 not "
                                 f"bit-identical")
                        if kex.tables["copy_only"]:
                            forced = kex.run(g, _body="gather")
                            torch.cuda.synchronize()
                            paths.add(f"gather {kex.last_launch['path']}")
                            _require(torch.equal(forced.view(itype),
                                                 got.view(itype)),
                                     f"{label} {dtype}: the gather body "
                                     f"differs")
                        if want is not None and dtype == torch.float32:
                            _require(got.cpu().numpy().tobytes()
                                     == want.tobytes(),
                                     f"{label}: kernel != run_reference")
                    checked += 1
        torch.cuda.synchronize()
        print(f"parity: slots {list(slot)} ({what}, ran {sorted(paths)}): "
              f"{checked} schedules x (f32, bf16) bitwise"
              f"{', f32 = run_reference' if oracle else ''}, "
              f"{time.perf_counter() - t0:.2f} s", flush=True)


# ---------------------------------------------------------------------------
# the main path, at the sizes users run
# ---------------------------------------------------------------------------


TRANSPORT_CASES = [
    # (label, topology builder args, collective, expected fixed choice,
    #  per-rank slot shape, dtype name)
    ("allreduce 25 MiB/rank f32, flat 8 (DDP bucket)", ("flat", 8),
     "allreduce", "ring_rs_ag", None, "float32"),
    ("allreduce 25 MiB/rank f32, torus(2,4,2) 16 ranks", ("torus", 2, 4, 2),
     "allreduce", "staged", None, "float32"),
    ("alltoall MoE dispatch 8x[512,2048] bf16/rank, flat 8", ("flat", 8),
     "alltoall", "pairwise", (512, 2048), "bfloat16"),
]
RMSNORM_REDUCE_CASES = [
    ("qwen3-14b TP8 parts [8,4096,5120] bf16", (8, 4096, 5120), False),
    ("gemma2-2b TP8 parts [8,4096,2304] bf16 gemma", (8, 4096, 2304), True),
]
RMSNORM_CASES = [("qwen3-14b x [4096,5120] bf16", (4096, 5120), False)]


def _topology(spec):
    from repro_torch.core.topology import flat_topology, torus_topology
    return flat_topology(spec[1]) if spec[0] == "flat" else \
        torus_topology(*spec[1:])


def main_path(torch, dev) -> list[dict]:
    from repro_torch import cuda
    from repro_torch.core import selector
    from repro_torch.core.algorithms import REGISTRY
    from repro_torch.core.kernel_lowering import get_kernel_exec
    from repro_torch.core.transport import KernelTransport
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_body

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cases = []
    for label, tspec, coll, expect, slot, dtname in TRANSPORT_CASES:
        topo = _topology(tspec)
        n = topo.nranks
        dtype = dtypes[dtname]
        if coll == "allreduce":       # one rank's 25 MiB bucket, [n, chunk]
            per_rank = 25 * MIB // 4
            slot = (per_rank // n,)
        nbytes = math.prod(slot) * n * torch.finfo(dtype).bits // 8
        algo = selector.select(coll, topo, nbytes, policy="fixed")
        _require(algo == expect, f"{label}: selector chose {algo}")
        sched = REGISTRY[coll][algo](topo)
        # rank r's n blocks; schedules with a separate receive region
        # (pairwise alltoall) get it zeroed, as the mpix_* API pads
        gbuf = torch.zeros((n, sched.num_slots) + slot, device=dev,
                           dtype=dtype)
        gbuf[:, :n] = torch.randn((n, n) + slot, generator=gen, device=dev,
                                  dtype=dtype)
        transport = KernelTransport(n, topo=topo)
        cases.append({"kernel": "schedule_exec", "label": label,
                      "topo": topo, "sched": sched, "coll": coll,
                      "args": (gbuf,),
                      "call": functools.partial(transport.run_global, sched)})
    for label, shape, gemma in RMSNORM_REDUCE_CASES:
        parts = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.bfloat16)
        # gemma-style checkpoints store the scale as an offset from 1
        scale = ((0.0 if gemma else 1.0)
                 + 0.1 * torch.randn(shape[-1], generator=gen, device=dev)
                 ).to(torch.bfloat16)
        cases.append({"kernel": "rmsnorm_reduce", "label": label,
                      "gemma": gemma, "args": (parts, scale),
                      "call": functools.partial(_fused, ops, gemma)})
    for label, shape, gemma in RMSNORM_CASES:
        x = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        scale = (1.0 + 0.1 * torch.randn(shape[-1], generator=gen,
                                         device=dev)).to(torch.bfloat16)
        cases.append({"kernel": "rmsnorm", "label": label, "gemma": gemma,
                      "args": (x, scale),
                      "call": functools.partial(_norm, ops, gemma)})
    torch.cuda.synchronize()

    cuda.reset_launches()
    t0 = time.perf_counter()
    for c in cases:
        c["out"] = c["call"](*c["args"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    print(f"main path: {len(cases)} calls in {wall * 1e3:.3f} ms "
          f"(host clock), launches {launches}", flush=True)
    for name in ("schedule_exec", "rmsnorm_reduce", "rmsnorm"):
        _require(launches[name] > 0, f"main path never launched {name}")
    bodies = dict(cuda.RMSNORM_BODIES)
    print(f"main path: rmsnorm launches by body {bodies}", flush=True)
    _require(bodies == {"vector": launches["rmsnorm"]
                        + launches["rmsnorm_reduce"], "scalar": 0},
             "a main-path rmsnorm call did not take the vector body")
    _require(launches["schedule_exec"] == len(TRANSPORT_CASES),
             "transport: not one launch per run")
    for c in cases:
        c["launches"] = launches[c["kernel"]]
        if c["kernel"] == "schedule_exec":
            run = get_kernel_exec(c["sched"], topo=c["topo"]).last_launch
            c["launch"] = run
            print(f"transport | {c['label']}: tile {run['tile']} columns, "
                  f"{run['buffers']} buffers, {run['ctas_per_sm']} CTAs/SM, "
                  f"grid {run['grid']}, path {run['path']}, rows loaded "
                  f"{run['rows_loaded']} of {run['rows']}, {run['copies']} "
                  f"TMA boxes an item, design floor {run['floor_bytes']} B",
                  flush=True)
            _require(run["path"] == "aligned TMA",
                     f"{c['label']}: took the {run['path']} path")
        else:
            x = c["args"][0]
            out = c["out"]
            c["body"] = rmsnorm_body(x.shape[-1], x.dtype,
                                     (x.data_ptr() | out.data_ptr()) % 16)
            print(f"rmsnorm | {c['label']}: {c['body'][0]} body, "
                  f"{c['body'][1]} 16-byte vectors a thread, "
                  f"{c['body'][2]} threads a CTA", flush=True)
            _require(c["body"][0] == "vector",
                     f"{c['label']}: would take the {c['body'][0]} body")
        check_output(torch, c)
    return cases


def _fused(ops, gemma, parts, scale):
    return ops.rmsnorm_allreduce(parts, scale, 1e-6, gemma)


def _norm(ops, gemma, x, scale):
    return ops.rmsnorm(x, scale, 1e-6, gemma)


def check_output(torch, c) -> None:
    """Output against the plain version on the same inputs, plus what
    the collective means."""
    from repro_torch.core.kernel_lowering import (get_kernel_exec,
                                                  schedule_exec_plain)
    from repro_torch.kernels.rmsnorm.kernel import (rmsnorm_plain,
                                                    rmsnorm_reduce_plain)
    out = c["out"]
    _require(bool(torch.isfinite(out).all()), f"{c['label']}: non-finite")
    if c["kernel"] == "schedule_exec":
        gbuf = c["args"][0]
        _require(out.shape == gbuf.shape, f"{c['label']}: shape")
        ex = get_kernel_exec(c["sched"], topo=c["topo"]).ex
        plain = schedule_exec_plain(ex, gbuf)
        c["plain_fn"] = lambda g, ex=ex: schedule_exec_plain(ex, g)
        itype = torch.int32 if out.dtype == torch.float32 else torch.int16
        _require(torch.equal(out.view(itype), plain.view(itype)),
                 f"{c['label']}: kernel != plain version")
        c["max_abs_err"] = 0.0
        if c["coll"] == "allreduce":   # every rank holds the sum
            want = gbuf.sum(0, keepdim=True)
            err = (out - want).abs().max().item()
            scale = gbuf.abs().sum(0).max().item()
            _require(err <= 1e-5 * scale, f"{c['label']}: sum off by {err}")
        else:                          # alltoall: out[r][s] = in[s][r]
            n, sched = gbuf.shape[0], c["sched"]
            _require(sched.result_slots == n and sched.out_offsets is None,
                     f"{c['label']}: expected the result in slots [0, n)")
            _require(torch.equal(out[:, :n], gbuf[:, :n].transpose(0, 1)),
                     f"{c['label']}: not a transpose of the blocks")
        return
    if c["kernel"] == "rmsnorm_reduce":
        parts, scale = c["args"]
        plain = rmsnorm_reduce_plain(parts, scale, gemma_style=c["gemma"])
        c["plain_fn"] = lambda p, s, gm=c["gemma"]: rmsnorm_reduce_plain(
            p, s, gemma_style=gm)
    else:
        x, scale = c["args"]
        plain = rmsnorm_plain(x, scale, gemma_style=c["gemma"])
        c["plain_fn"] = lambda a, s, gm=c["gemma"]: rmsnorm_plain(
            a, s, gemma_style=gm)
    _require(out.shape == plain.shape, f"{c['label']}: shape")
    diff = (out.float() - plain.float()).abs()
    ulp = torch.where(plain == 0, torch.full_like(diff, 2.0 ** -133),
                      2.0 ** (torch.floor(torch.log2(plain.float().abs()))
                              - 7))
    # bf16 tolerance: one ulp of the plain result (another reduction
    # order of the f32 mean)
    _require(bool((diff <= ulp).all()),
             f"{c['label']}: more than 1 bf16 ulp from the plain version")
    c["max_abs_err"] = diff.max().item()


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, *args, reps=REPS, batches=BATCHES) -> float:
    """Milliseconds per call: CUDA events around ``reps`` calls enqueued
    back to back, divided by ``reps``; the median over ``batches``
    batches.  The host enqueues ahead of the device, so a call's
    dispatch hides behind the kernels before it unless the call is bound
    by the host."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args)
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


HOST_CALLS = 200


def host_us(torch, fn, *args, calls=HOST_CALLS) -> float:
    """Host microseconds per call: the wall time to enqueue ``calls``
    calls back to back without a synchronize, divided by ``calls`` (after
    warm-up and a synchronize).  Below the device time per call, the
    host keeps ahead of the card; above it, the call is bound by its
    host path."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def time_long_ms(torch, fn, *args) -> tuple[float, str]:
    """``time_ms`` with REPS x BATCHES, or LONG_REPS x LONG_BATCHES when
    one call takes longer than LONG_CALL_MS; returns (ms, the reps
    used)."""
    fn(*args)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn(*args)
    b.record()
    b.synchronize()
    if a.elapsed_time(b) > LONG_CALL_MS:
        return (time_ms(torch, fn, *args, reps=LONG_REPS,
                        batches=LONG_BATCHES),
                f"{LONG_REPS} calls x {LONG_BATCHES} batches")
    return time_ms(torch, fn, *args), f"{REPS} calls x {BATCHES} batches"


TRACE_TRIES = 3
KERNEL_SYMBOLS = {"schedule_exec": "schedule_exec_kernel",
                  "schedule_exec_global": "schedule_exec_global_kernel",
                  "schedule_exec_gather": "schedule_exec_gather_kernel",
                  # either body: rmsnorm_vec_kernel (16-byte vectors, rows
                  # in registers) or rmsnorm_rows_kernel (scalar)
                  "rmsnorm_reduce": "rmsnorm_",
                  "rmsnorm": "rmsnorm_",
                  # either body: flash_attention_wgmma_kernel (bf16,
                  # Hopper) or flash_attention_kernel (CUDA cores)
                  "flash_attention": "flash_attention_",
                  "flash_attention_gather": "flash_attention_",
                  # its phases: wkv6_state_kernel, wkv6_carry_kernel,
                  # wkv6_out_kernel (one call runs one to three)
                  "wkv6": "wkv6_", "mamba_scan": "mamba_scan_kernel"}


def device_ms(torch, kernel: str, fn, *args, reps=REPS,
              split: dict | None = None) -> float | None:
    """The kernel's own device time per call, read by its symbol from a
    ``torch.profiler`` trace of ``reps`` calls: for each kernel whose
    symbol matches, its device time over the launches the trace
    recorded, summed over those kernels (a call runs each of them once:
    wkv6 runs up to three phases).  ``split``, when given, receives each
    matched kernel's device ms per launch by name.  None when the trace
    holds no device time for it.  On the card, traces taken late in this
    script, after a plain recurrence (about 10^5 small launches a call)
    or jamba's plain attention had been timed, held the launches' host
    records but only some or none of their device records, so the time
    is taken over the records present; the kernels timed last are
    profiled before those timings (``early_device_ms``), and a trace
    with no device record of the kernel at all is taken again, up to
    ``TRACE_TRIES`` traces (on the card, one to three of a run's traces
    came back so, at no fixed place in the script)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        ms, found = 0.0, {}
        rows = prof.key_averages()
        for e in rows:
            if KERNEL_SYMBOLS[kernel] in e.key and e.count:
                t = (getattr(e, "device_time_total", None)
                     or getattr(e, "cuda_time_total", 0)) / e.count / 1e3
                ms += t
                name = re.search(r"(\w+_kernel)", e.key)
                found[name.group(1) if name else e.key[:60]] = t
        if ms:
            if split is not None:
                split.update(found)
            return ms
        print(f"device_ms({kernel}): trace {attempt} of {TRACE_TRIES} "
              f"holds no device time for {KERNEL_SYMBOLS[kernel]!r}; its "
              f"{len(rows)} keys: {[(e.key[:60], e.count) for e in rows][:8]}",
              flush=True)
    return None


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _transport_bytes(sched, gbuf) -> int:
    """Bytes the collective must move: each rank's n input blocks read
    once and its ``result_slots`` written once.  A separate receive
    region (pairwise alltoall) is scratch, not input."""
    n = gbuf.shape[0]
    slot = gbuf[0, 0].numel() * gbuf.element_size()
    return n * (n + sched.result_slots) * slot


def _schedule_adds(ex, L: int) -> int:
    """Adds this schedule's reduce rounds perform: live landings x L."""
    return sum(int(r.t_mask.sum()) * L for r in ex._rounds if r.reduce)


def timing(torch, cases) -> list[dict]:
    import torch.nn.functional as F
    from repro_torch.core.kernel_lowering import get_kernel_exec

    rows = []
    for c in cases:
        args = c["args"]
        ms = time_ms(torch, c["call"], *args)
        plain_ms = time_ms(torch, c["plain_fn"], *args)
        extra = {"device_ms": device_ms(torch, c["kernel"], c["call"],
                                        *args)}
        if c["kernel"] == "schedule_exec":
            gbuf = args[0]
            n = gbuf.shape[0]
            nbytes = _transport_bytes(c["sched"], gbuf)
            ex = get_kernel_exec(c["sched"], topo=c["topo"]).ex
            ops = _schedule_adds(ex, gbuf[0, 0].numel())
            if c["coll"] == "allreduce":
                # expand_as returns a view: the call writes one rank's
                # result, 1/n of what the kernel writes
                library = ("gbuf.sum(0, keepdim=True).expand_as(gbuf) "
                           "(writes one rank's result: expand_as is a view)")
                library_ms = time_ms(
                    torch, lambda g: g.sum(0, keepdim=True).expand_as(g),
                    gbuf)
            else:
                library = "gbuf[:, :n].transpose(0, 1).contiguous()"
                library_ms = time_ms(
                    torch, lambda g: g[:, :n].transpose(0, 1).contiguous(),
                    gbuf)
            # a copy of the whole buffer, and the design floor: every row
            # that reaches the output read once, every row written once
            extra["copy_floor_ms"] = time_ms(torch, lambda g: g.clone(),
                                             gbuf)
            extra["floor_ms"] = (c["launch"]["floor_bytes"]
                                 / HBM_BYTES_PER_S * 1e3)
            # the same schedule on the global-memory body, and where it
            # has no reduce round on the gather body, forced
            kex = get_kernel_exec(c["sched"], topo=c["topo"])
            extra["global_body_ms"] = time_ms(
                torch, lambda g: kex.run(g, _body="global"), gbuf)
            if kex.tables["copy_only"]:
                extra["gather_body_ms"] = time_ms(
                    torch, lambda g: kex.run(g, _body="gather"), gbuf)
                extra["gather_body_launch"] = dict(kex.last_launch)
            extra["rounds"] = ex.rounds_after
            extra["launch"] = c["launch"]
        else:
            x, scale = args
            d = x.shape[-1]
            extra["host_us"] = host_us(torch, c["call"], *args)
            extra["body"] = list(c["body"])
            out_bytes = _nbytes(c["out"])
            nbytes = _nbytes(x, scale) + out_bytes
            p = x.shape[0] if c["kernel"] == "rmsnorm_reduce" else 1
            ops = (p - 1 + 4) * (x.numel() // p)
            w = (1.0 + scale.float()) if c["gemma"] else scale.float()
            w = w.to(x.dtype)
            if c["kernel"] == "rmsnorm":
                library = "F.rms_norm"
                library_ms = time_ms(
                    torch, lambda a: F.rms_norm(a, (d,), w, 1e-6), x)
            else:
                # no one library call sums P partials and normalises;
                # the two-call composition is kept beside it
                library, library_ms = None, None
                extra["library_two_calls"] = "F.rms_norm(parts.sum(0))"
                extra["library_two_calls_ms"] = time_ms(
                    torch, lambda a: F.rms_norm(a.sum(0), (d,), w, 1e-6), x)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        row = {"case": c["label"], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "operations": ops,
               "library_ms": library_ms, "library_call": library,
               "max_abs_err": c["max_abs_err"], **extra}
        lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"{c['kernel']:>15} | {c['label']}: {ms:.4f} ms "
              f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
              f"{nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
              f"library {lib} [{library}] {json.dumps(extra)}", flush=True)
        c["row"] = row
    replaces = {
        "schedule_exec": ("src/repro_torch/csrc/schedule_exec.cu",
                          "src/repro/core/pallas_lowering.py:86"),
        "rmsnorm_reduce": ("src/repro_torch/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm/kernel.py:32"),
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:27"),
    }
    for name, (source, tpu) in replaces.items():
        mine = [c for c in cases if c["kernel"] == name]
        first = mine[0]["row"]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": tpu, "launches": mine[0]["launches"],
                     "max_abs_err": max(c["row"]["max_abs_err"]
                                        for c in mine),
                     "ms": first["ms"], "plain_ms": first["plain_ms"],
                     "bound_ms": first["bound_ms"],
                     "bound_by": first["bound_by"],
                     "library_ms": first["library_ms"],
                     "cases": [c["row"] for c in mine]})
    return rows


# ---------------------------------------------------------------------------
# neighbor collectives and the continuous-batching KV path
# ---------------------------------------------------------------------------


NEIGHBOR_TOPOS = [(8, 8), (8, 4), (16, 4), (12, 3)]
NEIGHBOR_SLOTS = [(2, 64), (3, 7)]    # the 16-byte and the scalar path
# the KV case: 8 ranks in two pods of 4 (prefill pod, decode pod),
# vLLM's default block of 16 tokens, each token's K and V of one
# gemma2-2b layer (2 x 4 KV heads x head_dim 256 = 2048 floats,
# arXiv:2408.00118), f32 as the engine keeps it: a 128 KiB block, a
# 1.07 GB pool
KV_CONFIG = dict(prefill_ranks=4, decode_ranks=4, ranks_per_pod=4,
                 blocks_per_rank=1024, block_tokens=16, block_feat=2048)
KV_TRACE = dict(arrival_rate=6.0, tenants=3, n_requests=40,
                mean_prompt=2048, max_prompt=8192)
TALL_ROWS = 1700      # about where the shared body stops fitting (f32)


def _ints(t):
    """A float tensor's raw bits, as integers of its width."""
    import torch
    return t.contiguous().view({4: torch.int32, 2: torch.int16}[
        t.element_size()])


def _np_bits(t):
    """The raw bits as a numpy integer array (for the numpy oracle:
    neighbor plans only copy, so their bits move unchanged)."""
    return _ints(t).cpu().numpy()


def neighbor_parity(torch, dev) -> None:
    """(n) Random neighbor graphs on four topologies, both plan modes,
    f32 and bf16 with negative zeros: ``KernelTransport.run_global``
    bitwise equal to ``SimTransport.run`` (on the raw bits) and to
    ``schedule_exec_plain``; on each plan every body that can hold it
    forced and equal (shared where it fits, global, and gather: the
    plans have no reduce round); then one plan too tall for shared
    memory on the gather body."""
    from repro_torch import cuda
    from repro_torch.core import kvtransfer
    from repro_torch.core.kernel_lowering import (get_kernel_exec,
                                                  schedule_exec_plain)
    from repro_torch.core.plan import CommGraph, build_plan
    from repro_torch.core.topology import Topology
    from repro_torch.core.transport import KernelTransport, SimTransport

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    checked, paths = 0, set()
    both = {True: 0, False: 0}       # runs with the shared body / without

    def check(plan, topo, slot, label):
        """Default pick, then each body forced (the shared one where the
        plan fits it, the gather one where it is copy-only): all bitwise
        equal to the oracle."""
        nonlocal checked
        n = topo.nranks
        kex = get_kernel_exec(plan.schedule, topo=topo)
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.randn((n, plan.buf_rows) + slot, generator=gen,
                            device=dev).to(dtype)
            g.view(-1)[::7] = -0.0
            bits = _np_bits(g)
            want = SimTransport(n, topo=topo).run(plan.schedule, bits)
            got = KernelTransport(n, topo=topo).run_global(plan.schedule, g)
            torch.cuda.synchronize()
            body = kex.last_launch["body"]
            _require(_np_bits(got).tobytes() == want.tobytes(),
                     f"{label} {dtype}: kernel ({body} body) != "
                     f"SimTransport.run")
            plain = schedule_exec_plain(kex.ex, g)
            _require(torch.equal(_ints(got), _ints(plain)),
                     f"{label} {dtype}: kernel != plain version")
            bodies = (("shared",) if body == "shared" else ()) + ("global",) \
                + (("gather",) if kex.tables["copy_only"] else ())
            for b in bodies:
                forced = kex.run(g, _body=b)
                torch.cuda.synchronize()
                paths.add((b, kex.last_launch["path"]))
                _require(_np_bits(forced).tobytes() == want.tobytes(),
                         f"{label} {dtype}: the {b} body differs")
            both["shared" in bodies] += 1
            checked += 1
        return kex

    for n, rpp in NEIGHBOR_TOPOS:
        topo = Topology(n, rpp)
        rng = np.random.default_rng(100 * n + rpp)
        for aggregate in (False, True):
            # the reference test's graph size (every plan fits shared
            # memory, so both bodies run), then a denser one
            for n_local, degree in ((8, 4), (24, 6)):
                graph = CommGraph.random(n, n_local=n_local,
                                         degree=min(n - 1, degree), rng=rng,
                                         dup_frac=0.7)
                plan = build_plan(graph, topo, aggregate=aggregate)
                for slot in NEIGHBOR_SLOTS:
                    check(plan, topo, slot, f"{topo.fingerprint()} "
                          f"{plan.name} n_local {n_local} {list(slot)}")
    # one plan too tall for shared memory: a KV batch of 600 moves over
    # pools of 256 blocks a rank
    topo = Topology(8, 4)
    rng = np.random.default_rng(7)
    moves, used = [], set()
    while len(moves) < 600:
        s, d = int(rng.integers(4)), 4 + int(rng.integers(4))
        row, dr = int(rng.integers(256)), int(rng.integers(256))
        if (d, dr) not in used:
            used.add((d, dr))
            moves.append(kvtransfer.BlockMove(s, row, d, dr))
    tp = kvtransfer.build_transfer_plan(moves, topo, blocks_per_rank=256,
                                        aggregate=True, block_bytes=4096)
    _require(8 * tp.schedule.num_slots > TALL_ROWS, "the tall plan is short")
    before = cuda.TRANSPORT_BODIES["gather"]
    kex = check(tp.plan, topo, (4, 256), f"tall {tp.plan.name} "
                f"{8 * tp.schedule.num_slots} rows")
    _require(kex.last_launch["body"] == "gather"
             and cuda.TRANSPORT_BODIES["gather"] >= before + 4,
             "the tall plan did not take the gather body")
    _require(both[True] >= len(NEIGHBOR_TOPOS) * 2 * 2 * 2,
             "neighbor: a small plan did not fit the shared body")
    print(f"neighbor: {checked} plan x dtype runs bitwise (kernel = "
          f"SimTransport.run = plain version; every body that holds each "
          f"plan forced and equal: {both[True]} with the shared, global and "
          f"gather bodies, {both[False]} too tall for the shared one; bodies "
          f"and paths {sorted(paths)}), the tall plan of "
          f"{8 * tp.schedule.num_slots} rows on the gather body, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def _row_map(sched, n: int) -> np.ndarray:
    """A copy-only schedule as one row gather: the input row each output
    row holds, -1 where it takes +0 (the schedule run on row ids + 1)."""
    from repro_torch.core.transport import SimTransport
    ids = np.arange(1, n * sched.num_slots + 1, dtype=np.int64).reshape(
        n, sched.num_slots, 1)
    return SimTransport(n).run(sched, ids).reshape(-1) - 1


def kv_path(torch, dev) -> dict:
    """(k) The continuous-batching engine at a real size on the transport
    kernel: counters reset, the trace run, counters read (one launch per
    batch, the gather body on every batch too tall for shared memory,
    every batch verified bitwise by the engine); the transfer log and
    the final pool held against the same engine on the numpy ``sim``
    transport; then each batch replayed: host ms (plan, executor and
    kernel table from cold caches), kernel ms (CUDA events) beside its
    bound and the ``g.clone()`` copy floor."""
    from repro_torch import cuda
    from repro_torch.core import executor, kernel_lowering, kvtransfer
    from repro_torch.core.kernel_lowering import get_kernel_exec, pick_tile
    from repro_torch.serve.engine import ContinuousBatchingEngine, \
        EngineConfig
    from repro_torch.serve.traffic import poisson_workload, run_workload

    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(EngineConfig(
        **KV_CONFIG, transport="kernel", device="cuda"))
    trace = poisson_workload(0, **KV_TRACE)
    torch.cuda.synchronize()
    cuda.reset_launches()
    t1 = time.perf_counter()
    m = run_workload(eng, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(cuda.LAUNCHES)
    bodies = dict(cuda.TRANSPORT_BODIES)
    kv = m["kv_transfer"]
    print(f"kv path: {m['completed']}/{m['submitted']} requests in "
          f"{m['steps']} steps, {m['tokens']} tokens, {kv['plans']} plans "
          f"{kv['plan_names']}, {kv['blocks']} blocks, {kv['bytes']} B "
          f"({kv['dcn_bytes']} B dcn / {kv['ici_bytes']} B ici), every "
          f"batch bitwise; {wall:.2f} s wall (host clock), transfers "
          f"{kv['wall_s']} s; launches {launches}, transport bodies "
          f"{bodies}; pool {tuple(eng.kv.shape)} "
          f"{eng.kv.numel() * 4 / 1e9:.3f} GB on the card", flush=True)
    _require(m["completed"] == m["submitted"] == KV_TRACE["n_requests"],
             "kv path: not every request completed")
    _require(launches["schedule_exec"] == kv["plans"],
             "kv path: not one schedule_exec launch per batch")
    elem = 4
    L = KV_CONFIG["block_tokens"] * KV_CONFIG["block_feat"]
    tall = 0
    for x in eng.transfer_log:
        tp = kvtransfer.build_transfer_plan(
            list(x["moves"]), eng.topo,
            blocks_per_rank=KV_CONFIG["blocks_per_rank"],
            block_bytes=eng.cfg.block_bytes)
        t = get_kernel_exec(tp.schedule, topo=eng.topo).tables
        ns = eng.topo.nranks * tp.schedule.num_slots
        tall += pick_tile(ns, t["stage_rows"], elem, L, "kv",
                          len(t["tab"]),
                          copy_only=t["copy_only"])[0] == "gather"
    _require(bodies["gather"] == tall and tall > 0 and not bodies["global"],
             f"kv path: {bodies['gather']} gather-body launches for "
             f"{tall} batches too tall for shared memory (global body "
             f"{bodies['global']})")
    kv_final = eng.kv.cpu().numpy()
    topo = eng.topo
    log = [{k: v for k, v in x.items() if k != "seconds"}
           for x in eng.transfer_log]
    seconds = [x["seconds"] for x in eng.transfer_log]
    del eng
    torch.cuda.empty_cache()

    # the same engine on the numpy transport, pool on the host
    t1 = time.perf_counter()
    ref = ContinuousBatchingEngine(EngineConfig(
        **KV_CONFIG, transport="sim", device="cpu"))
    rm = run_workload(ref, poisson_workload(0, **KV_TRACE))
    _require([{k: v for k, v in x.items() if k != "seconds"}
              for x in ref.transfer_log] == log,
             "kv path: the transfer log differs from the sim engine's")
    _require(rm["kv_transfer"]["plan_names"] == kv["plan_names"]
             and rm["steps"] == m["steps"] and rm["tokens"] == m["tokens"],
             "kv path: metrics differ from the sim engine's")
    _require(ref.kv.numpy().tobytes() == kv_final.tobytes(),
             "kv path: the final pool differs from the sim engine's")
    print(f"kv path: transfer log, metrics and the final pool equal to the "
          f"same engine on sim ({time.perf_counter() - t1:.2f} s on the "
          f"host)", flush=True)
    del ref, kv_final

    # replay each batch: host cost from cold caches, then the kernel
    pool = torch.randn((topo.nranks, KV_CONFIG["blocks_per_rank"],
                        KV_CONFIG["block_tokens"], KV_CONFIG["block_feat"]),
                       device=dev)
    rows = []
    for i, x in enumerate(log):
        executor.clear_cache()
        kernel_lowering.clear_cache()
        h0 = time.perf_counter()
        tp = kvtransfer.build_transfer_plan(
            list(x["moves"]), topo,
            blocks_per_rank=KV_CONFIG["blocks_per_rank"],
            block_bytes=elem * L)
        kex = get_kernel_exec(tp.schedule, topo=topo)
        if kex.plan(elem, L)[0] == "gather":     # built on first use
            kernel_lowering.gather_tables(kex.ex)
        host_ms = (time.perf_counter() - h0) * 1e3
        # the part of it the gather body's table takes: the composed map
        # and its grouping by source, again
        t = kex.tables
        h0 = time.perf_counter()
        kernel_lowering._gather_table(kernel_lowering._compose(
            t["src_row"], t["load"], t["rounds"], t["post_row"]))
        table_ms = (time.perf_counter() - h0) * 1e3
        g = pool.new_zeros((topo.nranks, tp.schedule.num_slots)
                           + tuple(pool.shape[2:]))
        g[:, : KV_CONFIG["blocks_per_rank"]] = pool
        ms = time_ms(torch, kex.run, g, reps=5, batches=3)
        run = dict(kex.last_launch)
        clone_ms = time_ms(torch, lambda a: a.clone(), g, reps=5, batches=3)
        bound = run["floor_bytes"] / HBM_BYTES_PER_S * 1e3
        row = {"batch": i, "step": x["step"], "rows": run["rows"],
               "rows_loaded": run["rows_loaded"], "moves": x["blocks"],
               "plan": x["plan"], "rounds": kex.rounds,
               "body": run["body"], "path": run["path"], "ms": ms,
               "bound_ms": bound, "clone_ms": clone_ms, "host_ms": host_ms,
               "gather_table_ms": table_ms,
               "engine_transfer_ms": seconds[i] * 1e3}
        rows.append(row)
        print(f"kv batch {i:2d} (step {x['step']}): {run['rows']} rows "
              f"({run['rows_loaded']} loaded), {x['blocks']} moves, "
              f"{x['plan']} {kex.rounds} rounds, {run['body']} body "
              f"({run['path']}): {ms:.4f} ms (bound {bound:.4f} ms, "
              f"g.clone() {clone_ms:.4f} ms), host {host_ms:.2f} ms (gather "
              f"table {table_ms:.2f} ms), engine transfer "
              f"{seconds[i] * 1e3:.2f} ms", flush=True)
        del g
    big = max(range(len(rows)), key=lambda i: rows[i]["rows"])
    x = log[big]
    tp = kvtransfer.build_transfer_plan(
        list(x["moves"]), topo,
        blocks_per_rank=KV_CONFIG["blocks_per_rank"],
        block_bytes=elem * L)
    g = pool.new_zeros((topo.nranks, tp.schedule.num_slots)
                       + tuple(pool.shape[2:]))
    g[:, : KV_CONFIG["blocks_per_rank"]] = pool
    del pool
    print(f"kv path: phase {time.perf_counter() - t0:.2f} s", flush=True)
    return {"metrics": m, "launches": launches["schedule_exec"],
            "gather_launches": bodies["gather"], "batches": rows,
            "log": log,
            "largest": {"sched": tp.schedule, "topo": tp.topo, "gbuf": g,
                        "batch": big}}


def gather_body_timing(torch, kvrun) -> tuple[dict, dict]:
    """The gather body at the largest KV batch: kernel ms and device ms,
    its plain version, the bound, the copy floor and the one-call library
    equivalent (``index_select`` of the schedule's row map, which must
    equal the composed map the body walks); and the round-by-round
    global body forced on the same batch (kernel and device ms).
    Returns (the gather body's row, the global body's row)."""
    from repro_torch.core.kernel_lowering import (gather_tables,
                                                  get_kernel_exec,
                                                  schedule_exec_gather_plain)
    big = kvrun["largest"]
    g, sched, topo = big["gbuf"], big["sched"], big["topo"]
    kex = get_kernel_exec(sched, topo=topo)
    out = kex.run(g)
    torch.cuda.synchronize()
    run = dict(kex.last_launch)
    _require(run["body"] == "gather" and run["path"] == "bulk"
             and not run["zero_rows"],
             f"the largest KV batch: {run['body']} body, {run['path']} path, "
             f"{run['zero_rows']} zero rows")
    plain = schedule_exec_gather_plain(kex.ex, g)
    _require(torch.equal(_ints(out), _ints(plain)),
             "the largest KV batch: kernel != plain version")
    del plain
    rmap_np = _row_map(sched, topo.nranks)
    _require(np.array_equal(gather_tables(kex.ex)["src_of"], rmap_np),
             "the largest KV batch: the composed map != SimTransport's")
    rmap = torch.from_numpy(rmap_np).to(g.device)
    flat = g.view(-1, g[0, 0].numel())
    _require(torch.equal(_ints(flat.index_select(0, rmap)),
                         _ints(out.view(flat.shape))),
             "the largest KV batch: index_select of the row map differs")
    glob = kex.run(g, _body="global")
    torch.cuda.synchronize()
    glob_run = dict(kex.last_launch)
    _require(torch.equal(_ints(glob), _ints(out)),
             "the largest KV batch: the global body differs")
    del glob, out

    def global_body(a):
        return kex.run(a, _body="global")

    ms = time_ms(torch, kex.run, g, reps=5, batches=5)
    glob_ms = time_ms(torch, global_body, g, reps=5, batches=5)
    dev_ms = device_ms(torch, "schedule_exec_gather", kex.run, g, reps=5)
    glob_dev = device_ms(torch, "schedule_exec_global", global_body, g,
                         reps=5)
    plain_ms = time_ms(torch, lambda a: schedule_exec_gather_plain(kex.ex, a),
                       g, reps=1, batches=3)
    lib_ms = time_ms(torch, lambda a: a.view(flat.shape).index_select(
        0, rmap), g, reps=5, batches=5)
    clone_ms = time_ms(torch, lambda a: a.clone(), g, reps=5, batches=5)
    bound = run["floor_bytes"] / HBM_BYTES_PER_S * 1e3
    case = (f"KV batch {big['batch']}: {run['rows']} rows of [16, 2048] f32, "
            f"{len(kex.ex._rounds)} rounds")
    library = ("flat.index_select(0, row_map) (the schedule composed into "
               "one row gather)")
    row = {"case": case, "launches": kvrun["gather_launches"], "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "bytes", "library_ms": lib_ms, "library_call": library,
           "copy_floor_ms": clone_ms, "max_abs_err": 0.0, "launch": run,
           "global_body_ms": glob_ms, "batches": kvrun["batches"]}
    glob_bound = glob_run["floor_bytes"] / HBM_BYTES_PER_S * 1e3
    glob_row = {"case": case + " (forced)", "launches": 0, "ms": glob_ms,
                "device_ms": glob_dev, "plain_ms": plain_ms,
                "bound_ms": glob_bound, "bound_by": "bytes",
                "library_ms": lib_ms, "library_call": library,
                "copy_floor_ms": clone_ms, "max_abs_err": 0.0,
                "launch": glob_run}
    print(f"{'schedule_exec':>15} | gather body, {case}: {ms:.4f} ms "
          f"[device {dev_ms if dev_ms is None else round(dev_ms, 4)}] "
          f"(bound {bound:.4f} ms by bytes, {run['floor_bytes'] / ms / 1e6:.1f}"
          f" GB/s, {run['rows_loaded']} rows read + {run['rows']} written; "
          f"grid {run['grid']}, {run['ctas_per_sm']} CTAs/SM, "
          f"{run['buffers']} x {run['tile']} B), plain {plain_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms [index_select], g.clone() "
          f"{clone_ms:.4f} ms; global body forced {glob_ms:.4f} ms [device "
          f"{glob_dev if glob_dev is None else round(glob_dev, 4)}] (bound "
          f"{glob_bound:.4f} ms); launches on the KV path "
          f"{kvrun['gather_launches']}", flush=True)
    return row, glob_row


# ---------------------------------------------------------------------------
# the recovery ladder and the partitioned schedules on the card
# ---------------------------------------------------------------------------


RESIL_LADDER = ("kernel", "sim", "reference")
# (campaign, corruption mode) of phase (r)'s seeded runs
CAMPAIGN_RUNS = [("corrupt", "nan"), ("corrupt", "bitflip"), ("fail", None),
                 ("hang", None), ("mixed", None)]
HANG_S, DEADLINE_S = 0.005, 0.004          # on the card
CPU_HANG_S, CPU_DEADLINE_S = 0.5, 0.4      # the CPU twin's numpy rung


def _report_key(rep, rename=None) -> tuple:
    """A report's attempts (rung, algorithm, attempt, outcome), verdicts
    and where it recovered, rung names mapped through ``rename``."""
    rename = rename or {}
    return ([(rename.get(a.rung, a.rung), a.algorithm, a.attempt, a.outcome)
             for a in rep.attempts], list(rep.verdicts),
            rename.get(rep.recovered_with, rep.recovered_with),
            rep.refit_algorithm)


def _region(sched, out):
    rows = sched.result_slots
    return [out[r, sched.out_offset(r): sched.out_offset(r) + rows]
            for r in range(sched.nranks)]


def _host_ms(torch, fn, reps: int) -> float:
    """Median host ms of ``fn()`` (which ends synchronized)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def resilience(torch, dev, cases, kv_log, kv_batches) -> None:
    """(r) The recovery ladder on the card, on ``KernelTransport`` with
    the ladder kernel -> sim -> reference: clean runs of the main path's
    collectives, seeded chaos campaigns against the CPU's reports, the
    canary row on every body, a persistent fault, and phase (k)'s KV
    trace under a corrupt campaign."""
    from repro_torch import cuda
    from repro_torch.core import chaos, tuner
    from repro_torch.core.algorithms import REGISTRY
    from repro_torch.core.kernel_lowering import get_kernel_exec
    from repro_torch.core.resilient import (ResilienceOptions,
                                            ResilientExec, canary_pattern)
    from repro_torch.core.schedule import add_canary_slot
    from repro_torch.core.topology import flat_topology
    from repro_torch.core.transport import KernelTransport, SimTransport

    t0 = time.perf_counter()
    # 1. clean runs at the main path's sizes: one launch, on the kernel
    # rung, undegraded, bitwise the plain run_global
    for c in [c for c in cases if c["kernel"] == "schedule_exec"]:
        sched, topo, gbuf = c["sched"], c["topo"], c["args"][0]
        n = topo.nranks
        tr = KernelTransport(n, topo=topo)
        want = tr.run_global(sched, gbuf)
        kernel_ms = time_ms(torch, functools.partial(tr.run_global, sched),
                            gbuf)
        slot_nbytes = gbuf[0, 0].numel() * gbuf.element_size()
        modes = ("off", "canary") + (("full",) if c is cases[0] else ())
        line = []
        for verify in modes:
            ex = ResilientExec(sched, topo, options=ResilienceOptions(
                verify=verify, ladder=RESIL_LADDER))
            torch.cuda.synchronize()
            cuda.reset_launches()
            h0 = time.perf_counter()
            out, rep = ex.run(gbuf)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - h0) * 1e3
            launches = cuda.LAUNCHES["schedule_exec"]
            _require(rep.recovered_with == "kernel" and not rep.degraded
                     and launches == 1,
                     f"{c['label']} verify={verify}: {rep.summary()}, "
                     f"{launches} launches")
            _require(torch.equal(_ints(out), _ints(want)),
                     f"{c['label']} verify={verify}: != run_global")
            body = get_kernel_exec(
                add_canary_slot(sched) if verify != "off" else sched,
                topo=topo).last_launch["body"]
            del out
            ms = _host_ms(torch, lambda: ex.run(gbuf),
                          2 if verify == "full" else 5)
            model_ms = tuner.verify_overhead_s(
                sched, topo, slot_nbytes=slot_nbytes, verify=verify) * 1e3
            line.append(f"{verify} {ms:.4f} ms (first {first_ms:.2f}; "
                        f"{body} body; verdicts {rep.verdicts}; modeled "
                        f"verification {model_ms:.5f} ms)")
        print(f"resilience | {c['label']}: kernel {kernel_ms:.4f} ms; "
              f"ResilientExec.run, host clock, median: "
              f"{'; '.join(line)} [modeled = tuner.verify_overhead_s, a "
              f"model at the HBM_BW model default, not a card time]",
              flush=True)
        del want
    torch.cuda.empty_cache()

    # 2. seeded campaigns, verify="full", on a flat-8 allreduce of 1 MiB
    # a rank: bitwise the oracle, and the reports of the same plans on
    # the CPU with the sim rung wrapped (kernel read as sim)
    topo = flat_topology(8)
    sched = REGISTRY["allreduce"]["ring_rs_ag"](topo)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    g = torch.randn((8, sched.num_slots, MIB // 4 // 8), generator=gen,
                    device=dev)
    g.view(-1)[::7] = -0.0
    host = g.cpu().numpy()
    oracle = np.stack(_region(sched, SimTransport(8).run_reference(sched,
                                                                   host)))
    # the canary'd plan's executor and kernel table are built here, not
    # inside a timed attempt
    ResilientExec(sched, topo, options=ResilienceOptions(
        verify="full", ladder=("kernel",))).run(g)
    walks = {}
    # a collector pause inside a clean attempt would read as a hang
    gc.collect()
    gc.disable()
    try:
        for campaign, mode in CAMPAIGN_RUNS:
            kw = {"mode": mode} if mode else {}
            for seed in range(5):
                # a deadline where a hang can fire
                timed = campaign in ("hang", "mixed")
                ex = ResilientExec(sched, topo, options=ResilienceOptions(
                    verify="full", ladder=RESIL_LADDER, backoff_s=1e-4,
                    deadline_s=DEADLINE_S if timed else None),
                    transports={"kernel": chaos.wrap(
                        KernelTransport(8, topo=topo), chaos.FaultPlan(
                            seed, campaign, delay_s=HANG_S, **kw))})
                out, rep = ex.run(g)
                got = torch.stack(_region(sched, out)).cpu().numpy()
                _require(got.view(np.int32).tobytes()
                         == oracle.view(np.int32).tobytes(),
                         f"campaign {campaign}/{mode} seed {seed}: not "
                         f"bitwise the oracle ({rep.summary()})")
                cpu = ResilientExec(sched, topo, options=ResilienceOptions(
                    verify="full", ladder=("sim", "reference"),
                    backoff_s=1e-4,
                    deadline_s=CPU_DEADLINE_S if timed else None),
                    transports={"sim": chaos.wrap(
                        SimTransport(8, topo=topo), chaos.FaultPlan(
                            seed, campaign, delay_s=CPU_HANG_S, **kw))})
                _, cpu_rep = cpu.run(host)
                _require(_report_key(rep, {"kernel": "sim"})
                         == _report_key(cpu_rep),
                         f"campaign {campaign}/{mode} seed {seed}: card "
                         f"{rep.summary()} != CPU {cpu_rep.summary()}")
                walks[f"{campaign}/{mode or '-'} s{seed}"] = " -> ".join(
                    f"{a.rung}[{a.outcome}]" for a in rep.attempts)
    finally:
        gc.enable()
    print(f"resilience | campaigns on a flat-8 allreduce of 1 MiB a rank "
          f"(verify full, kernel rung wrapped; hang and mixed: hang "
          f"{HANG_S} s, deadline {DEADLINE_S} s): all {len(walks)} bitwise "
          f"the oracle, every report equal to the CPU's with the sim rung "
          f"wrapped: {walks}",
          flush=True)

    # 3. the canary row through every body that holds a canary'd plan
    from repro_torch.core import kvtransfer
    from repro_torch.core.topology import Topology
    a2a = REGISTRY["alltoall"]["pairwise"](topo)
    kvt = Topology(8, 4)
    rng = np.random.default_rng(7)
    moves, used = [], set()
    while len(moves) < 600:
        src, d = int(rng.integers(4)), 4 + int(rng.integers(4))
        row, dr = int(rng.integers(256)), int(rng.integers(256))
        if (d, dr) not in used:
            used.add((d, dr))
            moves.append(kvtransfer.BlockMove(src, row, d, dr))
    tall = kvtransfer.build_transfer_plan(moves, kvt, blocks_per_rank=256,
                                          aggregate=True,
                                          block_bytes=4096).schedule
    seen = []
    for label, s, tp, slot, dtype in (
            ("allreduce 1 MiB/rank f32", sched, topo, g.shape[2:],
             torch.float32),
            ("alltoall [64, 256] bf16", a2a, topo, (64, 256),
             torch.bfloat16),
            (f"KV plan of {8 * tall.num_slots} rows [4, 256] f32", tall, kvt,
             (4, 256), torch.float32)):
        x = torch.randn((8, s.num_slots) + tuple(slot), generator=gen,
                        device=dev).to(dtype)
        x.view(-1)[::7] = -0.0
        pattern = canary_pattern(s, dtype, slot).to(dev)
        xbuf = torch.cat([x, pattern], 1)
        want = KernelTransport(8, topo=tp).run_global(s, x)
        kex = get_kernel_exec(add_canary_slot(s), topo=tp)
        default = kex.plan(xbuf.element_size(), math.prod(slot))[0]
        bodies = ["global"]
        if kex.tables["copy_only"]:
            bodies.append("gather")
        if default == "shared":
            bodies.append("shared")
        for b in bodies:
            out = kex.run(xbuf, _body=b)
            torch.cuda.synchronize()
            _require(torch.equal(_ints(out[:, s.num_slots:]), _ints(pattern)),
                     f"canary | {label}: the {b} body lost the canary row")
            _require(torch.equal(_ints(out[:, :s.num_slots]), _ints(want)),
                     f"canary | {label}: the {b} body differs from the "
                     f"plain plan's run")
        seen.append(f"{label} (default {default}): {bodies}")
        del x, xbuf, want, out
    print(f"resilience | canary row bitwise through every body that holds "
          f"the canary'd plan: {'; '.join(seen)}", flush=True)

    # 4. a persistent fault on the kernel rung walks to sim
    ex = ResilientExec(sched, topo, options=ResilienceOptions(
        verify="canary", ladder=RESIL_LADDER, backoff_s=1e-4),
        transports={"kernel": chaos.wrap(
            KernelTransport(8, topo=topo),
            chaos.FaultPlan(0, "fail", times=None))})
    out, rep = ex.run(g)
    got = torch.stack(_region(sched, out)).cpu().numpy()
    _require(rep.recovered_with == "sim" and rep.degraded
             and got.view(np.int32).tobytes()
             == oracle.view(np.int32).tobytes(),
             f"persistent fault: {rep.summary()}")
    print(f"resilience | persistent fail on the kernel rung: "
          f"{rep.summary()}, bitwise", flush=True)
    del g, out

    # 5. phase (k)'s KV trace with a corrupt campaign round the kernel rung
    from repro_torch.serve.engine import ContinuousBatchingEngine, \
        EngineConfig
    from repro_torch.serve.traffic import poisson_workload, run_workload
    res = {"verify": "canary", "ladder": RESIL_LADDER, "backoff_s": 1e-4}
    eng = ContinuousBatchingEngine(
        EngineConfig(**KV_CONFIG, transport="kernel", device=dev.type,
                     resilience=res),
        transports={"kernel": chaos.wrap(
            KernelTransport(8, topo=kvt),
            chaos.FaultPlan(0, "corrupt", times=1, mode="nan"))})
    torch.cuda.synchronize()
    cuda.reset_launches()
    t1 = time.perf_counter()
    m = run_workload(eng, poisson_workload(0, **KV_TRACE))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = cuda.LAUNCHES["schedule_exec"]
    _require(m["completed"] == m["submitted"] == KV_TRACE["n_requests"],
             "kv under chaos: not every request completed")
    _require([{k: v for k, v in x.items() if k != "seconds"}
              for x in eng.transfer_log] == kv_log,
             "kv under chaos: the transfer log differs from phase (k)'s")
    degraded = [(i, r.recovered_with, " -> ".join(
        f"{a.rung}[{a.outcome}]" for a in r.attempts))
        for i, r in enumerate(eng.degradations) if r.degraded]
    _require(all(r.recovered_with == "kernel" for r in eng.degradations),
             "kv under chaos: a batch left the kernel rung")
    _require(launches == len(eng.degradations) + len(degraded),
             f"kv under chaos: {launches} launches for "
             f"{len(eng.degradations)} batches, {len(degraded)} retried")
    print(f"resilience | kv trace under FaultPlan(0, 'corrupt', times=1, "
          f"mode='nan') on the kernel rung, verify canary: "
          f"{m['completed']}/{m['submitted']} served, every batch bitwise "
          f"(the engine's check), transfer log equal to phase (k)'s; "
          f"{len(eng.degradations)} reports, {len(degraded)} degraded "
          f"(batch, recovered on, walk): {degraded}; {launches} transport "
          f"launches; {wall:.2f} s wall", flush=True)
    del eng
    torch.cuda.empty_cache()
    # each batch replayed: host ms of the checks beside the kernel ms of
    # phase (k) (the plain plan) and the ladder's call
    pool = torch.randn((8, KV_CONFIG["blocks_per_rank"],
                        KV_CONFIG["block_tokens"], KV_CONFIG["block_feat"]),
                       generator=gen, device=dev)
    per = []
    for i, x in enumerate(kv_log):
        tp = kvtransfer.build_transfer_plan(
            list(x["moves"]), kvt,
            blocks_per_rank=KV_CONFIG["blocks_per_rank"],
            block_bytes=4 * KV_CONFIG["block_tokens"]
            * KV_CONFIG["block_feat"])
        gb = pool.new_zeros((8, tp.schedule.num_slots)
                            + tuple(pool.shape[2:]))
        gb[:, : KV_CONFIG["blocks_per_rank"]] = pool
        ex = ResilientExec(tp.schedule, kvt, options=ResilienceOptions(
            verify="canary", ladder=RESIL_LADDER))
        ex.run(gb)        # as in the engine: the canary drawn, plan built
        first = ex.stats["verify_s"]
        ex.stats = {"verify_s": 0.0, "call_s": 0.0}
        out, rep = ex.run(gb)
        _require(rep.recovered_with == "kernel" and not rep.degraded,
                 f"kv batch {i} replay: {rep.summary()}")
        per.append((i, round(first * 1e3, 2),
                    round(ex.stats["verify_s"] * 1e3, 2),
                    round(ex.stats["call_s"] * 1e3, 2),
                    round(kv_batches[i]["ms"], 4)))
        del gb, out
    print(f"resilience | kv batches, verify canary (batch, host ms of the "
          f"checks on a first run as the engine makes it / on a second run, "
          f"its canary row drawn / host ms of the kernel rung's call on the "
          f"second / kernel ms of phase (k)): {per}; phase "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    del pool


def partitioned(torch, dev) -> None:
    """(p) ``partitioned_schedule(8, shift by one, P)`` for P in 1, 2, 4,
    8 through ``KernelTransport.run_global`` at 25 MiB f32 a rank:
    bitwise ``SimTransport.run`` and the monolithic shift, bit-identical
    across P, one launch each; ms beside the bound and ``g.clone()``."""
    from repro_torch import cuda
    from repro_torch.core.algorithms.partitioned import partitioned_schedule
    from repro_torch.core.kernel_lowering import get_kernel_exec
    from repro_torch.core.transport import KernelTransport, SimTransport

    t0 = time.perf_counter()
    n = 8
    perm = [(i, (i + 1) % n) for i in range(n)]
    per_rank = 25 * MIB // 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    x = torch.randn((n, per_rank), generator=gen, device=dev)
    x.view(-1)[::7] = -0.0
    shift = x.roll(1, 0)               # rank r receives rank r - 1's
    tr = KernelTransport(n)
    first, rows = None, []
    for P in (1, 2, 4, 8):
        sched = partitioned_schedule(n, perm, P)
        g = torch.zeros((n, 2 * P, per_rank // P), device=dev)
        g[:, :P] = x.view(n, P, per_rank // P)
        torch.cuda.synchronize()
        cuda.reset_launches()
        out = tr.run_global(sched, g)
        torch.cuda.synchronize()
        launches = cuda.LAUNCHES["schedule_exec"]
        run = dict(get_kernel_exec(sched).last_launch)
        _require(launches == 1, f"partitioned p{P}: {launches} launches")
        sim = SimTransport(n).run(sched, _np_bits(g))
        _require(_np_bits(out).tobytes() == sim.tobytes(),
                 f"partitioned p{P}: != SimTransport.run")
        recv = out[:, P:].reshape(n, per_rank)
        _require(torch.equal(_ints(recv), _ints(shift)),
                 f"partitioned p{P}: != the monolithic shift")
        if first is None:
            first = recv
        _require(torch.equal(_ints(recv), _ints(first)),
                 f"partitioned p{P}: differs from p1")
        ms = time_ms(torch, functools.partial(tr.run_global, sched), g)
        clone_ms = time_ms(torch, lambda a: a.clone(), g)
        # each rank's P chunks read once, its P received chunks written once
        bound = n * 2 * per_rank * 4 / HBM_BYTES_PER_S * 1e3
        floor = run["floor_bytes"] / HBM_BYTES_PER_S * 1e3
        rows.append(f"p{P}: {ms:.4f} ms ({run['body']} body, path "
                    f"{run['path']}, bound {bound:.4f} ms by bytes, design "
                    f"floor {floor:.4f} ms, g.clone() {clone_ms:.4f} ms)")
        del g, out, recv
    print(f"partitioned | shift by one over 8 ranks, 25 MiB f32 a rank, "
          f"P = 1, 2, 4, 8: each one launch, bitwise SimTransport.run and "
          f"the monolithic shift, bit-identical across P: {'; '.join(rows)}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


# ---------------------------------------------------------------------------
# the tuner on the card
# ---------------------------------------------------------------------------


# repeats of the second pair of tunes in phase (t)'s stability check
STABLE_REPEATS = 30


def _winners(table) -> dict:
    """(winner, runner-up ms / winner ms) of every cell of a table."""
    out = {}
    for coll, per in table.entries.items():
        for b, rec in per.items():
            t = sorted(rec["times"].values())
            out[f"{coll}@{b}"] = (rec["best"], t[1] / t[0])
    return out


def _tune_cell_inputs(torch, gen, dev, coll, sched, topo, nbytes):
    """Random floats with negative zeros in the global buffer the tuner
    times for one cell (``tuner._probe_spec`` / ``_slot_elems``)."""
    from repro_torch.core import tuner
    rows, _ = tuner._probe_spec(coll, topo, nbytes)
    g = torch.randn((topo.nranks, sched.num_slots,
                     tuner._slot_elems(coll, topo, rows)), generator=gen,
                    device=dev)
    g.view(-1)[::7] = -0.0
    return g


def tuning(torch, dev, kv_batches) -> dict:
    """(t) The tuner behind ``policy="tuned"`` on the card: measured
    tables on the transport kernel, tuned KV plans, the measurement
    deadline, the drift-healing daemon and the launcher's ``--autotune``.
    The tables go to a temporary cache file, set for this phase only."""
    import tempfile

    from repro_torch import cuda
    from repro_torch.core import (api, executor, kernel_lowering, kvtransfer,
                                  tuner)
    from repro_torch.core.kernel_lowering import get_kernel_exec
    from repro_torch.core.linkprobe import model_timer
    from repro_torch.core.topology import Topology, flat_topology
    from repro_torch.core.transport import KernelTransport, SimTransport
    from repro_torch.runtime.fault import LinkFault
    from repro_torch.runtime.tuning_daemon import TuningDaemon
    from repro_torch.serve.engine import ContinuousBatchingEngine, \
        EngineConfig
    from repro_torch.serve.traffic import poisson_workload, run_workload

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="repro_torch_tuner_")
    prior = os.environ.get("REPRO_TORCH_TUNER_CACHE")
    os.environ["REPRO_TORCH_TUNER_CACHE"] = os.path.join(tmp, "cache.json")
    tuner.clear_cache()
    card = torch.cuda.get_device_name(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    out = {"launches": 0, "tables": {}}
    try:
        # (a) measured tables on the transport kernel
        for topo in (flat_topology(8), Topology(8, 4)):
            torch.cuda.synchronize()
            cuda.reset_launches()
            t1 = time.perf_counter()
            table = tuner.tune(topo, substrate="kernel")
            tune_s = time.perf_counter() - t1
            launches = cuda.LAUNCHES["schedule_exec"]
            out["launches"] += launches
            fp = topo.fingerprint(f"{card}.kernel")
            _require(table.source == "measured" and table.fingerprint == fp
                     and card.replace(" ", "_") in table.fingerprint,
                     f"tune on the kernel: {table.source} {table.fingerprint}")
            calls = sum(len(rec["times"]) for per in table.entries.values()
                        for rec in per.values())
            _require(launches == calls * 4 and not any(
                "xla" in rec["times"] for per in table.entries.values()
                for rec in per.values()),
                f"tune: {launches} launches for {calls} candidate cells "
                f"(want one a call: warm-up + 3 repeats each)")
            _require(table.violations == tuner.verify_guidelines(table, topo),
                     "tune: the guideline findings were not recorded")
            tuner.save_table(table)
            model = tuner.tune(topo, force_model=True)
            differ = []
            for coll, per in table.entries.items():
                for b in sorted(per, key=int):
                    rec, mrec = per[b], model.entries[coll][b]
                    if rec["best"] != mrec["best"]:
                        differ.append(f"{coll}@{b}")
                    cells = ", ".join(
                        f"{k} {v * 1e3:.4f} (model {mrec['times'][k] * 1e3:.4f})"
                        for k, v in rec["times"].items())
                    print(f"tuning {fp} {coll} bucket {b} "
                          f"({rec['nbytes']} B a rank): measured ms "
                          f"[{cells}]; winner {rec['best']}, model's "
                          f"{mrec['best']}", flush=True)
            # each winner's output, bitwise the numpy oracle (at the
            # cell's size, up to 1 MiB a rank: the oracle runs on the host)
            checked = set()
            for coll, per in table.entries.items():
                for b, rec in per.items():
                    sched = api._schedule(coll, rec["best"], topo)
                    g = _tune_cell_inputs(torch, gen, dev, coll, sched, topo,
                                          min(rec["nbytes"], MIB))
                    got = KernelTransport(8, topo=topo).run_global(sched, g)
                    want = SimTransport(8, topo=topo).run(
                        sched, g.cpu().numpy())
                    _require(_np_bits(got).tobytes()
                             == want.view(np.int32).tobytes(),
                             f"tune winner {coll}.{rec['best']} @{b}: kernel "
                             f"!= SimTransport.run")
                    checked.add((coll, b))
                    del g, got
            # do the winners survive a second run?  (at 3 repeats: this
            # table against one more; then two at STABLE_REPEATS)
            stable = {}
            for repeats, runs in ((3, [table]), (STABLE_REPEATS, [])):
                while len(runs) < 2:
                    cuda.reset_launches()
                    runs.append(tuner.tune(topo, substrate="kernel",
                                           repeats=repeats))
                    out["launches"] += cuda.LAUNCHES["schedule_exec"]
                a, b = (_winners(t) for t in runs)
                same = [c for c in a if a[c][0] == b[c][0]]
                margins = [a[c][1] for c in a] + [b[c][1] for c in b]
                stable[repeats] = {
                    "agree": len(same), "cells": len(a),
                    "margin_median": statistics.median(margins),
                    "margin_max": max(margins)}
                print(f"tuning {fp} stability at {repeats} repeats: "
                      f"winners agree across two runs in {len(same)} of "
                      f"{len(a)} cells; runner-up / best median "
                      f"{statistics.median(margins):.4f}, max "
                      f"{max(margins):.4f}", flush=True)
            out["tables"][topo.fingerprint()] = {
                "tune_s": tune_s, "launches": launches,
                "winners_differ": differ, "violations": table.violations,
                "stable": stable}
            print(f"tuning {fp}: tune {tune_s:.2f} s, {launches} launches "
                  f"(one a call), source {table.source}, {len(checked)} "
                  f"winners bitwise SimTransport.run, winners unlike the "
                  f"model's in {len(differ)} of {len(checked)} cells "
                  f"{differ}; guideline findings "
                  f"{len(table.violations)}: {table.violations}", flush=True)

        # (b) tuned neighbor plans on the KV engine's topology
        ecfg = EngineConfig(**KV_CONFIG, transport="kernel", device="cuda",
                            policy="tuned")
        topo = ecfg.topology()
        torch.cuda.synchronize()
        cuda.reset_launches()
        table = tuner.load_table(tuner.substrate_fingerprint(
            topo, substrate="kernel"))
        table.entries[tuner.NEIGHBOR] = tuner.tune_neighbor(
            topo, substrate="kernel")
        tuner.save_table(table)
        out["launches"] += cuda.LAUNCHES["schedule_exec"]
        nb = table.entries[tuner.NEIGHBOR]
        print(f"tuning neighbor {table.fingerprint}: " + "; ".join(
            f"bucket {b}: " + ", ".join(f"{k} {v * 1e3:.4f} ms"
                                        for k, v in nb[b]["times"].items())
            + f" -> {nb[b]['best']}" for b in sorted(nb, key=int)),
            flush=True)
        eng = ContinuousBatchingEngine(ecfg)
        torch.cuda.synchronize()
        cuda.reset_launches()
        m = run_workload(eng, poisson_workload(0, **KV_TRACE))
        torch.cuda.synchronize()
        launches = cuda.LAUNCHES["schedule_exec"]
        out["launches"] += launches
        kv = m["kv_transfer"]
        _require(m["completed"] == m["submitted"] == KV_TRACE["n_requests"],
                 "tuned kv: not every request completed")
        _require(launches == kv["plans"] == len(kv_batches),
                 f"tuned kv: {launches} launches for {kv['plans']} batches")
        log = [{k: v for k, v in x.items() if k != "seconds"}
               for x in eng.transfer_log]
        del eng
        torch.cuda.empty_cache()
        # each batch's host cost from cold caches under either policy
        host = {"model": [], "tuned": []}
        for x in log:
            for policy in host:
                executor.clear_cache()
                kernel_lowering.clear_cache()
                h0 = time.perf_counter()
                tp = kvtransfer.build_transfer_plan(
                    list(x["moves"]), topo,
                    blocks_per_rank=KV_CONFIG["blocks_per_rank"],
                    block_bytes=ecfg.block_bytes, policy=policy)
                kex = get_kernel_exec(tp.schedule, topo=topo)
                if kex.plan(4, KV_CONFIG["block_tokens"]
                            * KV_CONFIG["block_feat"])[0] == "gather":
                    kernel_lowering.gather_tables(kex.ex)
                host[policy].append((time.perf_counter() - h0) * 1e3)
        phase_k = [b["host_ms"] for b in kv_batches]
        out["kv"] = {"plans": kv["plan_names"], "host_ms": host,
                     "phase_k_host_ms": phase_k}
        print(f"tuning kv: {m['completed']}/{m['submitted']} served with "
              f"policy tuned, every batch bitwise (the engine's check), one "
              f"launch a batch ({launches}), plans {kv['plan_names']}; host "
              f"ms a batch from cold caches: tuned "
              f"{statistics.median(host['tuned']):.2f} median "
              f"({min(host['tuned']):.2f}-{max(host['tuned']):.2f}), model "
              f"{statistics.median(host['model']):.2f} median "
              f"({min(host['model']):.2f}-{max(host['model']):.2f}) in the "
              f"same loop, phase (k)'s {statistics.median(phase_k):.2f} "
              f"median", flush=True)

        # (c) the measurement deadline
        sched = api._schedule("allreduce", "ring_rs_ag", topo)
        try:
            tuner.measure_schedule(sched, topo, slot_elems=1024,
                                   deadline_s=1e-6, substrate="kernel")
            raise RuntimeError("measure_schedule(deadline_s=1e-6) returned")
        except tuner.MeasurementTimeout as e:
            print(f"tuning deadline: MeasurementTimeout ({e})", flush=True)
        torch.cuda.synchronize()

        # (d) the daemon heals a DCN collapse, scoped; the healed topology
        # runs on the kernel
        fault = LinkFault()
        d = TuningDaemon(Topology(8, 4), path=os.path.join(tmp, "d.json"),
                         force_model=True, timer=model_timer(
                             Topology(8, 4), fault=fault), repeats=1)
        fault.degrade(0, beta_scale=16.0)
        rep = d.probe_and_heal(step=1)
        _require(rep.drifted_levels == (0,) and 0 < len(rep.affected_cells)
                 < rep.total_cells and rep.retuned_cells,
                 f"daemon: {rep}")
        nbytes = 1 << 22
        algo = tuner.tuned_select("allreduce", d.topo, nbytes, table=d.table)
        sched = api._schedule("allreduce", algo, d.topo)
        g = _tune_cell_inputs(torch, gen, dev, "allreduce", sched, d.topo,
                              nbytes)
        torch.cuda.synchronize()
        cuda.reset_launches()
        got = KernelTransport(8, topo=d.topo).run_global(sched, g)
        torch.cuda.synchronize()
        out["launches"] += cuda.LAUNCHES["schedule_exec"]
        _require(cuda.LAUNCHES["schedule_exec"] == 1, "daemon: not 1 launch")
        want = SimTransport(8, topo=d.topo).run(sched, g.cpu().numpy())
        _require(_np_bits(got).tobytes() == want.view(np.int32).tobytes(),
                 "daemon: the healed allreduce != SimTransport.run")
        print(f"tuning daemon: DCN beta x16 -> drifted {rep.drifted_levels}, "
              f"{len(rep.affected_cells)}/{rep.total_cells} cells affected, "
              f"{len(rep.retuned_cells)} re-measured, generation "
              f"{rep.generation}, evicted {rep.invalidated}; allreduce.{algo} "
              f"on {d.topo.fingerprint()} one launch, bitwise", flush=True)
        del g, got

        # (e) the launcher's --autotune
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               "gemma2-2b", "--continuous", "--kv-transport", "kernel",
               "--autotune", "--select-policy", "tuned"]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_TORCH_TUNER_CACHE=os.path.join(tmp, "launch.json"))
        t1 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
        print(res.stdout.strip(), flush=True)
        _require(res.returncode == 0,
                 f"launcher --autotune exited {res.returncode}: "
                 f"{res.stderr[-2000:]}")
        served = [ln for ln in res.stdout.splitlines()
                  if ln.startswith("continuous: ")]
        _require(bool(served), "launcher --autotune printed no summary")
        done, submitted = served[0].split()[1].split("/")
        _require(done == submitted, f"launcher served {done}/{submitted}")
        print(f"tuning launcher: {' '.join(cmd[1:])}: {done}/{submitted} "
              f"served, {time.perf_counter() - t1:.2f} s", flush=True)
    finally:
        if prior is None:
            os.environ.pop("REPRO_TORCH_TUNER_CACHE", None)
        else:
            os.environ["REPRO_TORCH_TUNER_CACHE"] = prior
        tuner.clear_cache()
    print(f"tuning: phase {time.perf_counter() - t0:.2f} s, "
          f"{out['launches']} transport-kernel launches", flush=True)
    return out


def launcher_continuous(torch) -> None:
    """(c) The launcher's continuous path on the card, in a subprocess."""
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "gemma2-2b", "--continuous", "--kv-transport", "kernel"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    print(res.stdout.strip(), flush=True)
    _require(res.returncode == 0,
             f"launcher --continuous exited {res.returncode}: "
             f"{res.stderr[-2000:]}")
    served = [ln for ln in res.stdout.splitlines()
              if ln.startswith("continuous: ")]
    _require(bool(served), "launcher --continuous printed no summary")
    done, submitted = served[0].split()[1].split("/")
    _require(done == submitted, f"launcher served {done}/{submitted}")
    print(f"launcher: {' '.join(cmd[1:])}: {done}/{submitted} requests "
          f"served, {time.perf_counter() - t0:.2f} s", flush=True)


# ---------------------------------------------------------------------------
# flash attention: parity, the serving path, the gather op, timing
# ---------------------------------------------------------------------------

# the reference's kernel tolerances (tests/test_kernels.py:20 and :61)
ATTN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}
# the reference's model tolerance (tests/test_kernels.py:161)
MODEL_ATOL, MODEL_RTOL = 0.15, 0.05
ATTN_VARIANTS = [dict(causal=True), dict(causal=True, window=64),
                 dict(causal=True, softcap=50.0),
                 dict(causal=True, window=64, softcap=50.0),
                 dict(causal=False), dict(causal=False, window=64,
                                          softcap=30.0)]
SERVE_ARCH = "gemma2-2b"
PREFILL_TOKENS = 8192            # past the 4096 window of the local layers
PREFILL_TIMES = 3                # prefills timed alone
LAUNCH_BATCH, LAUNCH_PROMPT, LAUNCH_GEN = 4, 32, 16


def _prefill_ms(torch, prefill, params, prompt) -> float:
    """One prefill's time on the card: CUDA events around it, median of
    PREFILL_TIMES runs (the recorders off)."""
    per = []
    for _ in range(PREFILL_TIMES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        prefill(params, prompt)
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b))
    return statistics.median(per)


def _close(torch, got, want, atol, rtol, what) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|
    everywhere."""
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    _require(not bool(bad.any()),
             f"{what}: {int(bad.sum())} elements off by up to "
             f"{diff.max().item():.4g} (atol {atol}, rtol {rtol})")
    return diff.max().item()


def _dead_rows(torch, gen, B, S, dev):
    """A random permutation per batch row with 1/8 of its slots at -1."""
    rows = torch.stack([torch.randperm(S, generator=gen, device=dev)
                        for _ in range(B)]).to(torch.int32)
    rows[:, ::8] = -1
    return rows


def attention_parity(torch, dev) -> dict:
    """Both kernels against their plain version; returns the max |err|
    per kernel."""
    from repro_torch import cuda
    from repro_torch.kernels.attention.kernel import (flash_attention_bshd,
                                                      flash_attention_plain)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    checked, worst = 0, {}
    bodies = {"wgmma": 0, "cuda_cores": 0}
    shapes = [(D, 8, 8 // g, 256) for D in (64, 128, 256) for g in (1, 2, 8)]
    shapes.append((128, 8, 4, 200))              # ragged last tile
    shapes.append((96, 4, 2, 333))               # D padded to 128
    shapes.append((136, 4, 2, 400))              # D padded to 256
    shapes.append((20, 6, 2, 160))               # bf16 on the CUDA cores
    for D, H, K, S in shapes:
        for dtname in ("float32", "bfloat16"):
            dtype = getattr(torch, dtname)
            q, k, v = (torch.randn(shape, generator=gen, device=dev,
                                   dtype=dtype)
                       for shape in ((2, S, H, D), (2, S, K, D), (2, S, K, D)))
            rows = _dead_rows(torch, gen, 2, S, dev)
            tol = ATTN_TOL[dtname]
            for kw in ATTN_VARIANTS:
                for q_rows in (None, rows):
                    name = ("flash_attention" if q_rows is None
                            else "flash_attention_gather")
                    body = ("wgmma" if dtname == "bfloat16" and D % 8 == 0
                            else "cuda_cores")
                    n0 = cuda.LAUNCHES[name]
                    b0 = cuda.FLASH_BODIES[body]
                    got = flash_attention_bshd(q, k, v, q_rows=q_rows, **kw)
                    torch.cuda.synchronize()
                    _require(cuda.LAUNCHES[name] == n0 + 1,
                             f"{name}: not one launch per call")
                    _require(cuda.FLASH_BODIES[body] == b0 + 1,
                             f"{name} D={D} {dtname}: not on the {body} "
                             f"body ({cuda.FLASH_BODIES})")
                    bodies[body] += 1
                    want = flash_attention_plain(q, k, v, q_rows=q_rows, **kw)
                    label = f"{name} D={D} H={H} K={K} S={S} {dtname} {kw}"
                    err = _close(torch, got, want, tol, tol, label)
                    if q_rows is not None:
                        _require(not bool(got[rows < 0].any()),
                                 f"{label}: dead rows not exact zeros")
                    worst[name] = max(worst.get(name, 0.0), err)
                    checked += 1
    print(f"attention parity: {checked} kernel calls (head_dim 64/128/256, "
          f"20, 96, 128 and 136 at ragged lengths, groups 1/2/8/3, "
          f"{len(ATTN_VARIANTS)} mask/softcap variants, f32 "
          f"and bf16, plain and gather) within atol=rtol 3e-5 (f32) / "
          f"2e-2 (bf16); max |err| {worst}; bodies {bodies}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return worst


def serve_path(torch, dev) -> dict:
    """gemma2-2b at full width: (a) the kernel prefill of one 8192-token
    prompt, (b) the launcher's loop, each with the counters reset just
    before and read just after."""
    from repro_torch import configs, cuda
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch import serve as launcher
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models.common import attn_mask
    from repro_torch.serve import ServeOptions, make_prefill_step

    cfg = configs.get_config(SERVE_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    print(f"serve: {SERVE_ARCH} at full width, {cfg.n_layers} layers, "
          f"{cfg.param_count():,} parameters (bf16, random from seed 0) "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    V = cfg.vocab_size
    prefill = make_prefill_step(cfg, ServeOptions(use_kernel=True))
    prefill_plain = make_prefill_step(cfg, ServeOptions(use_kernel=False))
    gen.manual_seed(1)
    prompt = torch.randint(2, V, (1, PREFILL_TOKENS), generator=gen,
                           device=dev)
    prefill(params, prompt[:, :256])             # warm-up, not counted
    torch.cuda.synchronize()

    # (a) the kernel prefill, recording each layer's attention inputs
    records = []
    real_op = attn_ops.flash_attention

    def recording(q, k, v, *args, **kw):
        out = real_op(q, k, v, *args, **kw)
        records.append((q, k, v, kw, out))
        return out

    attn_ops.flash_attention = recording
    try:
        cuda.reset_launches()
        t0 = time.perf_counter()
        logits = prefill(params, prompt)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(cuda.LAUNCHES)
        bodies = dict(cuda.FLASH_BODIES)
    finally:
        attn_ops.flash_attention = real_op
    print(f"serve (a) prefill: B=1 S={PREFILL_TOKENS} in {dt * 1e3:.3f} ms "
          f"= {PREFILL_TOKENS / dt:.1f} tokens/s (host clock around the "
          f"step, synchronized), launches {launches}, flash bodies "
          f"{bodies}", flush=True)
    _require(launches["flash_attention"] == cfg.n_layers,
             f"prefill launched flash_attention "
             f"{launches['flash_attention']} times, not {cfg.n_layers}")
    _require(bodies == {"wgmma": cfg.n_layers, "cuda_cores": 0},
             f"prefill flash bodies {bodies}, not all wgmma")
    _require(len(records) == cfg.n_layers, "not one attention per layer")
    _require(logits.shape == (1, PREFILL_TOKENS, V)
             and bool(torch.isfinite(logits).all()), "prefill logits")

    pos = torch.arange(PREFILL_TOKENS, device=dev)[None]
    layer_err = 0.0
    for i, (q, k, v, kw, out) in enumerate(records):
        mask = attn_mask(pos, pos, causal=True, window=kw["window"])
        plain = A.core_attention(q, k, v, mask, cap=kw["softcap"])
        layer_err = max(layer_err, _close(
            torch, out, plain, ATTN_TOL["bfloat16"], ATTN_TOL["bfloat16"],
            f"layer {i} (window {kw['window']}) kernel vs core_attention"))
        del plain, mask
    print(f"serve (a) layers: all {len(records)} kernel outputs within "
          f"2e-2 of the plain core_attention on the same q/k/v, max |err| "
          f"{layer_err:.4g}", flush=True)
    prefill_ms = _prefill_ms(torch, prefill, params, prompt)
    print(f"serve (a) prefill timed alone: {prefill_ms:.3f} ms = "
          f"{PREFILL_TOKENS / prefill_ms * 1e3:.1f} tokens/s (CUDA events "
          f"around one prefill, median of {PREFILL_TIMES})", flush=True)

    plain_logits = prefill_plain(params, prompt)
    torch.cuda.synchronize()
    max_err, agree = 0.0, 0
    for c in range(0, PREFILL_TOKENS, 1024):
        a, b = logits[0, c:c + 1024], plain_logits[0, c:c + 1024]
        max_err = max(max_err, (a.float() - b.float()).abs().max().item())
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
    print(f"serve (a) logits vs the plain prefill: max |err| {max_err:.4g}, "
          f"top-1 agrees at {agree}/{PREFILL_TOKENS} = "
          f"{agree / PREFILL_TOKENS:.4f} of positions", flush=True)
    del plain_logits, logits

    # (b) the launcher's loop, then the kernel prefill of its prompts:
    # in bf16 (the serving dtype; reported) and with the same weights
    # widened to f32 (held to the model tolerance).  In bf16 the gemma
    # residual stream sits near |x| ~ 48 (the sqrt(d_model) embed scale),
    # where one bf16 ulp of a layer's update flips the sum by 0.25-1, so
    # any two roundings of the same model part ways over 26 layers: the
    # plain prefill is reported beside the kernel prefill as the control.
    gen.manual_seed(2)
    prompts = torch.randint(2, V, (LAUNCH_BATCH, LAUNCH_PROMPT),
                            generator=gen, device=dev)
    launcher.generate(params, cfg, prompts[:, :4], 2)     # warm-up
    torch.cuda.synchronize()
    steps = LAUNCH_PROMPT + LAUNCH_GEN - 1
    params32 = M.from_state(cfg, {k: t.float() for k, t in
                                  params.state_dict().items()})
    dec_err = None
    for dtname, weights in (("bfloat16", params), ("float32", params32)):
        cuda.reset_launches()
        t0 = time.perf_counter()
        out, step_logits = launcher.generate(weights, cfg, prompts,
                                             LAUNCH_GEN)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        pre = prefill(weights, prompts)
        torch.cuda.synchronize()
        launches_b = dict(cuda.LAUNCHES)
        print(f"serve (b) launcher {dtname}: batch {LAUNCH_BATCH}, prompt "
              f"{LAUNCH_PROMPT}, gen {LAUNCH_GEN}: {steps} decode steps in "
              f"{dt * 1e3:.3f} ms = {dt * 1e3 / steps:.3f} ms per decode "
              f"step (one token for each of {LAUNCH_BATCH} sequences), "
              f"{steps * LAUNCH_BATCH / dt:.1f} tokens/s; launches "
              f"{launches_b}", flush=True)
        _require(out.shape == (LAUNCH_BATCH, LAUNCH_GEN)
                 and bool(((out >= 0) & (out < V)).all()),
                 "generated tokens")
        _require(launches_b["flash_attention"] == cfg.n_layers,
                 "the launcher check's prefill did not run the kernel per "
                 "layer")
        dec = step_logits[:, :LAUNCH_PROMPT]
        _require(bool(torch.isfinite(dec).all()), "decode logits")
        for what, ref in (("kernel prefill", pre),
                          ("plain prefill (control)",
                           prefill_plain(weights, prompts))):
            d = (dec.float() - ref.float()).abs()
            beyond = int((d > MODEL_ATOL + MODEL_RTOL * ref.float().abs())
                         .sum())
            top1 = (dec.argmax(-1) == ref.argmax(-1)).float().mean().item()
            print(f"serve (b) {dtname} decode logits at the {LAUNCH_PROMPT} "
                  f"prompt positions vs the {what}: max |err| "
                  f"{d.max().item():.4g}, {beyond}/{d.numel()} beyond atol "
                  f"{MODEL_ATOL} + rtol {MODEL_RTOL}, top-1 agrees "
                  f"{top1:.4f}", flush=True)
        if dtname == "float32":
            dec_err = _close(torch, dec, pre, MODEL_ATOL, MODEL_RTOL,
                             "f32 teacher-forced decode logits vs the "
                             "kernel prefill")
        del step_logits, pre, dec
    del params32
    _require(dec_err is not None, "the f32 launcher check did not run")
    del params
    keep = {"global": records[1], "local": records[0]}
    windows = [kw["window"] for _, _, _, kw, _ in records]
    del records
    torch.cuda.empty_cache()
    return {"launches": launches["flash_attention"], "layers": keep,
            "windows": windows, "max_abs_err": layer_err,
            "prefill_ms": prefill_ms}


def gather_path(torch, dev, served) -> dict:
    """The dispatch-gather op ``flash_attention(q_rows=...)`` at a gemma2
    global layer's shape, counters reset just before and read after."""
    from repro_torch import cuda
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.kernel import flash_attention_plain
    q, k, v, kw, _ = served["layers"]["global"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rows = _dead_rows(torch, gen, q.shape[0], q.shape[1], dev)
    torch.cuda.synchronize()
    cuda.reset_launches()
    out = attn_ops.flash_attention(q, k, v, True, kw["window"],
                                   kw["softcap"], q_rows=rows)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    _require(launches["flash_attention_gather"] == 1,
             f"gather op launches {launches}")
    _require(cuda.FLASH_BODIES == {"wgmma": 1, "cuda_cores": 0},
             f"gather op flash bodies {cuda.FLASH_BODIES}, not wgmma")
    want = flash_attention_plain(q, k, v, causal=True, window=kw["window"],
                                 softcap=kw["softcap"], q_rows=rows)
    err = _close(torch, out, want, ATTN_TOL["bfloat16"],
                 ATTN_TOL["bfloat16"], "gather op vs plain")
    _require(not bool(out[rows < 0].any()), "gather op: dead rows not zero")
    print(f"gather path: flash_attention(q_rows=...) on q "
          f"{tuple(q.shape)}, {int((rows < 0).sum())} dead rows exact "
          f"zeros, max |err| {err:.4g} vs plain; launches {launches}, "
          f"flash bodies {cuda.FLASH_BODIES}", flush=True)
    return {"launches": launches["flash_attention_gather"], "rows": rows,
            "max_abs_err": err}


def _live_pairs(S: int, window, rows=None) -> int:
    """(query, key) pairs a causal mask (with ``window``) leaves live,
    over the rows that attend (``rows`` >= 0 for the gather)."""
    t = np.arange(S, dtype=np.int64)
    per_row = t + 1 if window is None else np.minimum(t + 1, window)
    if rows is not None:
        live = (rows.cpu().numpy() >= 0)
        return int((live * per_row[None]).sum())
    return int(per_row.sum())


def _body_of(torch, fn, *args) -> str:
    """The flash body one call of ``fn`` ran on."""
    from repro_torch import cuda
    torch.cuda.synchronize()
    before = dict(cuda.FLASH_BODIES)
    fn(*args)
    torch.cuda.synchronize()
    ran = [b for b, n in cuda.FLASH_BODIES.items() if n != before[b]]
    _require(len(ran) == 1, f"not one flash launch: {cuda.FLASH_BODIES}")
    return ran[0]


def _kv_read_bytes(q, k, window, body) -> int:
    """The k/v bytes the body's tiling reads: every CTA (q tile, q head,
    batch) reads each kv tile it visits, k and v, from L2 or device
    memory."""
    from repro_torch.kernels.attention.kernel import (WGMMA_BQ,
                                                      tile_classes, wgmma_bk)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    bq, bk = (WGMMA_BQ, wgmma_bk(D)) if body == "wgmma" else (64, 64)
    tiles = sum(j_hi - j_lo for j_lo, j_hi, _, _ in
                tile_classes(Sq, Sk, bq, bk, True, window))
    return 2 * tiles * bk * D * k.element_size() * H * B


def _attn_stats(row, ms, flops, kv_bytes) -> str:
    """TFLOP/s, share of the bound and k/v bytes read, into ``row`` and
    as text."""
    row.update(tflops=flops / ms / 1e9, bound_share=row["bound_ms"] / ms,
               kv_read_bytes=kv_bytes)
    return (f"{row['tflops']:.1f} TFLOP/s, {row['bound_share']:.3f} of the "
            f"bound, k/v read {kv_bytes / 1e9:.3f} GB = "
            f"{kv_bytes / ms / 1e9:.2f} TB/s")


def _flex(torch, q, k, v, window, cap):
    """``torch.nn.attention.flex_attention`` computing the same function
    (the yardstick; the port never calls it): a softcap ``score_mod``
    and a causal or sliding-window ``mask_mod``, compiled."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def score_mod(score, b, h, q_idx, kv_idx):
        return score if cap is None else cap * torch.tanh(score / cap)

    def mask_mod(b, h, q_idx, kv_idx):
        live = kv_idx <= q_idx
        if window is not None:
            live = live & (kv_idx > q_idx - window)
        return live

    S = q.shape[1]
    block_mask = create_block_mask(mask_mod, None, None, S, S,
                                   device=q.device)
    fn = torch.compile(flex_attention)

    def call(q, k, v):
        return fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  score_mod=score_mod, block_mask=block_mask,
                  enable_gqa=True).transpose(1, 2)
    return call


def _off_alignment(torch, t):
    """A copy of ``t`` whose storage starts 2 bytes past a 16-byte
    boundary, which routes bf16 to the kernel's CUDA-core body."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    u = buf[1:].view(t.shape)
    u.copy_(t)
    return u


def attention_timing(torch, served, gathered, parity_err) -> list[dict]:
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.attention.kernel import flash_attention_plain
    rows_out = {"flash_attention": [], "flash_attention_gather": []}
    cases = [("flash_attention", "global layer", "global", None, False),
             ("flash_attention", "local layer", "local", None, False),
             ("flash_attention", "global layer, CUDA-core body (inputs "
              "off 16-byte alignment; the first version's path)", "global",
              None, True),
             ("flash_attention_gather", "global layer with q_rows (random "
              "permutation, 1/8 dead)", "global", gathered["rows"], False)]
    for name, what, which, rows, unaligned in cases:
        q, k, v, kw, out = served["layers"][which]
        win, cap = kw["window"], kw["softcap"]
        label = (f"{SERVE_ARCH} {what}: q {list(q.shape)} k/v "
                 f"{list(k.shape)} {str(q.dtype)[6:]}, causal, window {win}, "
                 f"softcap {cap}")
        if unaligned:
            q, k, v = (_off_alignment(torch, t) for t in (q, k, v))

        def kern(q, k, v, rows=rows):
            return attn_ops.flash_attention(q, k, v, True, win, cap,
                                            q_rows=rows)

        def plain(q, k, v, rows=rows):
            return flash_attention_plain(q, k, v, causal=True, window=win,
                                         softcap=cap, q_rows=rows)
        body = _body_of(torch, kern, q, k, v)
        _require(body == ("cuda_cores" if unaligned else "wgmma"),
                 f"{label}: ran on the {body} body")
        ms, reps = time_long_ms(torch, kern, q, k, v)
        plain_ms, plain_reps = time_long_ms(torch, plain, q, k, v)
        dev_ms = device_ms(torch, name, kern, q, k, v, reps=LONG_REPS)
        B, S, H, D = q.shape
        pairs = _live_pairs(S, win, rows)
        flops = 4 * D * H * B * pairs
        nbytes = _nbytes(q, k, v, out) + (0 if rows is None
                                          else _nbytes(rows))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_TC_OPS_PER_S * 1e3
        library, library_ms, note = None, None, None
        if unaligned:
            got = kern(q, k, v)
            err = _close(torch, got, plain(q, k, v), ATTN_TOL["bfloat16"],
                         ATTN_TOL["bfloat16"], f"{label} vs plain")
            glob = rows_out["flash_attention"][0]
            library = glob["library_call"]
            library_ms = glob["library_ms"]
            note = (f"max |err| vs plain {err:.4g}; the library call is the "
                    f"global layer's")
        elif rows is None:
            library = ("torch.compile(flex_attention) with a softcap "
                       "score_mod and a causal/window mask_mod")
            try:
                flex = _flex(torch, q, k, v, win, cap)
                flex_err = (flex(q, k, v).float() - out.float()).abs().max()
                library_ms, _ = time_long_ms(torch, flex, q, k, v)
                note = f"flex max |diff| vs kernel {flex_err.item():.4g}"
            except Exception as e:           # the yardstick, not the port
                library = None
                note = (f"none is one call: flex_attention failed on this "
                        f"card ({type(e).__name__}: {str(e)[:200]})")
        else:
            note = ("none is one call: no library call gathers q rows and "
                    "attends in one")
        row = {"case": label, "body": body, "ms": ms, "device_ms": dev_ms,
               "reps": reps, "plain_ms": plain_ms, "plain_reps": plain_reps,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "operations": flops, "live_pairs": pairs,
               "library_ms": library_ms, "library_call": library,
               "library_note": note}
        stats = _attn_stats(row, ms, flops,
                            _kv_read_bytes(q, k, win, body))
        print(f"{name:>22} | {label}: {ms:.4f} ms [device "
              f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms] "
              f"({reps}; {body} body; bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']}, {stats}), plain "
              f"{plain_ms:.4f} ms ({plain_reps}), library "
              f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'} "
              f"[{note}]", flush=True)
        rows_out[name].append(row)
    by_window = {None: rows_out["flash_attention"][0]["ms"],
                 served["layers"]["local"][3]["window"]:
                 rows_out["flash_attention"][1]["ms"]}
    attn_ms = sum(by_window[w] for w in served["windows"])
    print(f"serve (a) attention share of the {SERVE_ARCH} prefill: "
          f"{attn_ms:.3f} ms of its {len(served['windows'])} layers (the "
          f"timed global and local cases) / {served['prefill_ms']:.3f} ms "
          f"= {attn_ms / served['prefill_ms']:.3f}", flush=True)
    result = []
    for name, source, tpu, info in (
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/attention/kernel.py:25", served),
            ("flash_attention_gather",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/attention/kernel.py:66", gathered)):
        first = rows_out[name][0]
        result.append({"name": name, "route": "cuda", "source": source,
                       "replaces": tpu, "launches": info["launches"],
                       "max_abs_err": max(info["max_abs_err"],
                                          parity_err[name]),
                       "ms": first["ms"], "plain_ms": first["plain_ms"],
                       "bound_ms": first["bound_ms"],
                       "bound_by": first["bound_by"],
                       "library_ms": first["library_ms"],
                       "cases": rows_out[name]})
    return result



# ---------------------------------------------------------------------------
# wkv6: parity, rwkv6-3b served at full width, timing
# ---------------------------------------------------------------------------

# the reference's kernel tolerances (tests/test_kernels.py:19-21)
WKV_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WKV_SHAPES = [(1, 16, 1, 8), (2, 64, 3, 16), (1, 128, 2, 32),
              (2, 48, 4, 8),                   # the reference's sweep
              (1, 256, 40, 64),                # rwkv6-3b's heads
              (2, 200, 40, 64),                # T no multiple of 64
              (1, 70, 4, 128)]
WKV_DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
              ("bfloat16", "float32")]         # last: the model's mix
# the chunk-parallel scan's edges, B = 2 so that the batch offsets of
# its scratch are exercised: (B, T, H, N, chunk), chunk None for the
# wrapper's own pick: T below, at and one past a chunk, a multiple of
# it, T = 200, T = 8192 over many chunks, head size 128
WKV_EDGES = [(2, 63, 4, 64, 64), (2, 64, 4, 64, 64), (2, 65, 4, 64, 64),
             (2, 512, 4, 64, 64), (2, 200, 40, 64, None),
             (2, 8192, 8, 64, None), (2, 300, 2, 128, 128)]
WKV_EXTREME_CHUNKS = [16, 64]    # decay extremes at these chunks
RWKV_ARCH = "rwkv6-3b"
RWKV_GROUP = 8                   # layers per plain-version call


def _wkv_inputs(torch, gen, dev, B, T, H, N, rkv, wdt):
    """r, k, v ~ normal in ``rkv``; w = exp(-exp(normal)) in ``wdt``, as
    the reference's sweep draws it; u ~ normal, f32."""
    r, k, v = (torch.randn((B, T, H, N), generator=gen, device=dev
                           ).to(getattr(torch, rkv)) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, T, H, N), generator=gen,
                                         device=dev))).to(getattr(torch, wdt))
    u = torch.randn((H, N), generator=gen, device=dev)
    return r, k, v, w, u


def wkv6_parity(torch, dev) -> float:
    """The kernel against its plain version; returns the max |err|."""
    from repro_torch import cuda
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6.kernel import wkv6_bthn, wkv6_plain
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    checked, worst = 0, {}
    for B, T, H, N in WKV_SHAPES:
        for rkv, wdt in WKV_DTYPES:
            args = _wkv_inputs(torch, gen, dev, B, T, H, N, rkv, wdt)
            n0 = cuda.LAUNCHES["wkv6"]
            got = wkv6_bthn(*args)
            torch.cuda.synchronize()
            _require(cuda.LAUNCHES["wkv6"] == n0 + 1,
                     "wkv6: not one launch per call")
            tol = WKV_TOL["float32" if rkv == wdt == "float32"
                          else "bfloat16"]
            key = f"r/k/v {rkv}, w {wdt}"
            err = _close(torch, got, wkv6_plain(*args), tol, tol,
                         f"wkv6 B={B} T={T} H={H} N={N} {key}")
            worst[key] = max(worst.get(key, 0.0), err)
            checked += 1
    print(f"wkv6 parity: {checked} kernel calls (the reference's sweep "
          f"shapes, N=64 at H=40, T=200 and T=70; f32, bf16 and bf16 r/k/v "
          f"with f32 w) within atol=rtol 2e-5 (all f32) / 2e-2 (bf16 "
          f"inputs); max |err| {worst}; {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    runs = []
    for B, T, H, N, chunk in WKV_EDGES:
        for rkv, wdt in WKV_DTYPES:
            args = _wkv_inputs(torch, gen, dev, B, T, H, N, rkv, wdt)
            n0 = cuda.LAUNCHES["wkv6"]
            got = wkv6_bthn(*args, chunk=chunk)
            torch.cuda.synchronize()
            run = dict(wkv_kernel.LAST_LAUNCH)
            C = chunk or wkv_kernel.wkv6_chunk(B, T, H, N)
            _require(cuda.LAUNCHES["wkv6"] == n0 + 1
                     and run["chunk"] == C and run["chunks"] == -(-T // C),
                     f"wkv6 T={T} chunk {chunk}: launch record {run}")
            tol = WKV_TOL["float32" if rkv == wdt == "float32"
                          else "bfloat16"]
            key = f"r/k/v {rkv}, w {wdt}"
            err = _close(torch, got, wkv6_plain(*args), tol, tol,
                         f"wkv6 B={B} T={T} H={H} N={N} chunk {C} {key}")
            worst[key] = max(worst[key], err)
            checked += 1
        runs.append(f"T={T} N={N}: chunk {run['chunk']} x {run['chunks']}")
    for C in WKV_EXTREME_CHUNKS:
        for rkv in ("float32", "bfloat16"):
            B, T, H, N = 2, 5 * C + 3, 3, 64
            r, k, v, _, u = _wkv_inputs(torch, gen, dev, B, T, H, N, rkv,
                                        "float32")
            # w = exp(-exp(x)), x up to +5: exactly 0 in f32 past ~4.6;
            # channels of exact 0 and 1; a chunk of zero decays in every
            # head, and one more in one head of one batch row
            x = 8.0 * torch.rand((B, T, H, N), generator=gen,
                                 device=dev) - 3.0
            w = torch.exp(-torch.exp(x))
            w[..., 0] = 0.0
            w[..., 1] = 1.0
            w[:, C:2 * C] = 0.0
            w[1, 3 * C:4 * C, 2] = 0.0
            got = wkv6_bthn(r, k, v, w, u, chunk=C)
            _require(bool(torch.isfinite(got).all()),
                     f"wkv6 decay extremes chunk {C}: non-finite")
            tol = WKV_TOL["float32" if rkv == "float32" else "bfloat16"]
            key = f"decay extremes, r/k/v {rkv}"
            worst[key] = max(worst.get(key, 0.0), _close(
                torch, got, wkv6_plain(r, k, v, w, u), tol, tol,
                f"wkv6 decay extremes chunk {C} r/k/v {rkv}"))
            checked += 1
    print(f"wkv6 parity, chunk edges and decay extremes: {checked} kernel "
          f"calls in all ({'; '.join(runs)}; w with exact 0s, 1s and "
          f"zero chunks at chunks {WKV_EXTREME_CHUNKS}); max |err| {worst}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return max(worst.values())


def rwkv_serve_path(torch, dev) -> dict:
    """rwkv6-3b at full width: (a) the kernel prefill of one 8192-token
    prompt, (b) the launcher's loop on the O(1) decode state, each with
    the counters reset just before and read just after."""
    from repro_torch import configs, cuda
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.kernel import wkv6_plain
    from repro_torch.launch import serve as launcher
    from repro_torch.models import model as M
    from repro_torch.serve import ServeOptions, make_prefill_step

    cfg = configs.get_config(RWKV_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    print(f"rwkv: device memory {mem0 / 2**30:.2f} GiB allocated before "
          f"the weights", flush=True)
    print(f"rwkv: {RWKV_ARCH} at full width, {cfg.n_layers} layers, "
          f"{cfg.param_count():,} parameters (bf16 projections, f32 decay/"
          f"mix/bonus/norm vectors; random from seed 0) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    V = cfg.vocab_size
    prefill = make_prefill_step(cfg, ServeOptions(use_kernel=True))
    prefill_plain = make_prefill_step(cfg, ServeOptions(use_kernel=False))
    gen.manual_seed(1)
    prompt = torch.randint(2, V, (1, PREFILL_TOKENS), generator=gen,
                           device=dev)
    prefill(params, prompt[:, :256])             # warm-up, not counted
    torch.cuda.synchronize()

    # (a) the kernel prefill, recording each layer's wkv6 inputs
    records = []
    real_op = wkv_ops.wkv6

    def recording(r, k, v, w, u, *args, **kw):
        out = real_op(r, k, v, w, u, *args, **kw)
        records.append((r, k, v, w, u, out))
        return out

    wkv_ops.wkv6 = recording
    try:
        cuda.reset_launches()
        t0 = time.perf_counter()
        logits = prefill(params, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = dict(cuda.LAUNCHES)
    finally:
        wkv_ops.wkv6 = real_op
    print(f"rwkv (a) prefill: B=1 S={PREFILL_TOKENS} in "
          f"{prefill_s * 1e3:.3f} ms = {PREFILL_TOKENS / prefill_s:.1f} "
          f"tokens/s (host clock around the "
          f"step, synchronized), launches {launches}; each wkv6 call "
          f"{wkv_kernel.LAST_LAUNCH}", flush=True)
    _require(launches["wkv6"] == cfg.n_layers,
             f"prefill launched wkv6 {launches['wkv6']} times, not "
             f"{cfg.n_layers}")
    _require(len(records) == cfg.n_layers, "not one wkv6 per layer")
    _require(logits.shape == (1, PREFILL_TOKENS, V)
             and bool(torch.isfinite(logits).all()), "prefill logits")
    r0, k0, v0, w0, u0, _ = records[0]
    _require(r0.dtype == torch.bfloat16 and w0.dtype == torch.float32
             and u0.dtype == torch.float32,
             "the model does not call wkv6 with bf16 r/k/v, f32 w and u")

    # every layer against the plain version on its own inputs: the heads
    # of RWKV_GROUP layers side by side (heads are independent) per call
    print(f"rwkv (a) device memory: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated after the prefill ({len(records)} layers' wkv6 "
          f"inputs and outputs recorded)", flush=True)
    H = r0.shape[2]
    layer_err = 0.0
    for g0 in range(0, len(records), RWKV_GROUP):
        group = records[g0:g0 + RWKV_GROUP]
        plain = wkv6_plain(*(torch.cat([rec[i] for rec in group], dim=2)
                             for i in range(4)),
                           torch.cat([rec[4] for rec in group], 0))
        for i, rec in enumerate(group):
            layer_err = max(layer_err, _close(
                torch, rec[5], plain[:, :, i * H:(i + 1) * H],
                WKV_TOL["bfloat16"], WKV_TOL["bfloat16"],
                f"layer {g0 + i} wkv6 kernel vs wkv6_plain"))
        del plain
    print(f"rwkv (a) layers: all {len(records)} wkv6 outputs within 2e-2 "
          f"of wkv6_plain on the same inputs, max |err| {layer_err:.4g}",
          flush=True)
    prefill_ms = _prefill_ms(torch, prefill, params, prompt)
    print(f"rwkv (a) prefill timed alone: {prefill_ms:.3f} ms = "
          f"{PREFILL_TOKENS / prefill_ms * 1e3:.1f} tokens/s (CUDA events "
          f"around one prefill, median of {PREFILL_TIMES})", flush=True)

    t0 = time.perf_counter()
    plain_logits = prefill_plain(params, prompt)
    torch.cuda.synchronize()
    plain_dt = time.perf_counter() - t0
    max_err, per_block = 0.0, []
    for c in range(0, PREFILL_TOKENS, 1024):
        a, b = logits[0, c:c + 1024], plain_logits[0, c:c + 1024]
        max_err = max(max_err, (a.float() - b.float()).abs().max().item())
        per_block.append(int((a.argmax(-1) == b.argmax(-1)).sum()))
    agree = sum(per_block)
    print(f"rwkv (a) logits vs the plain prefill ({plain_dt * 1e3:.1f} ms): "
          f"max |err| {max_err:.4g}, top-1 agrees at {agree}/"
          f"{PREFILL_TOKENS} = {agree / PREFILL_TOKENS:.4f} of positions; "
          f"per 1024 positions, in order: {per_block}", flush=True)
    del plain_logits, logits

    # (b) the launcher's loop on the decode state, then the kernel
    # prefill of its prompts: bf16 reported, f32 held to the tolerance
    gen.manual_seed(2)
    prompts = torch.randint(2, V, (LAUNCH_BATCH, LAUNCH_PROMPT),
                            generator=gen, device=dev)
    launcher.generate(params, cfg, prompts[:, :4], 2)     # warm-up
    torch.cuda.synchronize()
    steps = LAUNCH_PROMPT + LAUNCH_GEN - 1
    params32 = M.from_state(cfg, {k: t.float() for k, t in
                                  params.state_dict().items()})
    dec_err = None
    for dtname, weights in (("bfloat16", params), ("float32", params32)):
        cuda.reset_launches()
        t0 = time.perf_counter()
        out, step_logits = launcher.generate(weights, cfg, prompts,
                                             LAUNCH_GEN)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        pre = prefill(weights, prompts)
        torch.cuda.synchronize()
        launches_b = dict(cuda.LAUNCHES)
        print(f"rwkv (b) launcher {dtname}: batch {LAUNCH_BATCH}, prompt "
              f"{LAUNCH_PROMPT}, gen {LAUNCH_GEN}: {steps} decode steps in "
              f"{dt * 1e3:.3f} ms = {dt * 1e3 / steps:.3f} ms per decode "
              f"step (one token for each of {LAUNCH_BATCH} sequences), "
              f"{steps * LAUNCH_BATCH / dt:.1f} tokens/s; launches "
              f"{launches_b}", flush=True)
        _require(out.shape == (LAUNCH_BATCH, LAUNCH_GEN)
                 and bool(((out >= 0) & (out < V)).all()),
                 "generated tokens")
        _require(launches_b["wkv6"] == cfg.n_layers,
                 "the launcher check's prefill did not run wkv6 per layer")
        dec = step_logits[:, :LAUNCH_PROMPT]
        _require(bool(torch.isfinite(dec).all()), "decode logits")
        for what, ref in (("kernel prefill", pre),
                          ("plain prefill (control)",
                           prefill_plain(weights, prompts))):
            d = (dec.float() - ref.float()).abs()
            beyond = int((d > MODEL_ATOL + MODEL_RTOL * ref.float().abs())
                         .sum())
            hit = (dec.argmax(-1) == ref.argmax(-1)).float()
            by_pos = [round(hit[:, i:i + 8].mean().item(), 4)
                      for i in range(0, LAUNCH_PROMPT, 8)]
            print(f"rwkv (b) {dtname} decode logits at the {LAUNCH_PROMPT} "
                  f"prompt positions vs the {what}: max |err| "
                  f"{d.max().item():.4g}, {beyond}/{d.numel()} beyond atol "
                  f"{MODEL_ATOL} + rtol {MODEL_RTOL}, top-1 agrees "
                  f"{hit.mean().item():.4f} (per 8 positions, in order: "
                  f"{by_pos}); max |err| at position 0: "
                  f"{d[:, 0].max().item():.4g}", flush=True)
        # the model's own rounding floor: the same plain prefill run on
        # the first half of the prompts only (other matmul shapes, so
        # other roundings; in exact arithmetic the logits are equal)
        half = LAUNCH_PROMPT // 2
        full = prefill_plain(weights, prompts)[:, :half]
        part = prefill_plain(weights, prompts[:, :half])
        d = (full.float() - part.float()).abs()
        print(f"rwkv (b) {dtname} control: the plain prefill of the first "
              f"{half} prompt tokens vs the plain prefill of all "
              f"{LAUNCH_PROMPT} at those positions: max |err| "
              f"{d.max().item():.4g}, top-1 agrees "
              f"{(full.argmax(-1) == part.argmax(-1)).float().mean().item():.4f}",
              flush=True)
        if dtname == "float32":
            dec_err = _close(torch, dec, pre, MODEL_ATOL, MODEL_RTOL,
                             "f32 teacher-forced decode logits vs the "
                             "kernel prefill")
        del step_logits, pre, dec, full, part
    del params32, params
    _require(dec_err is not None, "the f32 launcher check did not run")
    keep = records[0]
    del records
    torch.cuda.empty_cache()
    return {"launches": launches["wkv6"], "layer": keep,
            "max_abs_err": layer_err, "prefill_ms": prefill_ms}


def wkv6_timing(torch, served, parity_err, dev_ms, dev_split) -> list[dict]:
    """The kernel at one rwkv6-3b layer's prefill inputs, beside its
    plain version and the bound (``dev_ms`` per call and ``dev_split``
    per phase, from ``early_device_ms``)."""
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.kernel import wkv6_plain
    r, k, v, w, u, out = served["layer"]
    B, T, H, N = r.shape
    label = (f"{RWKV_ARCH} layer prefill: r/k/v {list(r.shape)} "
             f"{str(r.dtype)[6:]}, w {str(w.dtype)[6:]}, u {list(u.shape)} "
             f"{str(u.dtype)[6:]}, y f32")
    ms, reps = time_long_ms(torch, wkv_ops.wkv6, r, k, v, w, u)
    run = dict(wkv_kernel.LAST_LAUNCH)
    print(f"{'wkv6':>22} | chunk {run['chunk']} steps x {run['chunks']} "
          f"chunks; grids: state {run['grids']['state']}, carry "
          f"{run['grids']['carry']}, out {run['grids']['out']}; scratch "
          f"{run['scratch_bytes']} B; device ms per call by phase "
          f"{dev_split}", flush=True)
    plain_ms, plain_reps = time_long_ms(torch, wkv6_plain, r, k, v, w, u)
    nbytes = _nbytes(r, k, v, w, u, out)
    ops = 4 * N * N * T * H * B     # S update and r.S: one FMA per entry
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    note = ("none is one call: no PyTorch call runs a data-dependent-decay "
            "linear recurrence")
    row = {"case": label, "ms": ms, "device_ms": dev_ms,
           "device_split_ms": dev_split, "launch": run, "reps": reps,
           "plain_ms": plain_ms, "plain_reps": plain_reps,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "operations": ops, "library_ms": None,
           "library_call": None, "library_note": note}
    print(f"{'wkv6':>22} | {label}: {ms:.4f} ms [device "
          f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms] ({reps}; "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
          f"{nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms "
          f"({plain_reps}), library n/a [{note}]", flush=True)
    share = served["launches"] * ms / served["prefill_ms"]
    print(f"{'wkv6':>22} | share of {RWKV_ARCH}'s prefill: "
          f"{served['launches']} x {ms:.4f} ms / {served['prefill_ms']:.3f} "
          f"ms = {share:.3f}", flush=True)
    row["prefill_share"] = share
    return [{"name": "wkv6", "route": "cuda",
             "source": "src/repro_torch/csrc/wkv6.cu",
             "replaces": "src/repro/kernels/wkv6/kernel.py:25",
             "launches": served["launches"],
             "max_abs_err": max(served["max_abs_err"], parity_err),
             "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": None, "cases": [row]}]


# ---------------------------------------------------------------------------
# the selective scan: parity, jamba-1.5-large-398b's one-card cut served,
# timing
# ---------------------------------------------------------------------------

# the reference's kernel tolerances (tests/test_kernels.py:19-21)
SCAN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_SHAPES = [(1, 16, 8, 4), (2, 64, 32, 8), (1, 128, 64, 16),
               (2, 48, 24, 8),                 # the reference's sweep
               (1, 200, 1024, 16),             # T no multiple of 64
               (2, 77, 300, 8), (3, 33, 130, 4),
               (4, 40, 16384, 16), (2, 24, 16384, 8),  # 2 groups a CTA
               # T of 1 and one either side of the plan's 32-step tile;
               # Di tails (bf16 rows of 260 and 600 bytes: plain loads)
               (2, 1, 24, 16), (1, 31, 130, 8), (2, 33, 300, 4),
               (1, 31, 24, 16), (1, 33, 8192, 16)]
# xc (and B, C), dt; the last is the f32 model's mix
SCAN_DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
               ("float32", "bfloat16")]
JAMBA_ARCH = "jamba-1.5-large-398b"
HELD_LAYERS = 5          # layers 0-4: mamba+mlp, mamba+moe, attn+mlp
HELD_PROMPT, HELD_GEN = 32, 4
H100_SMS = 132
SFU_EXPS_PER_CLOCK_PER_SM = 16   # H100 special-function units (ex2)


def _scan_inputs(torch, gen, dev, B, T, Di, S, x, dt):
    """As the reference's sweep draws them: xc, B, C ~ normal, dt = 0.1
    |normal|, A = -exp(normal), D ~ normal; xc, B and C in ``x``, dt in
    ``dt``, A and D f32."""
    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev)
    return (rnd((B, T, Di)).to(getattr(torch, x)),
            (rnd((B, T, Di)).abs() * 0.1).to(getattr(torch, dt)),
            rnd((B, T, S)).to(getattr(torch, x)),
            rnd((B, T, S)).to(getattr(torch, x)),
            -torch.exp(rnd((Di, S))), rnd((Di,)))


def mamba_scan_parity(torch, dev) -> float:
    """The kernel against its plain version; returns the max |err|."""
    from repro_torch import cuda
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan.kernel import (selective_scan_bdt,
                                                       selective_scan_plain)
    from repro_torch.kernels.mamba_scan.tiles import selective_scan_tiles
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    checked, worst, loads = 0, {}, set()

    def check(args, tol, key, what):
        nonlocal checked
        n0 = cuda.LAUNCHES["mamba_scan"]
        got = selective_scan_bdt(*args)
        torch.cuda.synchronize()
        _require(cuda.LAUNCHES["mamba_scan"] == n0 + 1,
                 "mamba_scan: not one launch per call")
        err = _close(torch, got, selective_scan_plain(*args), tol, tol,
                     f"mamba_scan {what} {key}")
        worst[key] = max(worst.get(key, 0.0), err)
        loads.add(tuple(scan_kernel.LAST_LAUNCH["loads"].values()))
        checked += 1

    for B, T, Di, S in SCAN_SHAPES:
        for dts in SCAN_DTYPES:
            args = _scan_inputs(torch, gen, dev, B, T, Di, S, *dts)
            tol = SCAN_TOL["float32" if set(dts) == {"float32"}
                           else "bfloat16"]
            check(args, tol, "xc/B/C {}, dt {}".format(*dts),
                  f"B={B} T={T} Di={Di} S={S}")
    # xc and dt as views one element into wider rows (off 16 bytes: the
    # producer's plain loads), B and C views of one projection
    B, T, Di, S = 2, 75, 192, 16
    xd = torch.randn((B, T, 2 * Di + 1), generator=gen, device=dev).to(
        torch.bfloat16)
    wide = torch.zeros((B, T, Di + 1), device=dev, dtype=torch.bfloat16)
    wide[..., 1:] = xd[..., Di + 1:].abs() * 0.1
    proj = torch.randn((B, T, 8 + 2 * S), generator=gen, device=dev).to(
        torch.bfloat16)
    *_, A, D = _scan_inputs(torch, gen, dev, B, T, Di, S, "float32",
                            "float32")
    check((xd[..., 1:Di + 1], wide[..., 1:], proj[..., 8:8 + S],
           proj[..., 8 + S:], A, D), SCAN_TOL["bfloat16"], "strided bf16",
          f"B={B} T={T} Di={Di} S={S}")
    _require(("plain", "plain") in loads and ("tma", "tma") in loads,
             f"mamba_scan parity: loads {loads}, not both paths")
    # dt A below -126 ln 2 on half the states: ex2.ftz gives exact zeros
    xc, dt, Bc, Cc, A, D = _scan_inputs(torch, gen, dev, 1, 64, 256, 16,
                                        "float32", "float32")
    A[:, ::2] = -45.0
    check((xc, torch.full_like(dt, 2.0), Bc, Cc, A, D),
          SCAN_TOL["float32"], "ftz f32", "dt A = -90")
    # the CPU twin of the kernel's order of adds: bit for bit where no exp
    # rounds (A = 0), and the gap that ex2.approx leaves with A drawn
    xc, dt, Bc, Cc, A, D = _scan_inputs(torch, gen, dev, 2, 70, 130, 16,
                                        "float32", "float32")
    twin_gap = {}
    for what, a in (("A = 0", torch.zeros_like(A)), ("A drawn", A)):
        args = (xc, dt, Bc, Cc, a, D)
        got = selective_scan_bdt(*args).cpu()
        twin = selective_scan_tiles(*(t.cpu() for t in args))
        twin_gap[what] = (got - twin).abs().max().item()
    _require(twin_gap["A = 0"] == 0.0,
             f"mamba_scan: off its CPU twin with A = 0 ({twin_gap})")
    print(f"mamba_scan parity: {checked} kernel calls (the reference's "
          f"sweep shapes, T=200/77/33/40/24/31/1, Di=1024/300/130/24/8192/"
          f"16384, S 4/8/16, one and two groups of 32 channels a CTA; f32, "
          f"bf16 and bf16 dt with f32 xc/B/C; strided bf16 views on the "
          f"plain-load path; dt A = -90 flushed to zero) within atol=rtol "
          f"2e-5 (all f32) / 2e-2 (bf16 inputs); loads {sorted(loads)}; "
          f"max |err| {worst}; kernel vs CPU twin [2, 70, 130] S 16 f32, "
          f"max |diff| {twin_gap}; {time.perf_counter() - t0:.2f} s",
          flush=True)
    return max(worst.values())


def _record(module, name, sink, keep):
    """Replace ``module.name`` by a wrapper that appends ``keep(args,
    out)`` to ``sink``; returns the original."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        sink.append(keep(args, kw, out))
        return out
    setattr(module, name, wrapper)
    return real


def jamba_serve_path(torch, dev) -> dict:
    """jamba-1.5-large-398b's one-card cut: (a) the kernel prefill of one
    8192-token prompt, (b) the launcher's loop in bf16, (c) layers 0-4
    widened to f32 at batch 1, each with the counters reset just before
    and read just after."""
    from torch import nn
    from repro_torch import configs, cuda
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan.kernel import selective_scan_plain
    from repro_torch.launch import serve as launcher
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.serve import ServeOptions, make_prefill_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"jamba: device memory {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB allocated before the phase (the earlier phases' models "
          f"freed)", flush=True)
    cfg = configs.get_one_card(JAMBA_ARCH)
    lo, hi = cfg.moe.held_range()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    wbytes = _nbytes(*params.parameters())
    print(f"jamba: {cfg.name}: {cfg.n_layers} layers (one period) at full "
          f"width, experts {lo}-{hi - 1} of {cfg.moe.n_experts} held, "
          f"{cfg.param_count():,} parameters = {wbytes / 1e9:.2f} GB (bf16; "
          f"f32 router/dt_bias/A_log/D; random from seed 0) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    V = cfg.vocab_size
    n_mamba = sum(s.mixer == "mamba" for s in cfg.blocks())
    n_attn = sum(s.mixer == "attn" for s in cfg.blocks())
    prefill = make_prefill_step(cfg, ServeOptions(use_kernel=True))
    prefill_plain = make_prefill_step(cfg, ServeOptions(use_kernel=False))
    gen.manual_seed(1)
    prompt = torch.randint(2, V, (1, PREFILL_TOKENS), generator=gen,
                           device=dev)
    prefill(params, prompt[:, :256])             # warm-up, not counted
    torch.cuda.synchronize()

    # (a) the kernel prefill, recording each mamba layer's scan inputs,
    # the attention layer's q/k/v and each layer's largest |residual|
    scans, attns, resid = [], [], []
    reals = [(scan_ops, "selective_scan", _record(
                 scan_ops, "selective_scan", scans,
                 lambda a, kw, out: (*a[:6], out))),
             (attn_ops, "flash_attention", _record(
                 attn_ops, "flash_attention", attns,
                 lambda a, kw, out: (*a[:3], kw, out))),
             (blocks, "forward", _record(
                 blocks, "forward", resid,
                 lambda a, kw, out: out.abs().max()))]
    try:
        cuda.reset_launches()
        t0 = time.perf_counter()
        logits = prefill(params, prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = dict(cuda.LAUNCHES)
        bodies = dict(cuda.FLASH_BODIES)
    finally:
        for module, name, real in reals:
            setattr(module, name, real)
    print(f"jamba (a) prefill: B=1 S={PREFILL_TOKENS} in "
          f"{prefill_s * 1e3:.3f} ms = {PREFILL_TOKENS / prefill_s:.1f} "
          f"tokens/s (host clock around the step, synchronized; the "
          f"residual and input recording included), launches {launches}, "
          f"flash bodies {bodies}", flush=True)
    _require(launches["mamba_scan"] == n_mamba == 7,
             f"prefill launched mamba_scan {launches['mamba_scan']} times, "
             f"not {n_mamba}")
    _require(launches["flash_attention"] == n_attn == 1,
             f"prefill launched flash_attention "
             f"{launches['flash_attention']} times, not {n_attn}")
    _require(bodies == {"wgmma": n_attn, "cuda_cores": 0},
             f"prefill flash bodies {bodies}, not all wgmma")
    _require(len(scans) == n_mamba and len(resid) == cfg.n_layers,
             "not one scan per mamba layer")
    _require(logits.shape == (1, PREFILL_TOKENS, V)
             and bool(torch.isfinite(logits).all()), "prefill logits")
    xc0, dt0, b0, *_ = scans[0]
    _require(xc0.dtype == dt0.dtype == b0.dtype == torch.bfloat16,
             "the bf16 model does not call the scan with bf16 xc/dt/B/C")
    print(f"jamba (a) largest |residual| after each layer: "
          f"{[round(float(r), 2) for r in resid]} (bf16; one ulp at 1e4 "
          f"is 64)", flush=True)
    print(f"jamba (a) device memory: {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated after the prefill ({len(scans)} layers' scan "
          f"inputs and outputs recorded)", flush=True)

    layer_err = 0.0
    for i, (*args, out) in enumerate(scans):
        layer_err = max(layer_err, _close(
            torch, out, selective_scan_plain(*args), SCAN_TOL["bfloat16"],
            SCAN_TOL["bfloat16"], f"mamba layer {i} scan kernel vs "
            f"selective_scan_plain"))
    print(f"jamba (a) layers: all {len(scans)} mamba layers' scan outputs "
          f"within 2e-2 of selective_scan_plain on the same inputs, max "
          f"|err| {layer_err:.4g}", flush=True)
    keep = {"scan": scans[0], "attn": attns[0]}
    del scans, attns, xc0, dt0, b0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    plain_logits = prefill_plain(params, prompt)
    torch.cuda.synchronize()
    plain_dt = time.perf_counter() - t0
    max_err, per_block = 0.0, []
    for c in range(0, PREFILL_TOKENS, 1024):
        a, b = logits[0, c:c + 1024], plain_logits[0, c:c + 1024]
        max_err = max(max_err, (a.float() - b.float()).abs().max().item())
        per_block.append(int((a.argmax(-1) == b.argmax(-1)).sum()))
    agree = sum(per_block)
    print(f"jamba (a) logits vs the plain prefill ({plain_dt * 1e3:.1f} ms; "
          f"reported, not held: past layer 1 the bf16 residual sits near "
          f"1e4): max |err| {max_err:.4g}, top-1 agrees at {agree}/"
          f"{PREFILL_TOKENS} = {agree / PREFILL_TOKENS:.4f} of positions; "
          f"per 1024 positions, in order: {per_block}", flush=True)
    del plain_logits, logits
    prefill_ms = _prefill_ms(torch, prefill, params, prompt)
    print(f"jamba (a) prefill timed alone: {prefill_ms:.3f} ms = "
          f"{PREFILL_TOKENS / prefill_ms * 1e3:.1f} tokens/s (CUDA events "
          f"around one prefill, median of {PREFILL_TIMES})", flush=True)

    # (b) the launcher's loop in bf16 (reported: at batch 4 the capacity
    # dispatch's C is 1 and drops pairs), then the kernel prefill of its
    # prompts
    gen.manual_seed(2)
    prompts = torch.randint(2, V, (LAUNCH_BATCH, LAUNCH_PROMPT),
                            generator=gen, device=dev)
    launcher.generate(params, cfg, prompts[:, :4], 2)     # warm-up
    torch.cuda.synchronize()
    steps = LAUNCH_PROMPT + LAUNCH_GEN - 1
    cuda.reset_launches()
    t0 = time.perf_counter()
    out, step_logits = launcher.generate(params, cfg, prompts, LAUNCH_GEN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pre = prefill(params, prompts)
    torch.cuda.synchronize()
    launches_b = dict(cuda.LAUNCHES)
    print(f"jamba (b) launcher bfloat16: batch {LAUNCH_BATCH}, prompt "
          f"{LAUNCH_PROMPT}, gen {LAUNCH_GEN}: {steps} decode steps in "
          f"{dt * 1e3:.3f} ms = {dt * 1e3 / steps:.3f} ms per decode step "
          f"(one token for each of {LAUNCH_BATCH} sequences), "
          f"{steps * LAUNCH_BATCH / dt:.1f} tokens/s; launches {launches_b}",
          flush=True)
    _require(out.shape == (LAUNCH_BATCH, LAUNCH_GEN)
             and bool(((out >= 0) & (out < V)).all()), "generated tokens")
    _require(launches_b["mamba_scan"] == n_mamba,
             "the launcher check's prefill did not run the scan per layer")
    dec = step_logits[:, :LAUNCH_PROMPT]
    _require(bool(torch.isfinite(dec).all()), "decode logits")
    d = (dec.float() - pre.float()).abs()
    hit = (dec.argmax(-1) == pre.argmax(-1)).float()
    print(f"jamba (b) bfloat16 decode logits at the {LAUNCH_PROMPT} prompt "
          f"positions vs the kernel prefill (reported): max |err| "
          f"{d.max().item():.4g}, {int((d > MODEL_ATOL + MODEL_RTOL * pre.float().abs()).sum())}"
          f"/{d.numel()} beyond atol {MODEL_ATOL} + rtol {MODEL_RTOL}, top-1 "
          f"agrees {hit.mean().item():.4f}", flush=True)
    del step_logits, pre, dec, d

    # (c) layers 0-4 (every kind of layer) with the same weights widened
    # to f32, at batch 1, where the capacity dispatch drops nothing: the
    # teacher-forced decode logits held to the model tolerance against
    # the kernel prefill's
    params.layers = nn.ModuleList(list(params.layers)[:HELD_LAYERS])
    torch.cuda.empty_cache()
    for p in params.parameters():
        p.data = p.data.float()
        if p.numel() >= 1 << 28:
            # hand each freed bf16 expert stack back at once: cached, the
            # freed blocks fragment the ~6 GiB f32 stacks' room (an OOM
            # with 17 GiB reserved but free, seen on the card)
            torch.cuda.empty_cache()
    cfg5 = dataclasses.replace(cfg, name=f"{cfg.name}-layers-0-4",
                               period=cfg.period[:HELD_LAYERS])
    prefill5 = make_prefill_step(cfg5, ServeOptions(use_kernel=True))
    print(f"jamba (c) layers 0-{HELD_LAYERS - 1} "
          f"({[(s.mixer, s.ff) for s in cfg5.blocks()]}) widened to f32: "
          f"{_nbytes(*params.parameters()) / 1e9:.2f} GB, device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated",
          flush=True)
    gen.manual_seed(3)
    prompt1 = torch.randint(2, V, (1, HELD_PROMPT), generator=gen, device=dev)
    cuda.reset_launches()
    t0 = time.perf_counter()
    out1, step_logits = launcher.generate(params, cfg5, prompt1, HELD_GEN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pre = prefill5(params, prompt1)
    torch.cuda.synchronize()
    launches_c = dict(cuda.LAUNCHES)
    steps1 = HELD_PROMPT + HELD_GEN - 1
    print(f"jamba (c) launcher float32: batch 1, prompt {HELD_PROMPT}, gen "
          f"{HELD_GEN}: {steps1} decode steps in {dt * 1e3:.3f} ms = "
          f"{dt * 1e3 / steps1:.3f} ms per step; launches {launches_c}",
          flush=True)
    _require(launches_c["mamba_scan"] == HELD_LAYERS - 1,
             "the held check's prefill did not run the scan per layer")
    dec = step_logits[:, :HELD_PROMPT]
    dec_err = _close(torch, dec, pre, MODEL_ATOL, MODEL_RTOL,
                     "f32 teacher-forced decode logits (layers 0-4, batch "
                     "1) vs the kernel prefill")
    print(f"jamba (c) float32 decode logits at the {HELD_PROMPT} prompt "
          f"positions vs the kernel prefill: max |err| {dec_err:.4g} "
          f"(within atol {MODEL_ATOL} + rtol {MODEL_RTOL}; the two differ by "
          f"dt's bf16 rounding on the kernel path and the decode state's "
          f"bf16 conv window), top-1 agrees "
          f"{(dec.argmax(-1) == pre.argmax(-1)).float().mean().item():.4f}, "
          f"max |logit| {pre.abs().max().item():.4g}", flush=True)
    del params, step_logits, pre, dec
    torch.cuda.empty_cache()
    print(f"jamba: device memory peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB allocated during the phase", flush=True)
    return {"launches": launches["mamba_scan"], "scan": keep["scan"],
            "attn": keep["attn"], "max_abs_err": layer_err,
            "prefill_ms": prefill_ms}


def _sm_clock_hz() -> float:
    """The card's top SM clock, from nvidia-smi."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    return float(mhz) * 1e6


def _jamba_attention(served):
    """The flash op at the recorded jamba attention layer's settings."""
    from repro_torch.kernels.attention import ops as attn_ops
    kw = served["attn"][3]
    return functools.partial(attn_ops.flash_attention, causal=True,
                             window=kw["window"], softcap=kw["softcap"])


def early_device_ms(torch, rwkv_served, jamba_served) -> dict:
    """Device times of the wkv6 and scan kernels and of the flash kernel
    at jamba's attention shape, at the recorded layers' inputs."""
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    wkv_split = {}
    return {"wkv6": device_ms(torch, "wkv6", wkv_ops.wkv6,
                              *rwkv_served["layer"][:5], reps=LONG_REPS,
                              split=wkv_split),
            "wkv6_split": wkv_split,
            "mamba_scan": device_ms(torch, "mamba_scan",
                                    scan_ops.selective_scan,
                                    *jamba_served["scan"][:6],
                                    reps=LONG_REPS),
            "jamba_attention": device_ms(torch, "flash_attention",
                                         _jamba_attention(jamba_served),
                                         *jamba_served["attn"][:3],
                                         reps=LONG_REPS)}


def mamba_scan_timing(torch, served, parity_err, dev_ms) -> list[dict]:
    """The kernel at one jamba layer's prefill inputs, beside its plain
    version and the bound (``dev_ms`` from ``early_device_ms``)."""
    import dataclasses
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan.kernel import selective_scan_plain
    xc, dt, Bc, Cc, A, D, out = served["scan"]
    B, T, Di = xc.shape
    S = Bc.shape[-1]
    scan_ops.selective_scan(xc, dt, Bc, Cc, A, D)
    launch = dict(scan_kernel.LAST_LAUNCH)
    plan, stages = launch["plan"], launch["stages"]
    loads, ctas = launch["loads"], launch["ctas_per_sm"]
    label = (f"{JAMBA_ARCH} mamba layer prefill: xc/dt {list(xc.shape)} "
             f"{str(xc.dtype)[6:]}/{str(dt.dtype)[6:]}, B/C {list(Bc.shape)} "
             f"{str(Bc.dtype)[6:]}, A {list(A.shape)} f32, y f32")
    args = (xc, dt, Bc, Cc, A, D)
    ms, reps = time_long_ms(torch, scan_ops.selective_scan, *args)
    plain_ms, plain_reps = time_long_ms(torch, selective_scan_plain, *args)
    nbytes = _nbytes(*args, out)
    updates = B * T * Di * S
    ops = 6 * updates           # dt*A, dt*x*B, the h FMA, the y FMA
    clock = _sm_clock_hz()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_f32 = ops / F32_OPS_PER_S * 1e3
    # one exp per update on the special-function units
    t_exp = updates / (H100_SMS * SFU_EXPS_PER_CLOCK_PER_SM * clock) * 1e3
    t_ops = max(t_f32, t_exp)
    note = ("none is one call: no PyTorch call runs an input-dependent "
            "selective state-space recurrence")
    row = {"case": label, "ms": ms, "device_ms": dev_ms, "reps": reps,
           "plain_ms": plain_ms, "plain_reps": plain_reps,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "operations": ops, "exps": updates,
           "bytes_ms": t_bytes, "f32_ms": t_f32, "exp_ms": t_exp,
           "sm_clock_mhz": clock / 1e6, "body": "tiles",
           "plan": dataclasses.asdict(plan), "stages": stages,
           "loads": loads,
           "ctas_per_sm": ctas,
           "bound_share": t_exp / (dev_ms or ms), "library_ms": None,
           "library_call": None, "library_note": note}
    print(f"{'mamba_scan':>22} | {label}: {ms:.4f} ms [device "
          f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms] ({reps}; "
          f"tiles body, plan W={plan.warps} C={plan.groups} "
          f"KT={plan.steps} stages={stages}, "
          f"{ctas} CTAs/SM, loads {loads}; bound {row['bound_ms']:.4f} ms "
          f"by {row['bound_by']}: bytes {t_bytes:.4f}, f32 {t_f32:.4f}, "
          f"exps {t_exp:.4f} at {clock / 1e6:.0f} MHz, "
          f"{row['bound_share']:.2f} of the exp bound; "
          f"{updates / ms / 1e9:.2f} T (t, d, s) updates/s), plain "
          f"{plain_ms:.4f} ms ({plain_reps}), library n/a [{note}]",
          flush=True)
    return [{"name": "mamba_scan", "route": "cuda",
             "source": "src/repro_torch/csrc/mamba_scan.cu",
             "replaces": "src/repro/kernels/mamba_scan/kernel.py:20",
             "launches": served["launches"],
             "max_abs_err": max(served["max_abs_err"], parity_err),
             "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": None, "cases": [row]}]


def jamba_attention_timing(torch, served, dev_ms) -> dict:
    """The flash kernel at jamba's attention layer (64 q heads, 8 kv
    heads, head_dim 128, causal, no rope or softcap), beside its plain
    version, the bound and flex_attention (``dev_ms`` from
    ``early_device_ms``)."""
    from repro_torch.kernels.attention.kernel import flash_attention_plain
    q, k, v, kw, out = served["attn"]
    win, cap = kw["window"], kw["softcap"]
    label = (f"{JAMBA_ARCH} attention layer: q {list(q.shape)} k/v "
             f"{list(k.shape)} {str(q.dtype)[6:]}, causal, window {win}, "
             f"softcap {cap}")
    kern = _jamba_attention(served)

    def plain(q, k, v):
        return flash_attention_plain(q, k, v, causal=True, window=win,
                                     softcap=cap)
    body = _body_of(torch, kern, q, k, v)
    _require(body == "wgmma", f"{label}: ran on the {body} body")
    ms, reps = time_long_ms(torch, kern, q, k, v)
    plain_ms, plain_reps = time_long_ms(torch, plain, q, k, v)
    B, S, H, D = q.shape
    pairs = _live_pairs(S, win)
    flops = 4 * D * H * B * pairs
    nbytes = _nbytes(q, k, v, out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TC_OPS_PER_S * 1e3
    library = ("torch.compile(flex_attention) with a causal mask_mod")
    try:
        flex = _flex(torch, q, k, v, win, cap)
        flex_err = (flex(q, k, v).float() - out.float()).abs().max()
        library_ms, _ = time_long_ms(torch, flex, q, k, v)
        note = f"flex max |diff| vs kernel {flex_err.item():.4g}"
    except Exception as e:               # the yardstick, not the port
        library, library_ms = None, None
        note = (f"none is one call: flex_attention failed on this card "
                f"({type(e).__name__}: {str(e)[:200]})")
    row = {"case": label, "body": body, "ms": ms, "device_ms": dev_ms,
           "reps": reps, "plain_ms": plain_ms, "plain_reps": plain_reps,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "operations": flops, "live_pairs": pairs,
           "library_ms": library_ms, "library_call": library,
           "library_note": note}
    stats = _attn_stats(row, ms, flops, _kv_read_bytes(q, k, win, body))
    print(f"{'flash_attention':>22} | {label}: {ms:.4f} ms [device "
          f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms] ({reps}; "
          f"{body} body; bound {row['bound_ms']:.4f} ms by "
          f"{row['bound_by']}, {stats}), plain {plain_ms:.4f} ms "
          f"({plain_reps}), library "
          f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'} "
          f"[{note}]", flush=True)
    return row

if __name__ == "__main__":
    sys.exit(main())
