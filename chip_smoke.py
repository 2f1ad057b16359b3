"""Drive the PyTorch/CUDA port's collective path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. build   — compile ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a
             into ``build/repro_torch/`` (one nvcc per source, in
             parallel) and print the build time;
2. parity  — every REGISTRY schedule on four topologies, random floats,
             slots [4, 33] (a ragged tile edge): the transport kernel
             bitwise against its plain PyTorch version (f32, bf16) and
             against the numpy oracle ``run_reference`` (f32); chunks=2
             bit-identical; one launch per run;
3. main    — launch counters reset, then the main path once at sizes
             users run: Topology -> selector -> builder -> executor ->
             ``KernelTransport.run_global`` for a 25 MiB-per-rank
             gradient allreduce on 8 and 16 ranks and a MoE alltoall
             dispatch, and the fused ``rmsnorm_allreduce`` / plain
             ``rmsnorm`` ops at qwen3-14b and gemma2-2b widths; counters
             read; every output checked against its plain version and
             the collective's meaning;
4. timing  — per case, the kernel, its plain version and a library
             call: CUDA events around 20 calls enqueued back to back,
             divided by 20, median of 5 such batches (after warm-up);
             the kernel's own device time read by name from
             ``torch.profiler``; beside the bound at 3.35 TB/s.

The last two lines of standard output are the kernels JSON object and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository around it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import functools
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
REPS = 20                        # calls per timed batch
BATCHES = 5
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
    cases = main_path(torch, dev)
    kernels = timing(torch, cases)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------


def parity(torch, dev) -> None:
    from repro_torch.core.algorithms import REGISTRY
    from repro_torch.core.kernel_lowering import (get_kernel_exec,
                                                  schedule_exec_plain)
    from repro_torch.core.schedule import NotApplicable
    from repro_torch.core.topology import (Topology, flat_topology,
                                           torus_topology)
    from repro_torch.core.transport import SimTransport

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    checked = 0
    for topo in (flat_topology(8), Topology(8, 4), torus_topology(2, 2, 2),
                 torus_topology(2, 4, 2)):
        n = topo.nranks
        for coll, algos in REGISTRY.items():
            for name, builder in algos.items():
                try:
                    sched = builder(topo)
                except NotApplicable:
                    continue
                label = f"{topo.fingerprint()} {coll}.{name}"
                buf = rng.standard_normal((n, sched.num_slots, 4, 33))
                buf = buf.astype(np.float32)
                buf.reshape(-1)[::7] = -0.0
                want = SimTransport(n).run_reference(sched, buf)
                kex = get_kernel_exec(sched, topo=topo)
                for dtype, itype in ((torch.float32, torch.int32),
                                     (torch.bfloat16, torch.int16)):
                    g = torch.from_numpy(buf).to(dev, dtype)
                    before = kex.launches
                    got = kex.run(g)
                    torch.cuda.synchronize()
                    _require(kex.launches == before + 1,
                             f"{label}: not one launch per run")
                    plain = schedule_exec_plain(kex.ex, g)
                    _require(torch.equal(got.view(itype), plain.view(itype)),
                             f"{label} {dtype}: kernel != plain version")
                    _require(torch.equal(kex.run(g, chunks=2).view(itype),
                                         got.view(itype)),
                             f"{label} {dtype}: chunks=2 not bit-identical")
                    if dtype == torch.float32:
                        _require(got.cpu().numpy().tobytes()
                                 == want.tobytes(),
                                 f"{label}: kernel != run_reference")
                checked += 1
    torch.cuda.synchronize()
    print(f"parity: {checked} schedules x (f32, bf16) bitwise, "
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
    from repro_torch.core.transport import KernelTransport
    from repro_torch.kernels.rmsnorm import ops

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
    _require(launches["schedule_exec"] == len(TRANSPORT_CASES),
             "transport: not one launch per run")
    for c in cases:
        c["launches"] = launches[c["kernel"]]
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


def time_ms(torch, fn, *args) -> float:
    """Milliseconds per call: CUDA events around REPS calls enqueued back
    to back, divided by REPS; the median over BATCHES batches.  The host
    enqueues ahead of the device, so a call's dispatch hides behind the
    kernels before it unless the call is bound by the host."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(BATCHES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn(*args)
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / REPS)
    return statistics.median(per_call)


KERNEL_SYMBOLS = {"schedule_exec": "schedule_exec_kernel",
                  "rmsnorm_reduce": "rmsnorm_rows_kernel",
                  "rmsnorm": "rmsnorm_rows_kernel"}


def device_ms(torch, kernel: str, fn, *args) -> float | None:
    """The kernel's own device time per launch, read by its symbol from
    a ``torch.profiler`` trace of REPS calls (None when the trace holds
    no device time for it)."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn(*args)
        torch.cuda.synchronize()
    us = launches = 0
    for e in prof.key_averages():
        if KERNEL_SYMBOLS[kernel] in e.key:
            us += (getattr(e, "device_time_total", None)
                   or getattr(e, "cuda_time_total", 0))
            launches += e.count
    return us / launches / 1e3 if launches and us else None


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
                library = "gbuf.sum(0, keepdim=True).expand_as(gbuf)"
                library_ms = time_ms(
                    torch, lambda g: g.sum(0, keepdim=True).expand_as(g),
                    gbuf)
            else:
                library = "gbuf[:, :n].transpose(0, 1).contiguous()"
                library_ms = time_ms(
                    torch, lambda g: g[:, :n].transpose(0, 1).contiguous(),
                    gbuf)
            # a copy of the whole buffer: what any transport pays at least
            extra["copy_floor_ms"] = time_ms(torch, lambda g: g.clone(),
                                             gbuf)
            extra["rounds"] = ex.rounds_after
        else:
            x, scale = args
            d = x.shape[-1]
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


if __name__ == "__main__":
    sys.exit(main())
