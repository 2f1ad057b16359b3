"""The harness: finds a cell's files by name, sets up its process (or its
ranks), runs the cell's loop, reads the metrics and prints the result.

Everything that belongs to one configuration, one cell, one traffic
kind or one metric sits in a file of its own, found by name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<kind>.py``, ``cells/<loop>.py`` and ``metrics/<metric>.py``
(a ``read(run)`` that returns a number, or None where it finds nothing
to read).  ``BENCHMARK.json`` at the checkout's root says which metrics
each cell reports.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 12.0         # a traced run's tail with the device recorded
NAME_SECONDS = 3.0           # and then with the host's spans as well
TOP = 10                     # entries of each breakdown list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def load_file(path: Path):
    """A module of the benchmark found by file name (names may hold
    dots, so they are loaded by path, not imported)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_entries(man: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: with ``trace`` the per-layer metrics
    whose ``workloads`` name it, else the end-to-end ones that hold for
    it (those without ``workloads`` hold for every cell)."""
    if trace:
        return [m for m in man["per_layer"] if cell in m["workloads"]]
    return [m for m in man["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def cache_env() -> None:
    """Every build and kernel cache in fixed directories of the
    checkout, set before torch is imported."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def program_path() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


# ---------------------------------------------------------------------------
# the run's context: spans, the measured window, the trace
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What a run gives the metric readers."""
    cell: str
    cfg: dict
    wl: dict
    chips: int
    setup_s: float = math.nan
    build_s: float | None = None
    window_s: float = math.nan
    steps: int = 0                 # train: steps in the window
    tokens: int = 0                # tokens done in the window (all ranks)
    lengths: list = dataclasses.field(default_factory=list)
    traced_steps: int = 0          # train: steps in the traced tail
    traced_lengths: list = dataclasses.field(default_factory=list)
    traced_tokens: int = 0         # tokens done in the device-traced part
    ttft_s: list = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace: "Trace | None" = None
    busy_s: float | None = None    # averaged over the ranks
    checks: dict = dataclasses.field(default_factory=dict)
    notes: dict = dataclasses.field(default_factory=dict)


class Ctx:
    """One rank's view of the run: its device, rank and groups, the
    run's arguments, the cell's files, and the spans and window."""

    def __init__(self, args, wl, cfg, device, rank=0, world=1, t0=None,
                 stop_group=None):
        self.args, self.wl, self.cfg = args, wl, cfg
        self.device, self.rank, self.world = device, rank, world
        self.t0 = time.perf_counter() if t0 is None else t0
        self.stop_group = stop_group
        self.spans = False
        self.run = Run(cell=args.workload, cfg=cfg, wl=wl, chips=world)

    def span(self, name: str):
        """A span of the benchmark's own, recorded where the host's
        activity is traced: it names the idle gaps the device had while
        the host was doing this."""
        if not self.spans:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function("pb:" + name)

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _together(self) -> None:
        """Waits for the device, and on several ranks for every rank."""
        self.sync()
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier(group=self.stop_group)

    def _calls(self, body, seconds: float) -> int:
        """Calls ``body()`` until ``seconds`` have passed; returns the
        count.  On several ranks every rank makes the same count: each
        call's vote (is the time up?) is taken over a host group while
        the next call runs, and read after it."""
        until = time.perf_counter() + seconds
        n, vote = 0, None
        while True:
            body()
            n += 1
            if self.world == 1:
                if time.perf_counter() >= until:
                    return n
                continue
            import torch
            import torch.distributed as dist
            if vote is not None:
                work, flag = vote
                work.wait()
                if flag.item():
                    return n
            flag = torch.tensor([int(time.perf_counter() >= until)])
            vote = (dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                                    group=self.stop_group, async_op=True),
                    flag)

    def measure(self, body) -> tuple[int, int]:
        """Ends set-up and runs the measured window: ``body()`` (one step
        or request) again and again for ``--seconds``, then the device
        waited for; the peak memory is read after it.  With ``--trace
        1`` the calls go on after the window, traced: for TRACE_SECONDS
        with the device's activity alone recorded (``run.trace``, which
        the per-layer metrics read), then for NAME_SECONDS with the
        host's activity and spans as well, which only names the idle
        gaps of the breakdown.  Returns the calls of the window and of
        the device-traced part."""
        self._together()
        start = time.perf_counter()
        self.run.setup_s = start - self.t0
        n = self._calls(body, float(self.args.seconds))
        self.sync()
        self.run.window_s = time.perf_counter() - start
        if self.device.type == "cuda":
            import torch
            self.run.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))
        if not self.args.trace:
            return n, 0
        traced, self.run.trace = self._traced(body, TRACE_SECONDS, False)
        _, self.run.trace.named = self._traced(body, NAME_SECONDS, True)
        return n, traced

    def _traced(self, body, seconds: float, host: bool):
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CUDA] if cuda else []
        if host or not cuda:
            acts.append(ProfilerActivity.CPU)
        self._together()
        prof = profile(activities=acts)
        prof.__enter__()
        self.spans = host
        start = time.perf_counter()
        try:
            n = self._calls(body, seconds)
            self.sync()
            window = time.perf_counter() - start
        finally:
            self.spans = False
            prof.__exit__(None, None, None)
        return n, Trace.read(prof, window)


def _union(intervals) -> list[tuple[float, float]]:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _measure(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _minus(a_set, b_set) -> float:
    """Length of the union ``a_set`` outside the union ``b_set`` (both
    sorted and disjoint, as ``_union`` gives them)."""
    total, j = 0.0, 0
    for a0, a1 in a_set:
        while j < len(b_set) and b_set[j][1] <= a0:
            j += 1
        cover, k = 0.0, j
        while k < len(b_set) and b_set[k][0] < a1:
            cover += min(a1, b_set[k][1]) - max(a0, b_set[k][0])
            k += 1
        total += (a1 - a0) - cover
    return total


@dataclasses.dataclass
class Trace:
    """The device operations of a traced window (name, start, end in
    seconds of the trace's clock) and the benchmark's host spans;
    ``named``, the later window whose spans name the idle gaps."""
    ops: list
    spans: list
    window_s: float
    named: "Trace | None" = None

    @classmethod
    def read(cls, prof, window_s: float) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        events = events.get("traceEvents", events) \
            if isinstance(events, dict) else events
        ops, spans = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            t0, t1 = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
            if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                ops.append((e.get("name", "?"), t0, t1))
            elif cat == "user_annotation" and \
                    str(e.get("name", "")).startswith("pb:"):
                spans.append((e["name"][3:], t0, t1))
        return cls(ops, spans, window_s)

    def busy(self, match=None) -> list[tuple[float, float]]:
        """Union of the intervals of the device operations whose name
        ``match`` accepts (all without ``match``)."""
        return _union((a, b) for n, a, b in self.ops
                      if match is None or match(n))

    def busy_s(self) -> float:
        return _measure(self.busy())

    def op_seconds(self, match) -> float:
        """Summed device time of the operations ``match`` accepts."""
        return sum(b - a for n, a, b in self.ops if match(n))

    def count(self, match) -> int:
        return sum(1 for n, _, _ in self.ops if match(n))

    def alone_s(self, match) -> float:
        """Time in which operations ``match`` accepts run and no other."""
        return _minus(self.busy(match), self.busy(lambda n: not match(n)))

    def breakdown(self) -> dict:
        """The device operations that took most time in this window, and
        the longest idle gaps of ``named`` (this one without it) by the
        span the host was in."""
        by_op: dict = {}
        for n, a, b in self.ops:
            key = n[:120]
            by_op[key] = by_op.get(key, 0.0) + (b - a)
        named = self.named or self
        busy = named.busy()
        gaps: dict = {}
        for (_, a1), (b0, _) in zip(busy, busy[1:]):
            mid = (a1 + b0) / 2
            covering = [s for s in named.spans if s[1] <= mid <= s[2]]
            name = (min(covering, key=lambda s: s[2] - s[1])[0]
                    if covering else "outside the benchmark's spans")
            gaps[name] = gaps.get(name, 0.0) + (b0 - a1)
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


# ---------------------------------------------------------------------------
# one rank's run, and the result line
# ---------------------------------------------------------------------------


def run_rank(args, rank: int = 0, world: int = 1, rendezvous: str = "",
             t0: float | None = None, device=None, patch=None,
             build_s: float | None = None) -> dict | None:
    """Runs the cell on this rank; returns rank 0's result (None on the
    others).  ``rendezvous``: the process group's ``init_method`` (one
    rank: unused).  ``device`` None takes card ``rank``; ``patch(ctx)``, if
    given, may swap parts of the program before the run (the tests'
    planted faults); ``build_s`` is the nvcc time of this run, recorded
    apart (None where the library was reused)."""
    import torch
    if device is None:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    wl = workload(args.workload)
    cfg = getattr(args, "config_override", None) or config(wl["config"])
    if getattr(args, "params_override", None):
        wl = dict(wl, params={**wl["params"], **args.params_override})
    stop_group = None
    if world > 1:
        import torch.distributed as dist
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=rendezvous, rank=rank,
                                world_size=world)
        stop_group = dist.new_group(backend="gloo")
    try:
        ctx = Ctx(args, wl, cfg, device, rank, world, t0, stop_group)
        ctx.run.build_s = build_s
        if patch is not None:
            patch(ctx)
        load_file(BENCH / "cells" / f"{wl['loop']}.py").run(ctx)
        run = ctx.run
        if world > 1:
            run = _combine(ctx)
        if rank != 0:
            return None
        return result(run, args, device)
    finally:
        if world > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, timeout: float = 600.0) -> list:
    """Runs ``fn(rank, world, rendezvous, *args)`` in ``world`` fresh
    processes that meet through a file in a new directory under the
    temporary directory; when one fails, the others are ended.  Waits
    for every process and returns their exit codes."""
    import multiprocessing as mp
    import shutil
    ctx = mp.get_context("spawn")
    where = tempfile.mkdtemp(prefix="perfbench-rendezvous-")
    rendezvous = "file://" + os.path.join(where, "store")
    procs = [ctx.Process(target=fn, args=(r, world, rendezvous, *args))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = any(p.exitcode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                for p in procs:
                    if p.is_alive():
                        p.terminate()
            for p in procs:
                p.join(timeout=0.5)
        return [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(where, ignore_errors=True)


def _combine(ctx) -> Run:
    """Rank 0's run with the peak memory of the fullest rank, the busy
    time averaged over the ranks, and each compared number at its worst
    over the ranks."""
    import torch.distributed as dist
    run = ctx.run
    mine = {"peak": run.memory_peak_bytes,
            "busy": run.trace.busy_s() if run.trace else None,
            "checks": run.checks}
    every = [None] * ctx.world
    dist.all_gather_object(every, mine, group=ctx.stop_group)
    run.memory_peak_bytes = max(e["peak"] for e in every)
    if run.trace is not None:
        run.busy_s = statistics.mean(e["busy"] for e in every)
    for e in every:
        for k, (v, lim) in e["checks"].items():
            if k not in run.checks or not v <= run.checks[k][0]:
                run.checks[k] = (v, lim)
    return run


def result(run: Run, args, device) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, the
    metrics, the device, the traced run's breakdown, and the compared
    numbers with their limits last."""
    import torch
    man = manifest()
    metrics = {}
    for m in metric_entries(man, args.workload, bool(args.trace)):
        reader = load_file(BENCH / "metrics" / f"{m['name']}.py")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": run.chips, "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": correct(run), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    notes = dict(run.notes)
    if run.trace is not None:
        dev["busy_s"] = (run.busy_s if run.busy_s is not None
                         else run.trace.busy_s())
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
        if run.tokens and run.traced_tokens:
            # the tracer's own cost: the traced part's rate over the window's
            notes["traced_rate_ratio"] = ((run.traced_tokens
                                           / run.trace.window_s)
                                          / (run.tokens / run.window_s))
    if run.build_s is not None:
        out["build_s"] = run.build_s
    if notes:
        out["notes"] = notes
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def correct(run: Run) -> bool:
    """Every compared number within its limit (a number without a limit
    fails), something attempted, nothing failed."""
    return (run.attempted > 0 and run.failed == 0 and bool(run.checks)
            and all(lim is not None and v <= lim
                    for v, lim in run.checks.values()))


def print_result(out: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, the result as the last line of standard output."""
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
