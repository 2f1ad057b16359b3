"""Device-side lowering of a ``CompiledExec``: the WHOLE compiled round
sequence as ONE CUDA kernel launch (``csrc/schedule_exec.cu``).

The point-to-point transport pays one exchange per compiled round; this
lowering runs every round of a schedule inside one kernel on the
*global* slot buffer ``[nranks, num_slots, *slot]`` — the counterpart
of the reference's Pallas lowering.  The routing program is the
executor's baked numpy tables (``_ExecRound.src/dst/g_safe/g_mask/
t_safe/t_mask`` and the folded ``local_pre``/``local_post``), packed
once per (``CompiledExec``, device) into int32 device tables:

  * ``meta [R, 5]``  per round: edge count m, width k, reduce flag, and
    the offsets of its edges and positions in the arrays below;
  * ``esrc, edst``   per edge: source and destination rank;
  * ``g, t``         per (edge, position): gather row and landing row,
    ``-1`` where masked (send zeros / drop on arrival);
  * ``pre, post``    ``[nranks * num_slots]`` slot permutations, or none.

Rows never mix, so the kernel gives each CTA a column tile of the
flattened slot payload across all ``nranks * num_slots`` slots and runs
every round for it in shared memory.  ``chunks > 1`` splits the slot
row axis into column ranges of the same launch (bit-identical; still
one launch), the row decomposition ``Transport.run_chunked`` relies on.

On a CPU tensor the wrapper runs ``schedule_exec_plain``, the kernel's
plain PyTorch version with the same order of operations; on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import cuda
from repro_torch.core.executor import CompiledExec, get_executor
from repro_torch.core.schedule import CommSchedule, validate_schedules_enabled
from repro_torch.core.topology import Topology

SMEM_MAX = 232448          # bytes of shared memory one CTA may use (H100)
SMEM_TARGET = 72 * 1024    # preferred: three CTAs resident per SM
TILES = (1024, 512, 256, 128, 64, 32)
THREADS = 256


def _pack_tables(ex: CompiledExec) -> dict:
    """The executor's compiled rounds as flat int32 numpy tables."""
    meta, esrc, edst, g, t = [], [], [], [], []
    eo = po = 0
    stage_rows = 1
    for rnd in ex._rounds:
        m, k = len(rnd.src), rnd.k
        meta.append((m, k, int(rnd.reduce), eo, po))
        esrc.append(rnd.src)
        edst.append(rnd.dst)
        g.append(np.where(rnd.g_mask, rnd.g_safe, -1).reshape(-1))
        t.append(np.where(rnd.t_mask, rnd.t_safe, -1).reshape(-1))
        eo += m
        po += m * k
        stage_rows = max(stage_rows, m * k)

    def i32(parts):
        return (np.concatenate(parts).astype(np.int32) if parts
                else np.zeros(0, np.int32))

    return {
        "meta": np.asarray(meta, np.int32).reshape(-1, 5),
        "esrc": i32(esrc), "edst": i32(edst), "g": i32(g), "t": i32(t),
        "pre": None if ex._pre is None else ex._pre.astype(np.int32)
        .reshape(-1),
        "post": None if ex._post is None else ex._post.astype(np.int32)
        .reshape(-1),
        "stage_rows": stage_rows,
    }


def pick_tile(ns: int, stage_rows: int, elem: int, chunk_len: int,
              name: str) -> int:
    """Columns per CTA: the widest tile whose shared-memory footprint
    ``(ns + stage_rows) * tile * elem`` stays under the occupancy target,
    else the 32-wide tile if it fits at all.  Raises ``ValueError`` when
    even that exceeds what one CTA may hold."""
    cap = max(32, -(-chunk_len // 32) * 32)
    for tile in TILES:
        if tile <= cap and (ns + stage_rows) * tile * elem <= SMEM_TARGET:
            return tile
    if (ns + stage_rows) * 32 * elem <= SMEM_MAX:
        return 32
    raise ValueError(
        f"schedule {name!r}: {ns} slots + {stage_rows} staged payloads "
        f"x 32 columns x {elem} B exceed the {SMEM_MAX} B of shared "
        f"memory one CTA may use")


def schedule_exec_plain(ex: CompiledExec, gbuf: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, in the kernel's order: stage
    in through ``pre``; per round gather every edge's payload from the
    pre-round state, then land one (edge, position) at a time — a
    ``set``, or one rounded add for reduce rounds; drain through
    ``post``.  Any device, any dtype."""
    n, s = ex.nranks, ex.num_slots
    work = gbuf.reshape(n, s, -1)
    dev = gbuf.device
    rows = torch.arange(n, device=dev)[:, None]
    if ex._pre is not None:
        work = work[rows, torch.from_numpy(ex._pre).to(dev)]
    else:
        work = work.clone()
    for rnd in ex._rounds:
        m, k = len(rnd.src), rnd.k
        if m == 0:
            continue
        src = torch.from_numpy(rnd.src).to(dev)
        g_safe = torch.from_numpy(np.where(rnd.g_mask, rnd.g_safe, 0)).to(dev)
        stage = work[src[:, None], g_safe]                    # [m, k, L]
        stage[torch.from_numpy(~rnd.g_mask).to(dev)] = 0
        for e in range(m):
            d = int(rnd.dst[e])
            for j in range(k):
                if not rnd.t_mask[e, j]:
                    continue                                  # dropped
                ti = int(rnd.t_safe[e, j])
                if rnd.reduce:
                    work[d, ti] = work[d, ti] + stage[e, j]
                else:
                    work[d, ti] = stage[e, j]
    if ex._post is not None:
        work = work[rows, torch.from_numpy(ex._post).to(dev)]
    return work.reshape(gbuf.shape)


class KernelExec:
    """One ``CompiledExec`` lowered to the single-launch CUDA kernel.

    ``run(gbuf, chunks=)`` executes the full schedule (local_pre ->
    every compiled round -> local_post) on a global buffer
    ``[nranks, num_slots, *slot]`` and returns a new tensor of the same
    shape — the ``SimTransport`` calling convention.  ``launches``
    counts kernel launches (one per ``run`` on a CUDA tensor, whatever
    the round count).
    """

    def __init__(self, ex: CompiledExec):
        self.ex = ex
        self.nranks = ex.nranks
        self.num_slots = ex.num_slots
        self.rounds = ex.rounds_after
        self.launches = 0
        self._host = _pack_tables(ex)
        self._dev: dict = {}

    def device_tables(self, device: torch.device) -> dict:
        """The packed tables on ``device`` (uploaded once per device)."""
        tabs = self._dev.get(device)
        if tabs is None:
            tabs = {k: (None if v is None else torch.from_numpy(v).to(device))
                    for k, v in self._host.items() if k != "stage_rows"}
            self._dev[device] = tabs
        return tabs

    def run(self, gbuf: torch.Tensor, *, chunks: int = 1) -> torch.Tensor:
        n, s = self.nranks, self.num_slots
        if tuple(gbuf.shape[:2]) != (n, s):
            raise ValueError(
                f"KernelExec.run: buffer {tuple(gbuf.shape)} does not "
                f"match [nranks={n}, num_slots={s}, *slot]")
        slot = tuple(gbuf.shape[2:])
        if chunks < 1:
            raise ValueError(f"KernelExec.run: chunks must be >= 1, "
                             f"got {chunks}")
        if chunks > 1 and (not slot or slot[0] % chunks):
            raise ValueError(
                f"KernelExec.run: slot row axis {slot[:1]} must divide "
                f"by chunks={chunks}")
        if gbuf.device.type == "cpu":
            return schedule_exec_plain(self.ex, gbuf)
        if gbuf.device.type != "cuda":
            raise ValueError(f"KernelExec.run: unsupported device "
                             f"{gbuf.device}")
        return self._launch(gbuf, chunks)

    def _launch(self, gbuf: torch.Tensor, chunks: int) -> torch.Tensor:
        code = cuda.dtype_code(gbuf.dtype)
        if not gbuf.is_contiguous():
            raise ValueError("KernelExec.run: the global buffer must be "
                             "contiguous")
        n, s = self.nranks, self.num_slots
        L = int(math.prod(gbuf.shape[2:]))
        out = torch.empty_like(gbuf)
        if L == 0:
            return out
        stage_rows = self._host["stage_rows"]
        tile = pick_tile(n * s, stage_rows, gbuf.element_size(),
                         L // chunks, self.ex.schedule.name)
        tabs = self.device_tables(gbuf.device)

        def ptr(x):
            return None if x is None or x.numel() == 0 else x.data_ptr()

        lib = cuda.library()
        with torch.cuda.device(gbuf.device):
            stream = torch.cuda.current_stream(gbuf.device).cuda_stream
            err = lib.repro_schedule_exec(
                code, gbuf.data_ptr(), out.data_ptr(), ptr(tabs["pre"]),
                ptr(tabs["post"]), ptr(tabs["meta"]), ptr(tabs["esrc"]),
                ptr(tabs["edst"]), ptr(tabs["g"]), ptr(tabs["t"]),
                len(self.ex._rounds), n, s, L, chunks, tile, stage_rows,
                THREADS, stream)
        cuda.check(err, f"schedule_exec[{self.ex.schedule.name}]")
        self.launches += 1
        cuda.LAUNCHES["schedule_exec"] += 1
        return out


# ---------------------------------------------------------------------------
# process-level cache (persistent-collective init, like executor._CACHE)
# ---------------------------------------------------------------------------


_CACHE: dict[tuple, KernelExec] = {}


def get_kernel_exec(schedule: CommSchedule, *,
                    topo: Topology | None = None,
                    optimize: bool | None = None) -> KernelExec:
    """Lower once per (schedule content, optimize, validation flag,
    topology geometry), then reuse — the reference's Pallas-cache key
    without its interpret flag (a CPU tensor selects the plain version
    per call instead)."""
    ex = get_executor(schedule, optimize=optimize, topo=topo)
    key = (schedule.fingerprint(), ex.optimize,
           validate_schedules_enabled(),
           None if topo is None else topo.fingerprint())
    kex = _CACHE.get(key)
    if kex is None or kex.ex is not ex:      # executor cache was cleared
        kex = KernelExec(ex)
        _CACHE[key] = kex
    return kex


def clear_cache() -> None:
    """Drop every lowered kernel executor (tests; after env flips)."""
    _CACHE.clear()
