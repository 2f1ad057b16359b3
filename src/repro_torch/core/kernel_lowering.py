"""Device-side lowering of a ``CompiledExec``: the WHOLE compiled round
sequence as ONE CUDA kernel launch (``csrc/schedule_exec.cu``).

The point-to-point transport pays one exchange per compiled round; this
lowering runs every round of a schedule inside one kernel on the
*global* slot buffer ``[nranks, num_slots, *slot]`` — the counterpart
of the reference's Pallas lowering.  The routing program is the
executor's baked numpy tables (``_ExecRound.src/dst/g_safe/g_mask/
t_safe/t_mask`` and the folded ``local_pre``/``local_post``), packed
once per ``CompiledExec`` into one int32 table (``_pack_tables``): the
row each work row loads (-1 for a row whose input never reaches the
output), the row each output row drains from, the stage-in and drain
as TMA boxes of 2^k consecutive rows, and per round its flags and its
live landings as (src row, dst row) pairs.  A round is
*direct* when no landing row is also a gather row (it lands straight
from the buffer, without a stage) and *ordered* when a landing row
repeats (its landings keep (edge, position) order).

Rows never mix, so the kernel's persistent CTAs walk column tiles of
the flattened slot payload across all ``nranks * num_slots`` rows and
run every round for a tile in shared memory (the shared body).  A
schedule whose rows do not fit one CTA's shared memory (a neighbor or
KV-transfer plan of thousands of rows) takes another body of the same
source, still one launch: a plan with no reduce round (copy-only) the
gather body, which copies each output row from the input row the whole
schedule composes it to (``_compose``: pre, every round and post folded
into one map on the host, grouped by source as ``gather_tab``, both
built by ``gather_tables`` the first time the body is chosen), reading
each distinct input row once; a plan with a reduce round the global
body, the work rows in device memory and the same rounds.
``pick_tile`` chooses; ``last_launch["body"]`` says which ran,
``cuda.TRANSPORT_BODIES`` counts them.  ``chunks > 1`` splits the
slot row axis into column ranges of the same launch (bit-identical;
still one launch), the row decomposition ``Transport.run_chunked``
relies on; the gather body copies whole rows, which gives the same
bytes.

On a CPU tensor the wrapper runs the plain PyTorch version of the body
``pick_tile`` chooses: ``schedule_exec_gather_plain`` for the gather
body, else ``schedule_exec_plain``, with the kernel's order of
operations; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
import weakref

import numpy as np
import torch

from repro_torch import cuda
from repro_torch.core.executor import CompiledExec, get_executor
from repro_torch.core.schedule import CommSchedule, validate_schedules_enabled
from repro_torch.core.topology import Topology

SMEM_MAX = 232448          # bytes of shared memory one CTA may use (H100)
SMEM_TARGET = 75 * 1024    # preferred: three CTAs resident per SM
BAR_BYTES = 64             # the kernel's mbarriers
TILES = (256, 128, 64, 32)
MIN_ROW_BYTES = 128        # a TMA box starts 128-byte aligned
WIDE_ROW_BYTES = 256       # narrower rows cost device-memory rate
MAX_BUFS = 4
MAX_BOX_ROWS = 256         # a TMA box spans at most 256 rows
REDUCE, DIRECT, ORDERED = 1, 2, 4   # round flags in the kernel's meta
GLOBAL_ROW_BYTES = 128     # the global body's tile: 128 B of each row
GLOBAL_CTAS_PER_SM = 8     # the global body's persistent grid (256 threads)
# the gather body's segment bytes and ring buffers, fixed in the kernel
# (kGatherSeg, kGatherBufs in csrc/schedule_exec.cu, which reports them
# at each launch); pick_tile names them for the gather body
GATHER_SEG_BYTES = 32768
GATHER_BUFS = 4
NOT_LOADED = -2            # _compose: a row the kernel never loads


def _round_pairs(rnd, s: int) -> tuple[np.ndarray, np.ndarray]:
    """A compiled round's live landings as (src row, dst row) arrays in
    (edge, position) order; a row is ``rank * s + slot``, and the src
    row is -1 where the gather is masked (the landing takes +0)."""
    e, j = np.nonzero(rnd.t_mask)
    dst = rnd.dst[e] * s + rnd.t_safe[e, j]
    src = np.where(rnd.g_mask[e, j], rnd.src[e] * s + rnd.g_safe[e, j], -1)
    return src.astype(np.int64), dst.astype(np.int64)


def _boxes(source: np.ndarray) -> list[tuple[int, int, int]]:
    """Copies of whole rows as TMA boxes: target row ``i`` takes source
    row ``source[i]`` (none where it is -1).  Runs of consecutive targets
    with consecutive sources split into boxes of 2^k rows (largest
    first, at most ``MAX_BOX_ROWS``); returns (target row, source row,
    k) per box."""
    ops = []
    i, n = 0, len(source)
    while i < n:
        if source[i] < 0:
            i += 1
            continue
        j = i + 1
        while j < n and source[j] == source[j - 1] + 1:
            j += 1
        while i < j:
            k = min(j - i, MAX_BOX_ROWS).bit_length() - 1
            ops.append((i, int(source[i]), k))
            i += 1 << k
    return ops


def _compose(src_row: np.ndarray, load: np.ndarray, rounds: list,
             post_row: np.ndarray) -> np.ndarray:
    """A copy-only schedule as one map: the input row each output row
    holds, or -1 where a masked gather lands +0.  It keeps the kernel's
    semantics: a round's landings read the pre-round state, the last
    landing at a repeated target wins, a row no landing touches keeps
    its ``pre`` row, and a row the kernel never loads is never read
    (asserted: the sentinel reaches no output row)."""
    cur = np.where(load, src_row, NOT_LOADED)
    for src, dst, flags in rounds:
        val = np.where(src >= 0, cur[np.maximum(src, 0)], -1)
        if flags & ORDERED:
            # the last landing at each target, in (edge, position) order
            last = len(dst) - 1 - np.unique(dst[::-1], return_index=True)[1]
            dst, val = dst[last], val[last]
        cur[dst] = val
    src_of = cur[post_row]
    assert (src_of != NOT_LOADED).all(), "an output row reads an unloaded row"
    return src_of


def _gather_table(src_of: np.ndarray) -> tuple[np.ndarray, int, int]:
    """``src_of`` grouped by source, as the gather body walks it: the
    distinct input rows ascending, the CSR offsets of their output rows,
    the output rows grouped by source (ascending within a source), then
    the rows that take +0.  Returns (int32 table, sources, zero rows)."""
    src_of = src_of.astype(np.int32)
    order = np.argsort(src_of, kind="stable").astype(np.int32)
    by_src = src_of[order]                       # the -1 rows first
    nzero = int(np.searchsorted(by_src, 0))
    by_src, dst = by_src[nzero:], order[nzero:]
    edge = np.ones(len(dst) + 1, bool)           # where a source starts
    np.not_equal(by_src[1:], by_src[:-1], out=edge[1:-1])
    offsets = np.flatnonzero(edge).astype(np.int32)
    tab = np.concatenate([by_src[offsets[:-1]], offsets, dst, order[:nzero]])
    return tab, len(offsets) - 1, nzero


def _pack_tables(ex: CompiledExec) -> dict:
    """The executor's compiled rounds as the kernel's int32 table ``tab``
    (layout in ``csrc/schedule_exec.cu``) and what the host needs
    beside it:

      * ``direct [R]``: no landing row of the round is also one of its
        gather rows, so it lands straight from the buffer (else it
        gathers into the stage first);
      * ``ordered [R]``: some landing row repeats within the round, so
        its landings run in (edge, position) order (else all at once);
      * ``load [n*s]``: the work row's input reaches the output.  A row
        whose first access in round order is a ``set`` landing is
        cleared: the kernel never loads it;
      * ``loads`` / ``stores``: the stage-in and the drain as TMA boxes
        (``_boxes``), with the box heights each uses (``*_classes``,
        bit k for 2^k rows);
      * ``stage_rows``: the largest hazard round's landing count, the
        stage the kernel sizes (0 when every round is direct);
      * ``copy_only``: no round reduces (the gather body's own tables
        are ``gather_tables``).
    """
    n, s = ex.nranks, ex.num_slots
    ns = n * s
    base = np.arange(n, dtype=np.int64)[:, None] * s
    src_row = (np.arange(ns, dtype=np.int64) if ex._pre is None
               else (base + ex._pre).reshape(-1))
    post_row = (np.arange(ns, dtype=np.int64) if ex._post is None
                else (base + ex._post).reshape(-1))
    # first access per row: 0 none yet, 1 read (live), 2 set (dead)
    first = np.zeros(ns, np.int8)
    meta, pairs, rounds, direct, ordered = [], [], [], [], []
    stage_rows = off = 0
    for rnd in ex._rounds:
        src, dst = _round_pairs(rnd, s)
        gathered = src[src >= 0]
        is_direct = not np.isin(dst, gathered).any()
        is_ordered = len(np.unique(dst)) != len(dst)
        reads = np.concatenate([gathered, dst]) if rnd.reduce else gathered
        first[reads[first[reads] == 0]] = 1
        if not rnd.reduce:
            first[dst[first[dst] == 0]] = 2
        if not is_direct:
            stage_rows = max(stage_rows, len(dst))
        flags = (REDUCE * bool(rnd.reduce) | DIRECT * is_direct
                 | ORDERED * is_ordered)
        meta.append((off, len(dst), flags, 0))
        pairs.append(np.stack([src, dst], axis=1))
        rounds.append((src, dst, flags))
        direct.append(is_direct)
        ordered.append(is_ordered)
        off += len(dst)
    load = first != 2
    live_src = np.where(load, src_row, -1)
    loads, stores = _boxes(live_src), _boxes(post_row)

    def ops(boxes):
        return np.asarray([(t, f, k, 0) for t, f, k in boxes],
                          np.int64).reshape(-1, 4)

    tab = np.concatenate([
        ops(loads).reshape(-1), ops(stores).reshape(-1),
        np.asarray(meta, np.int64).reshape(-1),
        (np.concatenate(pairs) if pairs else np.zeros((0, 2), np.int64))
        .reshape(-1), live_src, post_row]).astype(np.int32)
    return {"tab": tab,
            "copy_only": not any(rnd.reduce for rnd in ex._rounds),
            "src_row": src_row, "post_row": post_row, "load": load,
            "nlive": int(load.sum()), "loads": loads, "stores": stores,
            "load_classes": sum({1 << k for _, _, k in loads}),
            "store_classes": sum({1 << k for _, _, k in stores}),
            "direct": np.asarray(direct, bool),
            "ordered": np.asarray(ordered, bool), "rounds": rounds,
            "stage_rows": stage_rows,
            "post_identity": bool((post_row == np.arange(ns)).all())}


_TABLES: "weakref.WeakKeyDictionary[CompiledExec, dict]" = \
    weakref.WeakKeyDictionary()


def tables(ex: CompiledExec) -> dict:
    """``_pack_tables(ex)``, computed once per executor."""
    tabs = _TABLES.get(ex)
    if tabs is None:
        tabs = _TABLES[ex] = _pack_tables(ex)
    return tabs


def gather_tables(ex: CompiledExec) -> dict:
    """``tables(ex)`` with the gather body's tables added on first use
    (a copy-only schedule only): ``src_of [n*s]`` (``_compose``), the
    kernel's ``gather_tab`` (``_gather_table``), ``gather_rows``
    distinct input rows read and ``zero_rows`` rows that take +0."""
    tabs = tables(ex)
    if not tabs["copy_only"]:
        raise ValueError(f"schedule {ex.schedule.name!r} has a reduce "
                         f"round: the gather body runs copy-only schedules")
    if "gather_tab" not in tabs:
        src_of = _compose(tabs["src_row"], tabs["load"], tabs["rounds"],
                          tabs["post_row"])
        gtab, nsrc, nzero = _gather_table(src_of)
        tabs.update(src_of=src_of, gather_tab=gtab, gather_rows=nsrc,
                    zero_rows=nzero)
    return tabs


def smem_bytes(ns: int, stage_rows: int, elem: int, tile: int, nbuf: int,
               ntab: int = 0) -> int:
    """The kernel's dynamic shared memory: mbarriers and the table
    (padded to 128 B), the stage and ``nbuf`` [ns, tile] buffers."""
    return (-(-(BAR_BYTES + ntab * 4) // 128) * 128
            + (nbuf * ns + stage_rows) * tile * elem)


def _shared_tile(ns: int, stage_rows: int, elem: int, chunk_len: int,
                 ntab: int) -> tuple[int, int] | None:
    """The shared body's (columns per item, buffers per CTA), or None
    when not even one buffer of 128-byte rows fits one CTA."""
    narrow = MIN_ROW_BYTES // elem
    cap = max(narrow, -(-chunk_len // narrow) * narrow)
    tiles = [t for t in TILES if narrow <= t <= cap]
    wide = [t for t in tiles if t * elem >= WIDE_ROW_BYTES] or tiles[:1]

    def buffers(tile: int, limit: int) -> int:
        return max((b for b in range(1, MAX_BUFS + 1)
                    if smem_bytes(ns, stage_rows, elem, tile, b, ntab)
                    <= limit), default=0)

    for tile in wide:
        if buffers(tile, SMEM_TARGET) >= 2:
            return tile, buffers(tile, SMEM_TARGET)
    for tile in reversed(wide):
        if buffers(tile, SMEM_MAX) >= 2:
            return tile, buffers(tile, SMEM_MAX)
    if buffers(narrow, SMEM_MAX):
        return narrow, buffers(narrow, SMEM_MAX)
    return None


def floor_rows(ex: CompiledExec, body: str) -> int:
    """The rows a body's design floor moves: every output row written
    once, and every input row it needs read once (the rows that reach
    the output; for the gather body the distinct rows of ``src_of``)."""
    tabs = gather_tables(ex) if body == "gather" else tables(ex)
    read = tabs["gather_rows"] if body == "gather" else tabs["nlive"]
    return read + len(tabs["post_row"])


def pick_tile(ns: int, stage_rows: int, elem: int, chunk_len: int,
              name: str, ntab: int = 0, *, body: str | None = None,
              copy_only: bool = False) -> tuple[str, int, int]:
    """(body, columns per item or segment bytes, buffers per CTA).

    The shared body holds every row of a column tile in shared memory.
    Rows of at least ``WIDE_ROW_BYTES`` (or the widest the row allows)
    keep device memory efficient; among those, the widest tile whose
    ring of two buffers fits the three-CTAs-per-SM target, with as many
    buffers (up to four) as that target holds; else the narrowest such
    tile with as many buffers as one CTA may hold; else the narrowest
    tile (rows of 128 B) with as many as fit.  A schedule of which not
    even one such buffer fits takes the gather body when it is
    ``copy_only`` (segments of ``GATHER_SEG_BYTES`` of a row, a ring of
    ``GATHER_BUFS``), else the global body: rows of
    ``GLOBAL_ROW_BYTES`` a tile, no buffers.  ``body`` forces one (tests
    and the card smoke only); forcing the shared body on a schedule it
    cannot hold, or the gather body on one with a reduce round, raises
    ``ValueError``."""
    if body not in (None, "shared", "global", "gather"):
        raise ValueError(f"unknown body {body!r}; expected shared | global "
                         f"| gather")
    if body == "gather" and not copy_only:
        raise ValueError(f"schedule {name!r} has a reduce round: the gather "
                         f"body runs copy-only schedules")
    shared = (None if body in ("global", "gather")
              else _shared_tile(ns, stage_rows, elem, chunk_len, ntab))
    if shared is not None:
        return ("shared",) + shared
    if body == "shared":
        raise ValueError(
            f"schedule {name!r}: {ns} slots + {stage_rows} staged payloads "
            f"x {MIN_ROW_BYTES // elem} columns x {elem} B exceed the "
            f"{SMEM_MAX} B of shared memory one CTA may use")
    if copy_only and body != "global":
        return "gather", GATHER_SEG_BYTES, GATHER_BUFS
    return "global", GLOBAL_ROW_BYTES // elem, 0


def schedule_exec_plain(ex: CompiledExec, gbuf: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, in the kernel's order: load
    the live rows through ``pre`` (a row the kernel does not load starts
    as NaN here, so a read of one would show in the result); per round,
    land every (src, dst) pair — all at once where the targets are
    distinct, else one at a time in (edge, position) order — as a
    ``set`` or one rounded add, from the buffer in direct rounds and
    from a stage gathered first in hazard rounds; drain through
    ``post``.  Any device, any dtype."""
    tabs = tables(ex)
    n, s = ex.nranks, ex.num_slots
    dev = gbuf.device
    flat = gbuf.reshape(n * s, -1)
    load = torch.from_numpy(tabs["load"]).to(dev)
    src_row = torch.from_numpy(tabs["src_row"]).to(dev)
    work = (flat.new_full(flat.shape, float("nan"))
            if flat.dtype.is_floating_point else torch.empty_like(flat))
    work[load] = flat[src_row[load]]
    for src_np, dst_np, flags in tabs["rounds"]:
        if not len(dst_np):
            continue
        src = torch.from_numpy(src_np).to(dev)
        dst = torch.from_numpy(dst_np).to(dev)
        masked = src < 0
        if flags & ORDERED and flags & DIRECT:
            stage = None                      # read as it lands
        else:                                 # gathered before landing
            stage = work[src.clamp_min(0)]
            stage[masked] = 0
        if not flags & ORDERED:
            work[dst] = work[dst] + stage if flags & REDUCE else stage
            continue
        for p in range(len(dst_np)):
            d = dst[p]
            if stage is not None:
                v = stage[p]
            elif masked[p]:
                v = torch.zeros_like(work[d])
            else:
                v = work[src[p]]
            work[d] = work[d] + v if flags & REDUCE else v
    out = work[torch.from_numpy(tabs["post_row"]).to(dev)]
    return out.reshape(gbuf.shape)


def schedule_exec_gather_plain(ex: CompiledExec,
                               gbuf: torch.Tensor) -> torch.Tensor:
    """The gather body's plain PyTorch version: read from the packed
    ``gather_tab``, each output row is a copy of its source row (every
    output row of a source from one read of it), the rows listed apart
    take +0.  Any device, any dtype; the schedule must be copy-only."""
    tabs = gather_tables(ex)
    n, s = ex.nranks, ex.num_slots
    ns, nsrc = n * s, tabs["gather_rows"]
    gtab = torch.from_numpy(tabs["gather_tab"].astype(np.int64)).to(
        gbuf.device)
    srcs, offsets = gtab[:nsrc], gtab[nsrc:2 * nsrc + 1]
    dst = gtab[2 * nsrc + 1:2 * nsrc + 1 + ns - tabs["zero_rows"]]
    flat = gbuf.reshape(ns, -1)
    out = torch.zeros_like(flat)
    rows = flat[srcs]
    out[dst] = rows.repeat_interleave(offsets.diff(), dim=0)
    return out.reshape(gbuf.shape)


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
        self.tables = tables(ex)
        self._dev: dict = {}
        self._plans: dict = {}       # (elem, chunk_len, forced) -> pick_tile
        self._info = (ctypes.c_int * 5)()
        # what the last launch ran: its body, tile (the gather body's
        # segment bytes), grid and path, rows read and the design floor
        # in bytes; the shared and gather bodies' buffers and CTAs per
        # SM, the global body's scratch bytes
        self.last_launch: dict | None = None

    def device_table(self, device: torch.device,
                     name: str = "tab") -> torch.Tensor:
        """The packed int32 table ``name`` (``tab``, or ``gather_tab``
        for the gather body) on ``device`` (uploaded once)."""
        tab = self._dev.get((device, name))
        if tab is None:
            tab = self._dev[device, name] = torch.from_numpy(
                self.tables[name]).to(device)
        return tab

    def plan(self, elem: int, chunk_len: int,
             body: str | None = None) -> tuple[str, int, int]:
        """``pick_tile`` for this schedule (cached per element size,
        chunk length and forced body)."""
        key = (elem, chunk_len, body)
        plan = self._plans.get(key)
        if plan is None:
            tabs = self.tables
            plan = self._plans[key] = pick_tile(
                self.nranks * self.num_slots, tabs["stage_rows"], elem,
                chunk_len, self.ex.schedule.name, len(tabs["tab"]),
                body=body, copy_only=tabs["copy_only"])
        return plan

    def run(self, gbuf: torch.Tensor, *, chunks: int = 1,
            _body: str | None = None) -> torch.Tensor:
        """``_body`` forces the shared, the global or the gather body
        (tests and the card smoke only)."""
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
        if gbuf.device.type not in ("cpu", "cuda"):
            raise ValueError(f"KernelExec.run: unsupported device "
                             f"{gbuf.device}")
        plan = self.plan(gbuf.element_size(),
                         int(math.prod(slot)) // chunks, _body)
        if gbuf.device.type == "cpu":
            if plan[0] == "gather":
                return schedule_exec_gather_plain(self.ex, gbuf)
            return schedule_exec_plain(self.ex, gbuf)
        return self._launch(gbuf, chunks, plan)

    def _launch(self, gbuf: torch.Tensor, chunks: int,
                plan: tuple[str, int, int]) -> torch.Tensor:
        code = cuda.dtype_code(gbuf.dtype)
        if not gbuf.is_contiguous():
            raise ValueError("KernelExec.run: the global buffer must be "
                             "contiguous")
        ns = self.nranks * self.num_slots
        L = int(math.prod(gbuf.shape[2:]))
        out = torch.empty_like(gbuf)
        if L == 0:
            return out
        elem = gbuf.element_size()
        kind, tile, nbuf = plan
        tabs = gather_tables(self.ex) if kind == "gather" else self.tables
        tab = self.device_table(gbuf.device,
                                "gather_tab" if kind == "gather" else "tab")
        lib = cuda.library()
        info = ctypes.cast(self._info, ctypes.c_void_p)
        with torch.cuda.device(gbuf.device):
            stream = torch.cuda.current_stream(gbuf.device).cuda_stream
            if kind == "shared":
                err = lib.repro_schedule_exec(
                    code, gbuf.data_ptr(), out.data_ptr(), tab.data_ptr(),
                    tab.numel(), len(tabs["loads"]), len(tabs["stores"]),
                    tabs["load_classes"], tabs["store_classes"],
                    len(self.ex._rounds), ns, L, chunks, tile, nbuf,
                    tabs["stage_rows"], tabs["nlive"], info, stream)
            elif kind == "gather":
                err = lib.repro_schedule_exec_gather(
                    gbuf.data_ptr(), out.data_ptr(), tab.data_ptr(),
                    tabs["gather_rows"], tabs["zero_rows"], ns, L * elem,
                    info, stream)
            else:
                # work rows in ``out`` itself when post is the identity
                work = out if tabs["post_identity"] else torch.empty_like(gbuf)
                items = -(-(L // chunks) // tile) * chunks
                grid = min(items, GLOBAL_CTAS_PER_SM * torch.cuda.
                           get_device_properties(gbuf.device)
                           .multi_processor_count)
                stage = torch.empty(grid * tabs["stage_rows"]
                                    * GLOBAL_ROW_BYTES, dtype=torch.uint8,
                                    device=gbuf.device)
                err = lib.repro_schedule_exec_global(
                    code, gbuf.data_ptr(), out.data_ptr(), work.data_ptr(),
                    stage.data_ptr(), tab.data_ptr(), tab.numel(),
                    len(tabs["loads"]), len(tabs["stores"]),
                    len(self.ex._rounds), ns, L, chunks, grid,
                    tabs["stage_rows"], info, stream)
        cuda.check(err, f"schedule_exec[{self.ex.schedule.name}] ({kind} "
                        f"body)")
        self.launches += 1
        cuda.LAUNCHES["schedule_exec"] += 1
        cuda.TRANSPORT_BODIES[kind] += 1
        moved = floor_rows(self.ex, kind)
        common = {"body": kind, "tile": tile, "rows_loaded": moved - ns,
                  "rows": ns, "floor_bytes": moved * L * elem}
        if kind == "shared":
            grid, per_sm, aligned = self._info[:3]
            self.last_launch = {
                **common, "buffers": nbuf, "grid": grid,
                "ctas_per_sm": per_sm,
                "path": "aligned TMA" if aligned else "ragged",
                "copies": len(tabs["loads"]) + len(tabs["stores"]),
                "smem_bytes": smem_bytes(ns, tabs["stage_rows"], elem, tile,
                                         nbuf, len(tabs["tab"]))}
        elif kind == "gather":
            grid, per_sm, bulk, seg, bufs = self._info
            self.last_launch = {
                **common, "tile": seg, "buffers": bufs, "grid": grid,
                "ctas_per_sm": per_sm, "path": "bulk" if bulk else "ragged",
                "zero_rows": tabs["zero_rows"], "chunks": chunks}
        else:
            self.last_launch = {
                **common, "grid": grid,
                "path": "16-byte" if self._info[0] else "scalar",
                "scratch_bytes": (0 if work is out
                                  else work.numel() * elem)
                + stage.numel()}
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


def invalidate_topology(fingerprint: str | None) -> int:
    """Scoped eviction, as ``executor.invalidate_topology``: drop the
    lowered executors (and the device tables they hold) armed with the
    given topology fingerprint; returns how many were dropped."""
    doomed = [k for k in tuple(_CACHE) if k[3] == fingerprint]
    return sum(_CACHE.pop(k, None) is not None for k in doomed)
