"""Ragged KV-cache block transfers on the unified IR (PyTorch port).

Disaggregated serving moves paged KV-cache blocks from the prefill pool
to the decode pool: a sparse, ragged, recurring exchange — exactly the
neighborhood-collective shape the paper's persistent plans target
(``MPIX_Neighbor_alltoallv_init``).  This module compiles a batch of
*block moves* into a ``NeighborPlan`` on the gather-permute-scatter IR:

  * each move ships one block row ``(src rank, src row) -> (dst rank,
    dst row)``; the per-edge row indices become the ragged
    (payload-bearing) alltoallv plan;
  * a block needed by several decode ranks (shared prompt prefixes)
    appears on several edges — locality-aware aggregation
    (``build_plan(aggregate=True)``) ships it across pods once per pod
    pair and fans out inside the pod, the Collom et al. optimization;
  * ``aggregate=None`` resolves standard-vs-locality-aware through the
    selection policy ladder;
  * the compiled ``CommSchedule`` runs on any transport: the numpy
    oracles (``sim``, ``reference``) on a host copy of the pool, the
    point-to-point ``dist`` transport over a process group, or the whole
    schedule as one kernel (``kernel``) on the pool's device.

The pool is a tensor ``[nranks, blocks_per_rank, *block]`` on the
engine's device.  Both plan modes land received blocks in the identical
recv layout, so the ``landing`` map (recv row -> decode pool row) is
mode-independent and ``gather_oracle`` is the bit-exactness oracle for
every transport.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.plan import ELEM_BYTES, CommGraph, NeighborPlan, \
    build_plan
from repro_torch.core.topology import Topology

TRANSPORTS = ("sim", "reference", "dist", "kernel")


@dataclasses.dataclass(frozen=True)
class BlockMove:
    """One KV block's journey: src pool row -> dst pool row."""

    src: int        # prefill rank
    src_row: int    # block row in src's pool
    dst: int        # decode rank
    dst_row: int    # block row in dst's pool


@dataclasses.dataclass(frozen=True, eq=False)
class KVTransferPlan:
    """A compiled batch of block moves (thin wrapper over NeighborPlan).

    ``landing[d]`` is an ``[k, 2]`` array of ``(recv_row, dst_row)``
    pairs mapping rank d's recv segment rows (plan layout: segments
    ordered by source rank, move order within an edge) to decode-pool
    block rows.
    """

    plan: NeighborPlan
    moves: tuple[BlockMove, ...]
    landing: dict[int, np.ndarray]
    blocks_per_rank: int
    block_bytes: int

    @property
    def schedule(self):
        return self.plan.schedule

    @property
    def topo(self) -> Topology:
        return self.plan.topo

    @property
    def nbytes(self) -> int:
        """Payload bytes the request set asked for (moves x block)."""
        return len(self.moves) * self.block_bytes

    def traffic(self) -> dict:
        """Wire accounting of the *chosen* plan (DCN/ICI bytes+msgs)."""
        return self.plan.traffic(elem_bytes=self.block_bytes)

    def modeled_time(self) -> float:
        return self.plan.modeled_time(elem_bytes=self.block_bytes)


def build_transfer_plan(moves: Sequence[BlockMove], topo: Topology, *,
                        blocks_per_rank: int,
                        aggregate: bool | None = None,
                        policy: str | None = None,
                        block_bytes: int = ELEM_BYTES) -> KVTransferPlan:
    """Compile one batch of block moves into a persistent ragged plan.

    Validates the move set (prefill/decode pools are disjoint so
    ``src != dst``; no two moves may land on the same destination row),
    groups moves into graph edges with stable order, and delegates mode
    selection to ``build_plan`` (``aggregate=None`` = policy ladder).
    """
    if not moves:
        raise ValueError("build_transfer_plan: empty move batch")
    seen_dst: set[tuple[int, int]] = set()
    edge_moves: dict[tuple[int, int], list[BlockMove]] = {}
    for m in moves:
        if m.src == m.dst:
            raise ValueError(f"move {m} stays on one rank; local block "
                             f"copies don't need a transfer plan")
        if not (0 <= m.src_row < blocks_per_rank
                and 0 <= m.dst_row < blocks_per_rank):
            raise ValueError(f"move {m} outside pool of "
                             f"{blocks_per_rank} blocks")
        if (m.dst, m.dst_row) in seen_dst:
            raise ValueError(f"two moves land on dst row "
                             f"({m.dst}, {m.dst_row})")
        seen_dst.add((m.dst, m.dst_row))
        edge_moves.setdefault((m.src, m.dst), []).append(m)
    edges = {k: np.array([m.src_row for m in v], np.int64)
             for k, v in edge_moves.items()}
    graph = CommGraph(nranks=topo.nranks,
                      local_sizes=(blocks_per_rank,) * topo.nranks,
                      edges=edges)
    plan = build_plan(graph, topo, aggregate=aggregate, policy=policy,
                      elem_bytes=block_bytes)
    # recv layout is identical across plan modes: segments ordered by
    # source rank, rows in edge (= move) order -> landing is mode-free
    landing: dict[int, np.ndarray] = {}
    for d in range(topo.nranks):
        pos, pairs = 0, []
        for s, idx in graph.recv_layout(d):
            for j, m in enumerate(edge_moves[(s, d)]):
                pairs.append((pos + j, m.dst_row))
            pos += len(idx)
        if pairs:
            landing[d] = np.asarray(pairs, np.int64)
    return KVTransferPlan(plan=plan, moves=tuple(moves), landing=landing,
                          blocks_per_rank=blocks_per_rank,
                          block_bytes=block_bytes)


def gather_oracle(moves: Sequence[BlockMove], pool: torch.Tensor
                  ) -> dict[int, tuple[np.ndarray, torch.Tensor]]:
    """Direct-indexing reference: what each decode rank must receive.

    ``pool`` is the global block pool ``[nranks, blocks_per_rank,
    *block]``; returns per-dst ``(dst_rows, values)`` sorted by dst row
    — the oracle every transport's result must match bitwise.  The
    values are gathered on the pool's device.
    """
    per_dst: dict[int, list[BlockMove]] = {}
    for m in moves:
        per_dst.setdefault(m.dst, []).append(m)
    out = {}
    for d, ms in per_dst.items():
        ms = sorted(ms, key=lambda m: m.dst_row)
        rows = np.array([m.dst_row for m in ms], np.int64)
        src = torch.tensor([m.src for m in ms], device=pool.device)
        src_row = torch.tensor([m.src_row for m in ms], device=pool.device)
        out[d] = (rows, pool[src, src_row])
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class TransferResult:
    """One executed transfer batch: per-dst updates + telemetry.

    ``updates[d]`` is ``(dst rows, values)``: the rows a numpy array,
    the values a tensor on the pool's device.  ``seconds`` is the wall
    time of the execution, taken after the device finished it.
    ``report`` is the ``DegradationReport`` when resilience was armed."""

    updates: dict[int, tuple[np.ndarray, torch.Tensor]]
    seconds: float
    nbytes: int
    plan_name: str
    report: object = None


def run_transfer(tp: KVTransferPlan, pool: torch.Tensor, *,
                 transport: str = "kernel", group=None,
                 resilience=None,
                 transports: dict | None = None) -> TransferResult:
    """Execute the plan's schedule on the global block pool.

    ``pool`` is ``[nranks, blocks_per_rank, *block]`` (prefill ranks'
    rows hold the blocks to ship).  ``transport`` picks the substrate:
    ``sim`` (vectorized numpy) and ``reference`` (the rank-by-rank
    oracle loop) on a host copy of the pool; ``dist`` (one
    ``batch_isend_irecv`` per compiled round, called by every rank of
    ``group`` with the same pool); ``kernel`` (the whole schedule as one
    kernel on the pool's device, its plain version on a CPU pool).
    With ``resilience=`` armed the run goes through ``ResilientExec``
    instead — the verify/retry/fallback ladder on the pool's device,
    chaos injectable via ``transports={rung: wrapped}`` — and the
    result carries its ``DegradationReport``.
    """
    from repro_torch.core.transport import (DistTransport, KernelTransport,
                                            SimTransport)

    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; expected "
                         f"{' | '.join(TRANSPORTS)}")
    sched, topo, n = tp.schedule, tp.topo, tp.topo.nranks
    if tuple(pool.shape[:2]) != (n, tp.blocks_per_rank):
        raise ValueError(f"pool {tuple(pool.shape)} does not match "
                         f"[{n}, {tp.blocks_per_rank}, *block]")
    feat = tuple(pool.shape[2:])
    sync = (torch.cuda.synchronize if pool.device.type == "cuda"
            else lambda: None)
    report = None
    sync()
    t0 = time.perf_counter()
    if resilience is not None:
        from repro_torch.core.resilient import (ResilientExec,
                                                resolve_resilience)
        gbuf = pool.new_zeros((n, sched.num_slots) + feat)
        gbuf[:, : tp.blocks_per_rank] = pool
        ex = ResilientExec(sched, topo,
                           options=resolve_resilience(resilience),
                           transports=transports, group=group)
        out, report = ex.run(gbuf)
    elif transport in ("sim", "reference"):
        host = pool.cpu().numpy()
        gbuf = np.zeros((n, sched.num_slots) + feat, host.dtype)
        gbuf[:, : tp.blocks_per_rank] = host
        sim = SimTransport(n, topo=topo)
        out = (sim.run(sched, gbuf) if transport == "sim"
               else sim.run_reference(sched, gbuf))
        out = torch.from_numpy(out).to(pool.device)
    else:
        gbuf = pool.new_zeros((n, sched.num_slots) + feat)
        gbuf[:, : tp.blocks_per_rank] = pool
        if transport == "kernel":
            out = KernelTransport(n, topo=topo).run_global(sched, gbuf)
        else:
            out = DistTransport(n, group, topo=topo).run_global(sched, gbuf)
    updates: dict[int, tuple[np.ndarray, torch.Tensor]] = {}
    for d, land in tp.landing.items():
        off = tp.plan.recv_offsets[d]
        recv = out[d, off: off + tp.plan.recv_sizes[d]]
        order = np.argsort(land[:, 1], kind="stable")
        idx = torch.from_numpy(land[order, 0]).to(pool.device)
        updates[d] = (land[order, 1].copy(), recv[idx])
    sync()
    return TransferResult(updates=updates,
                          seconds=time.perf_counter() - t0,
                          nbytes=tp.nbytes, plan_name=tp.plan.name,
                          report=report)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float tensor, as integers of its width."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()])


def verify_bitwise(tp: KVTransferPlan, pool: torch.Tensor,
                   result: TransferResult) -> bool:
    """True iff ``result`` matches the gather oracle bit for bit (raw
    bits compared as integers, so -0.0 and NaN payloads count)."""
    want = gather_oracle(tp.moves, pool)
    if sorted(want) != sorted(result.updates):
        return False
    for d, (rows, vals) in want.items():
        got_rows, got_vals = result.updates[d]
        if (rows.tobytes() != got_rows.tobytes()
                or got_vals.dtype != vals.dtype
                or got_vals.shape != vals.shape
                or not torch.equal(_bits(got_vals), _bits(vals))):
            return False
    return True


def apply_updates(result: TransferResult, pool: torch.Tensor) -> None:
    """Land received blocks into the destination rows of ``pool``."""
    for d, (rows, vals) in result.updates.items():
        pool[d, torch.from_numpy(rows).to(pool.device)] = vals
