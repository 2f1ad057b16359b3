"""Continuous-batching serve engine with disaggregated KV pools (PyTorch
port).

The production serving shape: requests arrive continuously, prefill and
decode run in *separate* rank pools (different pods of one Topology, so
pool-to-pool traffic crosses DCN), and each request's paged KV-cache
blocks move from the prefill pool to the decode pool through ragged
neighbor ``CommSchedule``s compiled by ``core.kvtransfer`` — the same
IR, transports and selection policy as every other collective in the
stack.  The block pool is one tensor on the engine's device
(``EngineConfig.device``); by default every transfer batch runs as one
launch of the whole-schedule transport kernel on that device.

Request state machine::

    WAITING --admit--> PREFILL --kv ready--> TRANSFER
        ^                                        |
        |  preempted (decode pool OOM)           | ragged alltoallv
        +----------------------------------------+--> DECODE --> DONE

Scheduling invariants (tested in tests/test_torch_serve_engine.py):

  * admission is strict FIFO by arrival — head-of-line blocking means
    the oldest waiting request is always first to get blocks (no
    starvation);
  * the block pools never double-free (``DoubleFreeError``) and every
    block is back in the free list when the engine drains;
  * decode-pool OOM evicts the *youngest* decoding request (LIFO
    preemption protects the oldest work) back to WAITING;
  * every transfer batch is verified bitwise against the gather oracle
    — a mismatch is a typed ``TransferVerificationError``, never a
    silently corrupt cache.  With ``resilience=`` armed the transfer
    runs the verify/retry/fallback ladder first (``core.resilient``)
    and each batch's ``DegradationReport`` lands in
    ``engine.degradations``.

The engine clock is the *step* (one tick = admit + prefill + transfer +
decode); TTFT and throughput are reported both in deterministic steps
and in wall seconds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import kvtransfer
from repro_torch.core.topology import Topology

WAITING, PREFILL, TRANSFER, DECODE, DONE = (
    "waiting", "prefill", "transfer", "decode", "done")


class DoubleFreeError(ValueError):
    """A block was freed that is not currently allocated."""


class TransferVerificationError(RuntimeError):
    """A KV transfer batch did not match the gather oracle bitwise."""


class EngineStall(RuntimeError):
    """The engine made no progress for a full sweep of ticks."""


class BlockPool:
    """Paged KV block allocator for one rank (free-list, O(1) ops)."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))
        self._used: set[int] = set()

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._used)

    def alloc(self, k: int) -> list[int] | None:
        """k blocks or None (caller decides to wait / evict)."""
        if k > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(k)]
        self._used.update(ids)
        return ids

    def free(self, ids) -> None:
        for i in ids:
            if i not in self._used:
                raise DoubleFreeError(
                    f"block {i} freed but not allocated "
                    f"(in use: {sorted(self._used)})")
            self._used.remove(i)
            self._free.append(i)


@dataclasses.dataclass
class Request:
    rid: int
    tenant: int
    prompt_len: int
    gen_len: int
    arrival: float                 # wall seconds (simulator time ok)
    arrival_step: int = 0
    state: str = WAITING
    admitted_step: int | None = None
    first_token_step: int | None = None
    first_token_s: float | None = None
    done_step: int | None = None
    prefill_rank: int | None = None
    prefill_blocks: list[int] = dataclasses.field(default_factory=list)
    decode_rank: int | None = None
    decode_blocks: list[int] = dataclasses.field(default_factory=list)
    tokens: list[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0

    def n_blocks(self, block_tokens: int) -> int:
        return -(-self.prompt_len // block_tokens)   # ceil


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Pool geometry + transfer knobs.

    Ranks ``[0, prefill_ranks)`` prefill; ``[prefill_ranks,
    prefill_ranks + decode_ranks)`` decode.  With ``ranks_per_pod``
    equal to the pool sizes the two pools sit in different pods and
    every KV transfer crosses DCN — the regime locality-aware
    aggregation is for.
    """

    prefill_ranks: int = 4
    decode_ranks: int = 4
    ranks_per_pod: int = 4
    blocks_per_rank: int = 32
    block_tokens: int = 8        # tokens per paged block
    block_feat: int = 16         # per-token KV feature width
    max_decode_batch: int = 64   # decode tokens emitted per tick
    transport: str = "kernel"    # sim | reference | dist | kernel
    resilience: object = None    # None | "canary" | "full" | options
    aggregate: bool | None = None  # None = selection policy ladder
    policy: str | None = None
    device: str = "cuda"         # where the block pool lives

    def topology(self) -> Topology:
        n = self.prefill_ranks + self.decode_ranks
        if n % self.ranks_per_pod:
            raise ValueError(
                f"prefill+decode ranks ({n}) must tile ranks_per_pod "
                f"({self.ranks_per_pod})")
        return Topology(n, self.ranks_per_pod)

    @property
    def block_bytes(self) -> int:
        return self.block_tokens * self.block_feat * 4   # float32


def _default_decode(req: Request, pos: int) -> int:
    """Deterministic stand-in sampler (replayable without a model)."""
    return int((req.rid * 7919 + pos * 104729 + req.tenant) % 32000)


class ContinuousBatchingEngine:
    """Continuous batching over disaggregated prefill/decode pools.

    ``decode_fn(req, pos) -> token`` plugs a real model step in;
    ``kv_fill(rid, block_idx, shape) -> np.ndarray`` plugs real prefill
    KV content in (the default is a seeded deterministic fill, which is
    what makes bit-exactness testable without a model); the blocks are
    placed on the engine's device.  ``group`` is the process group the
    ``dist`` transport runs over (every rank drives the same engine).
    ``transports`` is forwarded to the resilient transfer path — the
    chaos tests inject ``chaos.wrap``-ped rungs there.
    """

    def __init__(self, cfg: EngineConfig, *,
                 decode_fn: Callable | None = None,
                 kv_fill: Callable | None = None, group=None,
                 transports: dict | None = None):
        if cfg.transport not in kvtransfer.TRANSPORTS:
            raise ValueError(f"unknown transport {cfg.transport!r}; "
                             f"expected one of {kvtransfer.TRANSPORTS}")
        from repro_torch.core.resilient import resolve_resilience
        resolve_resilience(cfg.resilience)     # a bad option fails here
        self.cfg = cfg
        self.topo = cfg.topology()
        n = self.topo.nranks
        self.decode_fn = decode_fn or _default_decode
        self.kv_fill = kv_fill or self._seeded_fill
        self.group = group
        self.transports = transports
        self.prefill_pool_ranks = range(cfg.prefill_ranks)
        self.decode_pool_ranks = range(cfg.prefill_ranks, n)
        self.pools = {r: BlockPool(cfg.blocks_per_rank) for r in range(n)}
        # one global block pool tensor on the device, the transfer
        # plans' substrate: [nranks, blocks_per_rank, block_tokens,
        # block_feat]
        self.device = torch.device(cfg.device)
        self.kv = torch.zeros((n, cfg.blocks_per_rank, cfg.block_tokens,
                               cfg.block_feat), dtype=torch.float32,
                              device=self.device)
        self.step_count = 0
        self.waiting: list[Request] = []     # FIFO by arrival
        self.active: list[Request] = []      # admitted, not DONE
        self.done: list[Request] = []
        self.transfer_log: list[dict] = []   # per-batch telemetry
        self.degradations: list = []         # resilience reports
        self.preemptions = 0
        self._wall0: float | None = None

    # -- deterministic KV content (the testable oracle input) -------------
    def _seeded_fill(self, rid: int, block_idx: int, shape) -> np.ndarray:
        rng = np.random.default_rng((rid, block_idx))
        return rng.normal(size=shape).astype(np.float32)

    # -- public API -------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.arrival_step = self.step_count
        self.waiting.append(req)

    @property
    def pending(self) -> int:
        return len(self.waiting) + len(self.active)

    def step(self) -> None:
        """One engine tick: admit -> prefill -> transfer -> decode."""
        if self._wall0 is None:
            self._wall0 = time.perf_counter()
        self.step_count += 1
        self._admit()
        self._prefill()
        self._transfer()
        self._decode()

    def run(self, *, max_steps: int = 10_000) -> dict:
        """Drive until every submitted request is DONE; returns metrics.
        Raises ``EngineStall`` if a tick sweep makes no progress."""
        idle = 0
        while self.pending:
            before = (len(self.done), sum(len(r.tokens)
                                          for r in self.active))
            self.step()
            after = (len(self.done), sum(len(r.tokens)
                                         for r in self.active))
            idle = idle + 1 if after == before else 0
            if idle > 4:
                raise EngineStall(
                    f"no progress for {idle} ticks at step "
                    f"{self.step_count}: {self.pending} requests stuck "
                    f"(decode pool too small for the workload?)")
            if self.step_count >= max_steps:
                raise EngineStall(f"exceeded max_steps={max_steps} with "
                                  f"{self.pending} requests pending")
        return self.metrics()

    # -- tick phases ------------------------------------------------------
    def _admit(self) -> None:
        """Strict FIFO: the head of the waiting queue is admitted as
        soon as any prefill rank has room; a blocked head blocks the
        queue (head-of-line = oldest-first = starvation-free)."""
        while self.waiting:
            req = self.waiting[0]
            k = req.n_blocks(self.cfg.block_tokens)
            rank = max(self.prefill_pool_ranks,
                       key=lambda r: self.pools[r].available)
            blocks = self.pools[rank].alloc(k)
            if blocks is None:
                return
            self.waiting.pop(0)
            req.state = PREFILL
            req.admitted_step = self.step_count
            req.prefill_rank, req.prefill_blocks = rank, blocks
            self.active.append(req)

    def _prefill(self) -> None:
        for req in self.active:
            if req.state != PREFILL:
                continue
            shape = (self.cfg.block_tokens, self.cfg.block_feat)
            blocks = np.stack([np.asarray(self.kv_fill(req.rid, j, shape),
                                          np.float32)
                               for j in range(len(req.prefill_blocks))])
            rows = torch.tensor(req.prefill_blocks, device=self.device)
            self.kv[req.prefill_rank, rows] = torch.from_numpy(blocks).to(
                self.device)
            req.state = TRANSFER

    def _alloc_decode(self, req: Request) -> bool:
        """Decode-pool blocks for ``req``; evicts the youngest decoding
        request on OOM (LIFO preemption)."""
        k = req.n_blocks(self.cfg.block_tokens)
        while True:
            rank = max(self.decode_pool_ranks,
                       key=lambda r: self.pools[r].available)
            blocks = self.pools[rank].alloc(k)
            if blocks is not None:
                req.decode_rank, req.decode_blocks = rank, blocks
                return True
            victims = [r for r in self.active if r.state == DECODE
                       and r is not req]
            if not victims:
                return False
            victim = max(victims, key=lambda r: (r.admitted_step, r.rid))
            self.pools[victim.decode_rank].free(victim.decode_blocks)
            victim.decode_rank = None
            victim.decode_blocks = []
            victim.tokens.clear()
            victim.state = WAITING
            victim.preemptions += 1
            self.preemptions += 1
            self.active.remove(victim)
            # preempted work re-enters the queue in arrival order so it
            # cannot leapfrog requests that never got served
            pos = next((i for i, w in enumerate(self.waiting)
                        if w.arrival > victim.arrival), len(self.waiting))
            self.waiting.insert(pos, victim)

    def _transfer(self) -> None:
        """Batch every TRANSFER-state request into ONE ragged plan."""
        ready: list[Request] = []
        for req in [r for r in self.active if r.state == TRANSFER]:
            if self._alloc_decode(req):
                ready.append(req)
        if not ready:
            return
        moves = []
        for req in ready:
            for pb, db in zip(req.prefill_blocks, req.decode_blocks):
                moves.append(kvtransfer.BlockMove(
                    src=req.prefill_rank, src_row=pb,
                    dst=req.decode_rank, dst_row=db))
        cfg = self.cfg
        tp = kvtransfer.build_transfer_plan(
            moves, self.topo, blocks_per_rank=cfg.blocks_per_rank,
            aggregate=cfg.aggregate, policy=cfg.policy,
            block_bytes=cfg.block_bytes)
        res = kvtransfer.run_transfer(
            tp, self.kv, transport=cfg.transport, group=self.group,
            resilience=cfg.resilience, transports=self.transports)
        if res.report is not None:
            self.degradations.append(res.report)
        if not kvtransfer.verify_bitwise(tp, self.kv, res):
            raise TransferVerificationError(
                f"KV transfer batch of {len(moves)} blocks mismatched "
                f"the gather oracle (plan {tp.plan.name}, transport "
                f"{cfg.transport})")
        kvtransfer.apply_updates(res, self.kv)
        traffic = tp.traffic()
        self.transfer_log.append({
            "step": self.step_count, "requests": len(ready),
            "blocks": len(moves), "bytes": res.nbytes,
            "plan": res.plan_name, "seconds": res.seconds,
            "modeled_s": tp.modeled_time(),
            "dcn_bytes": traffic["dcn"],
            "ici_bytes": traffic["ici"],
            "moves": tuple(moves),
        })
        for req in ready:
            self.pools[req.prefill_rank].free(req.prefill_blocks)
            req.prefill_rank, req.prefill_blocks = None, []
            req.state = DECODE

    def _decode(self) -> None:
        """One token per decoding request per tick, oldest first."""
        decoding = sorted(
            [r for r in self.active if r.state == DECODE],
            key=lambda r: (r.admitted_step, r.arrival, r.rid))
        for req in decoding[: self.cfg.max_decode_batch]:
            pos = len(req.tokens)
            req.tokens.append(self.decode_fn(req, pos))
            if req.first_token_step is None:
                req.first_token_step = self.step_count
                req.first_token_s = time.perf_counter() - self._wall0
            if len(req.tokens) >= req.gen_len:
                self.pools[req.decode_rank].free(req.decode_blocks)
                req.decode_rank, req.decode_blocks = None, []
                req.state = DONE
                req.done_step = self.step_count
                self.active.remove(req)
                self.done.append(req)

    # -- metrics ----------------------------------------------------------
    def metrics(self) -> dict:
        wall = (time.perf_counter() - self._wall0
                if self._wall0 is not None else 0.0)
        toks = sum(len(r.tokens) for r in self.done + self.active)
        ttft = sorted(r.first_token_step - r.arrival_step
                      for r in self.done if r.first_token_step is not None)
        def pct(q: float) -> float:
            if not ttft:
                return 0.0
            return float(ttft[min(len(ttft) - 1, int(q * len(ttft)))])
        xfer = self.transfer_log
        return {
            "submitted": len(self.done) + self.pending,
            "completed": len(self.done),
            "steps": self.step_count,
            "tokens": toks,
            "tokens_per_step": round(toks / max(1, self.step_count), 3),
            "tokens_per_s": round(toks / wall, 1) if wall > 0 else 0.0,
            "wall_s": round(wall, 4),
            "preemptions": self.preemptions,
            "ttft_steps": {"mean": (round(sum(ttft) / len(ttft), 3)
                                    if ttft else 0.0),
                           "p50": pct(0.50), "p99": pct(0.99)},
            "kv_transfer": {
                "plans": len(xfer),
                "blocks": sum(x["blocks"] for x in xfer),
                "bytes": sum(x["bytes"] for x in xfer),
                "dcn_bytes": sum(x["dcn_bytes"] for x in xfer),
                "ici_bytes": sum(x["ici_bytes"] for x in xfer),
                "wall_s": round(sum(x["seconds"] for x in xfer), 4),
                "modeled_s": sum(x["modeled_s"] for x in xfer),
                "plan_names": sorted({x["plan"] for x in xfer}),
            },
            "degradations": len(self.degradations),
        }
