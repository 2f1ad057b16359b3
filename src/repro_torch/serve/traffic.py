"""Serving traffic simulator: Poisson arrivals, bursty tenant mixes
(PyTorch port; the trace is numpy, as in the reference).

Seeded and fully deterministic, so the ``serve`` benchmark section's
claims (every arrival completes, TTFT in steps, KV bytes) are
machine-independent.  Two pieces:

  * ``poisson_workload`` — a request trace: per-tenant Poisson arrival
    processes with occasional bursts (a geometric burst of back-to-back
    arrivals, the multi-tenant thundering-herd case) and skewed
    prompt/gen length distributions (low tenant ids are chatty /
    short-prompt, high ids are doc-heavy / long-prompt);
  * ``run_workload`` — drives a ``ContinuousBatchingEngine`` against a
    trace: virtual time advances ``dt`` per engine tick and requests
    are submitted when their arrival time passes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serve.engine import ContinuousBatchingEngine, EngineStall, Request


def poisson_workload(seed: int = 0, *, arrival_rate: float = 4.0,
                     tenants: int = 2, n_requests: int = 32,
                     mean_prompt: int = 24, mean_gen: int = 8,
                     burst_frac: float = 0.25, burst_len: int = 4,
                     max_prompt: int = 128,
                     max_gen: int = 64) -> list[Request]:
    """Seeded multi-tenant request trace (list sorted by arrival)."""
    if arrival_rate <= 0:
        raise ValueError(f"arrival_rate must be > 0, got {arrival_rate}")
    if tenants < 1:
        raise ValueError(f"tenants must be >= 1, got {tenants}")
    rng = np.random.default_rng(seed)
    reqs: list[Request] = []
    t, rid = 0.0, 0
    while rid < n_requests:
        t += float(rng.exponential(1.0 / arrival_rate))
        k = 1
        if rng.random() < burst_frac:
            k = 1 + int(rng.geometric(1.0 / burst_len))
        for _ in range(min(k, n_requests - rid)):
            tenant = int(rng.integers(tenants))
            # tenant skew: chatty tenants send short prompts, doc-heavy
            # tenants long ones — the ragged mix the paged pools absorb
            scale = 0.5 + 1.5 * tenant / max(1, tenants - 1)
            p = int(np.clip(rng.gamma(2.0, mean_prompt * scale / 2.0),
                            1, max_prompt))
            g = int(np.clip(rng.gamma(1.5, mean_gen / 1.5), 1, max_gen))
            reqs.append(Request(rid=rid, tenant=tenant, prompt_len=p,
                                gen_len=g, arrival=t))
            rid += 1
    return reqs


def run_workload(engine: ContinuousBatchingEngine,
                 requests: list[Request], *, dt: float = 0.05,
                 max_steps: int = 50_000, on_step=None) -> dict:
    """Drive the engine through a trace; returns ``engine.metrics()``.

    One engine tick per ``dt`` of virtual time; raises ``EngineStall``
    when the engine stops making progress with no arrivals left to
    unblock it (a decode pool too small for the workload).
    ``on_step(step)``, when given, runs after every tick (the launcher's
    drift-healing heartbeat).
    """
    pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
    vt, idle = 0.0, 0
    while pending or engine.pending:
        vt += dt
        while pending and pending[0].arrival <= vt:
            engine.submit(pending.pop(0))
        before = (len(engine.done),
                  sum(len(r.tokens) for r in engine.active))
        engine.step()
        if on_step is not None:
            on_step(engine.step_count)
        after = (len(engine.done),
                 sum(len(r.tokens) for r in engine.active))
        idle = 0 if after != before or pending else idle + 1
        if idle > 8:
            raise EngineStall(
                f"workload stalled at step {engine.step_count}: "
                f"{engine.pending} requests stuck with no arrivals left")
        if engine.step_count >= max_steps:
            raise EngineStall(
                f"workload exceeded max_steps={max_steps}")
    return engine.metrics()
