"""Straggler detection and work reassignment.

SPMD steps are globally synchronous, so stragglers surface as slow
*hosts* (input pipeline, checkpoint writes) rather than slow compute
shards.  The standard mitigation — implemented here — is:

  * track a robust per-host step-time estimate (median + MAD),
  * flag hosts slower than ``threshold`` x fleet median,
  * reassign the flagged host's *data shard* to the fastest host (the
    step-addressable pipeline makes shards location-free), and surface
    the flag so the scheduler can swap the node at the next checkpoint.
"""
from __future__ import annotations

import collections
import statistics


class StragglerMonitor:
    def __init__(self, num_hosts: int, window: int = 16,
                 threshold: float = 1.5):
        self.num_hosts = num_hosts
        self.window = window
        self.threshold = threshold
        self.times = [collections.deque(maxlen=window)
                      for _ in range(num_hosts)]
        # host -> list of data shards it currently materializes
        self.assignment = {h: [h] for h in range(num_hosts)}

    def record(self, host: int, step_time: float):
        self.times[host].append(step_time)

    def _estimate(self, host: int) -> float | None:
        t = self.times[host]
        return statistics.median(t) if len(t) >= 3 else None

    def stragglers(self) -> list[int]:
        ests = {h: self._estimate(h) for h in range(self.num_hosts)}
        known = [e for e in ests.values() if e is not None]
        if len(known) < max(2, self.num_hosts // 2):
            return []
        fleet = statistics.median(known)
        return [h for h, e in ests.items()
                if e is not None and e > self.threshold * fleet]

    def rebalance(self) -> dict[int, list[int]]:
        """Move each straggler's shards to the fastest non-straggler;
        a host measured healthy again reclaims its home shard first.

        Recovery is symmetric with eviction: a shard moves away only
        while its home host is flagged, and moves back the moment the
        host's estimate drops under threshold — a transiently slow host
        (GC pause, checkpoint write) is not stranded shard-less forever
        with its donor permanently overloaded.  Hosts with no estimate
        yet stay evicted (unknown is not healthy)."""
        slow = set(self.stragglers())
        for h in range(self.num_hosts):
            if h in slow or self._estimate(h) is None:
                continue
            for donor, shards in self.assignment.items():
                if donor != h and h in shards:
                    shards.remove(h)
                    self.assignment[h].append(h)
        if not slow:
            return self.assignment
        fast = sorted(
            (h for h in range(self.num_hosts)
             if h not in slow and self._estimate(h) is not None),
            key=self._estimate)
        if not fast:
            return self.assignment
        it = 0
        for h in sorted(slow):
            if not self.assignment[h]:
                continue
            tgt = fast[it % len(fast)]
            it += 1
            self.assignment[tgt].extend(self.assignment[h])
            self.assignment[h] = []
        return self.assignment
