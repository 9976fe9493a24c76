"""Deterministic discrete-event loop + virtual clock.

The loop is a plain ``(time, seq, name, callback)`` heap. ``seq`` is a
monotone tie-breaker so events scheduled at the same virtual instant fire
in scheduling order — this (plus seeded RNGs everywhere else) is what
makes whole-simulation runs byte-reproducible. The clock satisfies the
``repro_torch.serving.reliability.Clock`` interface so the real tiered
heartbeat / TE-shell code runs on simulated time unchanged.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Optional, Tuple

from repro_torch.serving.reliability import Clock


class SimClock(Clock):
    """Virtual clock advanced only by the event loop."""

    def advance(self, dt: float) -> None:  # pragma: no cover - guard
        raise RuntimeError("SimClock is advanced by the EventLoop")

    def _set(self, t: float) -> None:
        self.t = t


class EventLoop:
    def __init__(self):
        self.clock = SimClock()
        self._heap: List[Tuple[float, int, str, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.n_fired = 0
        #: append-only trace of fired events ``(time, name)`` — hashed by
        #: the metrics collector for determinism checks.
        self.trace: List[Tuple[float, str]] = []
        self.trace_enabled = True

    @property
    def now(self) -> float:
        return self.clock.now()

    def schedule(self, delay: float, name: str,
                 fn: Callable[[], None]) -> None:
        """Schedule ``fn`` at ``now + delay`` (delay ≥ 0)."""
        if delay < 0:
            raise ValueError(f"negative delay {delay} for {name}")
        heapq.heappush(self._heap,
                       (self.now + delay, next(self._seq), name, fn))

    def schedule_at(self, t: float, name: str,
                    fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap,
                       (max(t, self.now), next(self._seq), name, fn))

    def run(self, until: Optional[float] = None,
            max_events: int = 5_000_000) -> int:
        """Fire events in order until the heap drains, virtual ``until``
        is passed, or ``max_events`` fire. Returns events fired."""
        fired = 0
        while self._heap:
            t, _, name, fn = self._heap[0]
            if until is not None and t > until:
                break
            heapq.heappop(self._heap)
            self.clock._set(t)
            if self.trace_enabled:
                self.trace.append((t, name))
            fn()
            fired += 1
            self.n_fired += 1
            if fired >= max_events:
                raise RuntimeError(
                    f"event budget exhausted ({max_events}); "
                    "likely a rescheduling loop")
        # the clock stays at the last fired event: the makespan, not the
        # deadline, is what throughput metrics divide by
        return fired

    def empty(self) -> bool:
        return not self._heap
