"""Proactive jitter control (§4.4): manual GC, core pinning, step cache.

The paper's three mitigations map as:
  * Core pinning            → os.sched_setaffinity (best-effort).
  * PTA graph caching       → pre-warm the decode step so the first global
                              dispatch pays no kernel build or allocator
                              growth.
  * Manual Python GC        → disable automatic collection, collect every
                              N forward passes at a controlled point.
"""
from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Callable, List, Optional


class ProactiveGC:
    def __init__(self, every_n_steps: int = 200, enabled: bool = True):
        self.every = every_n_steps
        self.enabled = enabled
        self.steps = 0
        self.collections = 0
        self.gc_time_total = 0.0
        if enabled:
            gc.disable()

    def step(self) -> Optional[float]:
        """Call once per forward pass; collects at controlled intervals.
        Returns GC duration when a collection ran."""
        if not self.enabled:
            return None
        self.steps += 1
        if self.steps % self.every:
            return None
        t0 = time.monotonic()
        gc.collect()
        dt = time.monotonic() - t0
        self.collections += 1
        self.gc_time_total += dt
        return dt

    def close(self) -> None:
        if self.enabled:
            gc.enable()


def pin_to_core(core: Optional[int] = None) -> bool:
    """Pin this executor process/thread to one CPU core (best-effort)."""
    if core is None or not hasattr(os, "sched_setaffinity"):
        return False
    try:
        os.sched_setaffinity(0, {core})
        return True
    except (OSError, ValueError):
        return False


def prewarm(fns_and_args: List) -> float:
    """Warmup (PTA-caching analogue): run each (fn, args) once before
    serving, waiting for the device, so later launches find their
    kernels built and their memory pooled."""
    import torch

    t0 = time.monotonic()
    for fn, args in fns_and_args:
        fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.monotonic() - t0


@contextlib.contextmanager
def jitter_guard(gc_ctl: ProactiveGC):
    """Wrap a dispatch-critical section: no GC inside."""
    was = gc.isenabled()
    if was:
        gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()
