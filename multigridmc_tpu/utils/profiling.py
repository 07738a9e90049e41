"""Tracing / profiling helpers.

The reference has no profiling framework - only ad-hoc
``std::chrono`` wall-clock timing printed by the drivers
(``driver_mgmc.cc:72-80``, ``:461-473``).  The equivalents here:

* :func:`timed` - the same per-phase wall-clock timing with proper
  ``block_until_ready`` device synchronisation;
* :func:`trace` - a ``jax.profiler`` trace context producing TensorBoard-
  compatible device profiles (kernel timelines, HBM traffic);
* :class:`Timer` - accumulating named-phase timer for drivers.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax


@contextlib.contextmanager
def timed(label: str, results: Dict[str, float] | None = None, verbose: bool = True):
    """Wall-clock a block, synchronising the device at exit."""
    t0 = time.perf_counter()
    yield
    # ensure all dispatched work is done before reading the clock
    try:
        jax.effects_barrier()
    except Exception:
        pass
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = results.get(label, 0.0) + dt
    if verbose:
        print(f"[{label}] {dt:.4f} s")


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler device trace (view with TensorBoard)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Accumulating named-phase timer."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    def phase(self, label: str, verbose: bool = False):
        return timed(label, self.phases, verbose)

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k:>24s}: {v:8.3f} s ({100 * v / total:5.1f}%)" for k, v in self.phases.items()]
        lines.append(f"{'total':>24s}: {total:8.3f} s")
        return "\n".join(lines)
