"""Structured timing + device profiling.

Replaces the reference's bracket-and-print time.time() scattering
(SURVEY.md §5) with:

* ``timer(name)`` — context manager accumulating wall-clock per stage
  into a process-wide registry (printed summary on demand);
* ``device_trace(logdir)`` — jax.profiler trace context for TensorBoard
  (per-kernel device timings);
* ``block_scorer_gather_count`` so benchmarks can report table-gather
  throughput, not just candidate rates.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

_REGISTRY: Dict[str, list] = defaultdict(lambda: [0.0, 0])


@contextlib.contextmanager
def timer(name: str) -> Iterator[None]:
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        _REGISTRY[name][0] += elapsed
        _REGISTRY[name][1] += 1


_COUNTERS: Dict[str, int] = defaultdict(int)


def count(name: str, n: int = 1) -> None:
    """Accumulate an event counter (printed alongside the timers)."""
    _COUNTERS[name] += n


def summary() -> Dict[str, dict]:
    return {
        name: {"total_s": round(total, 4), "calls": calls}
        for name, (total, calls) in sorted(_REGISTRY.items())
    }


def counters() -> Dict[str, int]:
    return dict(sorted(_COUNTERS.items()))


def reset() -> None:
    _REGISTRY.clear()
    _COUNTERS.clear()


def print_summary() -> None:
    for name, stats in summary().items():
        print(f"[timer] {name}: {stats['total_s']}s over {stats['calls']} call(s)")
    for name, n in counters().items():
        print(f"[counter] {name}: {n}")


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """jax.profiler trace (view with TensorBoard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def block_scorer_gather_count(n_candidates: int, n_scaffolds: int) -> int:
    """Table gathers issued per brute-force batch."""
    return n_candidates * (n_scaffolds * (n_scaffolds - 1) // 2)

