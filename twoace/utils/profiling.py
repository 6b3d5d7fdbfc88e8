"""Profiling and timing utilities.

Replaces the reference's MATLAB ``profile on`` / ``tic-toc`` scaffolding
(ref: A2only.m:19, Vs_M_par.m:54,144,198) with structured timers and
``jax.profiler`` trace capture.  JAX dispatches asynchronously, so a timed
section must end in :func:`sync` (``jax.block_until_ready``).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional

import jax


def sync(tree) -> None:
    """Device barrier: waits until every array in ``tree`` is computed."""
    jax.block_until_ready(tree)


class Timer:
    """Named accumulating wall-clock timers with rate reporting."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync_tree=None):
        t0 = time.perf_counter()
        yield
        if sync_tree is not None:
            sync(sync_tree)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def rate(self, name: str, units_per_call: float = 1.0) -> float:
        if self.totals[name] == 0:
            return float("nan")
        return self.counts[name] * units_per_call / self.totals[name]

    def report(self) -> str:
        rows = [
            {"section": k, "total_s": round(v, 4),
             "calls": self.counts[k],
             "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
            for k, v in sorted(self.totals.items())
        ]
        return json.dumps(rows)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Capture a jax.profiler trace when ``log_dir`` is set; no-op otherwise."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
