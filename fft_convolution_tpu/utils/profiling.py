"""Tracing and observability.

The reference's only instrumentation is wall-clock ``Instant`` timing in the
example (``examples/compare_partitioned.rs:28,36-53``).  Here:

* :func:`trace` — context manager around ``jax.profiler`` producing a
  TensorBoard-loadable device trace of the region;
* :func:`annotate` — named trace span (shows up inside the device trace);
* :class:`LatencyRecorder` — streaming per-block latency percentiles for
  real-time serving dashboards (p50/p95/p99 + xRT).
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np


def gpu_cards() -> str:
    """Name and power limit of every NVIDIA card as ``nvidia-smi`` reports
    them (``; ``-joined) — a card set below its 700 W maximum runs slower
    under load, so every measurement is reported beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device profile of the enclosed region into ``logdir``
    (view with TensorBoard's profile plugin or Perfetto)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span annotation visible inside device traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)


@dataclass
class LatencyRecorder:
    """Accumulates per-block wall latencies; reports serving percentiles."""

    block_size: int
    sample_rate: float
    samples_s: List[float] = field(default_factory=list)

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples_s.append(time.perf_counter() - t0)

    def percentile_ms(self, q: float) -> float:
        return float(np.percentile(np.asarray(self.samples_s), q) * 1e3)

    def report(self) -> dict:
        block_s = self.block_size / self.sample_rate
        arr = np.asarray(self.samples_s)
        return {
            "n_blocks": len(arr),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "xrt_median": block_s / float(np.median(arr)),
            "deadline_misses": int(np.sum(arr > block_s)),
        }
