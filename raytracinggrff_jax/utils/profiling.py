"""Lightweight timing + device profiler hooks.

The reference's only observability is perf_counter timing in
bench_raytrace.py and tqdm progress bars; here timers are structured and the
JAX profiler can capture device traces for any pipeline stage.
"""

from __future__ import annotations

import contextlib
import time


class StageTimer:
    """Accumulating named stage timer.

    with timer.stage("trace"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total:9.3f}s  x{n}"
                         f"  ({total / n:.3f}s avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir):
    """Capture an XLA device profile (view with tensorboard/xprof)."""
    import jax
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()
