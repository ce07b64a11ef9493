"""Tracing / profiling / observability (SURVEY 5 aux subsystems).

The reference only has wall-clock spans around compress/decompress
(tests/benchmark.py:17-19).  Here:

- :class:`StageTimer` -- named wall-clock spans with JSON export, used by
  the benchmark harness for per-stage breakdowns (transform vs entropy vs
  transfer vs stitch).
- :func:`trace` -- context manager around ``jax.profiler`` for on-device
  traces viewable in TensorBoard/XProf.
- :func:`device_sync_cost` -- measures the host<->device round trip of
  one forced sync (the floor under any per-call latency).
- :func:`run_record` -- canonical per-run JSON metrics record (MP/s,
  ratios, PSNR deltas) so results are machine-comparable across runs.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict


class StageTimer:
    """Accumulating named wall-clock spans."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": round(v, 6), "count": self.counts[k]}
            for k, v in sorted(self.totals.items())
        }

    def json(self) -> str:
        return json.dumps(self.summary())


@contextlib.contextmanager
def trace(log_dir: str):
    """On-device profiler trace (open with TensorBoard's profile plugin)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_sync_cost(reps: int = 5) -> float:
    """Median seconds for one forced device->host scalar sync."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x + 1)
    x = jnp.float32(0)
    float(f(x))  # compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(f(x))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def run_record(
    workload: str,
    megapixels: float,
    seconds: float,
    extra: dict | None = None,
) -> dict:
    """Canonical benchmark record (one JSON-able dict per run)."""
    import jax

    rec = {
        "workload": workload,
        "megapixels": round(megapixels, 4),
        "seconds": round(seconds, 6),
        "mp_per_s": round(megapixels / seconds, 2) if seconds else None,
        "device": str(jax.devices()[0]),
        "n_devices": len(jax.devices()),
        "timestamp": time.time(),
    }
    if extra:
        rec.update(extra)
    return rec
