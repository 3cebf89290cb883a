"""Phase timing and device traces.

Counterpart of fem_glass_tempering_tpu/utils/profiling.py: nested named
phase timers with a report, and a context manager around torch.profiler
that writes a Chrome trace (chrome://tracing, Perfetto) of the work inside
it, the GPU's kernels included when the device is CUDA.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

from fem_glass_tempering_tpu_torch.device import resolve_device

TRACE_FILE = "trace.json"


class PhaseTimer:
    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{'phase':<24}{'total_s':>10}{'calls':>8}{'avg_ms':>10}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<24}{t:>10.3f}{c:>8}{t / c * 1e3:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Trace the host's PyTorch operations and, on a CUDA device (the
    default, as for every entry point), the device's kernels into
    `log_dir`/trace.json. Usage: `with device_trace('/tmp/trace'):
    prob.solve()`."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
