"""Tracing and profiling utilities of the port.

Counterpart of :mod:`comprox_tpu.utils.profiling`: wall-clock stage
timers that wait for the device when a stage stops, a ``torch.profiler``
trace context that writes a Chrome trace, and the reference's percent
meter on stderr (the same text as the JAX package's).

No stage of the container is wrapped in :class:`StageTimers`: a timer
that synchronises would make the pipelined schedule wait for each block.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class StageTimers:
    """Named wall-clock accumulators; stopping a stage synchronises
    ``device`` (a CUDA device: ``torch.cuda.synchronize``; the CPU:
    nothing to wait for)."""

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    device: object = "cpu"

    @contextlib.contextmanager
    def stage(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                import torch

                dev = torch.device(self.device)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, out=sys.stderr) -> None:
        total = sum(self.totals.values()) or 1.0
        for name, secs in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            print(
                f"  {name:24} {secs:8.3f}s {secs / total:6.1%} "
                f"x{self.counts[name]}",
                file=out,
            )


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the CPU and (where there is one) the
    CUDA device, written as a Chrome trace into ``log_dir``; does nothing
    when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Progress:
    """The reference's percent meter (roxmain/cr-coder.c:37-49)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._last = -1

    def update(self, done: int, total: int) -> None:
        if not self.enabled or total <= 0:
            return
        pct = done * 100 // total
        if pct != self._last:
            self._last = pct
            print(f"\r{pct:3d}%", end="", file=sys.stderr, flush=True)
            if pct >= 100:
                print("", file=sys.stderr)
