"""Tracing and throughput instrumentation, in PyTorch.

Counterpart of ``pixelrec_multimodal_tpu/utils/profiling.py`` (A13):
``torch.profiler`` trace capture around a code region, written as a
Chrome trace (open it in Perfetto or ``chrome://tracing``; no
TensorBoard package is needed), named step annotations, throughput
counters (examples/s, achieved FLOP/s against a stated peak), per-phase
wall-clock accounting and the device's memory use.

``ThroughputMeter.measure`` and ``StepTimer.phase`` time what they
enclose on the card: where CUDA is initialized they call
``torch.cuda.synchronize()`` on entry and on exit, so the interval holds
the device work the block enqueued and none from before it (PyTorch
returns before the card finishes). Elsewhere they read the host's clock
alone.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = 'trace.json'


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the enclosed region (the
    host, and the card where CUDA is available) into
    ``<log_dir>/trace.json``. Example:

        with trace('/tmp/profile'):
            train_step(state, batch)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def step_annotation(name: str) -> Iterator[None]:
    """Annotate a region so it shows up named in profiler timelines."""
    with torch.profiler.record_function(name):
        yield


@dataclass
class ThroughputMeter:
    """Accumulates work units over time on the card:

        meter = ThroughputMeter(unit='pairs')
        with meter.measure(n=batch_pairs):
            step(...)
        print(meter.summary())
    """
    unit: str = 'examples'
    total_units: float = 0.0
    total_seconds: float = 0.0
    calls: int = 0
    # Optional hardware ceiling for utilization reporting.
    peak_flops: Optional[float] = None
    flops_per_unit: Optional[float] = None

    @contextlib.contextmanager
    def measure(self, n: float) -> Iterator[None]:
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.add(n, time.perf_counter() - t0)

    def add(self, n: float, seconds: float):
        self.total_units += n
        self.total_seconds += seconds
        self.calls += 1

    @property
    def rate(self) -> float:
        return self.total_units / self.total_seconds \
            if self.total_seconds > 0 else 0.0

    def utilization(self) -> Optional[float]:
        """Achieved / peak FLOP/s, when both are configured."""
        if not (self.peak_flops and self.flops_per_unit):
            return None
        return self.rate * self.flops_per_unit / self.peak_flops

    def summary(self) -> Dict[str, float]:
        out = {
            f'{self.unit}_per_sec': self.rate,
            'total_seconds': self.total_seconds,
            'calls': self.calls,
        }
        util = self.utilization()
        if util is not None:
            out['flops_utilization'] = util
        return out


@dataclass
class StepTimer:
    """Per-phase wall-clock accounting for a training loop (data / step /
    eval / checkpoint), printable as one line per epoch."""
    phases: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            self.phases[name] = self.phases.get(name, 0.0) + \
                time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(self.phases.values())
        parts = [f"{k}={v:.2f}s" for k, v in sorted(self.phases.items())]
        return f"total={total:.2f}s " + ' '.join(parts)

    def reset(self):
        self.phases.clear()


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per CUDA device (``'cuda:<i>'``), the bytes the caching allocator
    holds for tensors now (``bytes_in_use``) and at most since the last
    ``torch.cuda.reset_peak_memory_stats`` (``peak_bytes_in_use``), 0
    before CUDA is initialized; ``{}`` where no card is present."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f'cuda:{i}'] = {
            'bytes_in_use': stats.get('allocated_bytes.all.current', 0),
            'peak_bytes_in_use': stats.get('allocated_bytes.all.peak', 0),
        }
    return out
