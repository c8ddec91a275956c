"""The traced window, read from ``torch.profiler``.

``Trace.from_profile`` keeps the device's operations (kernels, copies,
sets; not the annotations that echo the host's spans there) and the host's
operations and spans of the profiled window. The busy
time is the union of the device intervals (a copy of the port's
``scripts/torch_kernel_bench.py:device_time``), the idle share one minus
busy over the window, and ``breakdown`` lists the device operations that
took most time and the idle gaps by what the host was doing meanwhile.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Span = Tuple[str, float, float]  # name, start s, end s

WINDOW_SPAN = 'portbench.window'


def union_seconds(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of intervals."""
    total, end = 0.0, float('-inf')
    for s, t in sorted(spans):
        if t > end:
            total += t - max(s, end)
            end = t
    return total


def merged(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [(s, t) for s, t in out]


def is_kernel(name: str) -> bool:
    return not name.startswith(('Memcpy', 'Memset'))


@dataclass
class Trace:
    window_s: float                  # the traced window, host clock
    device: List[Span]               # device operations in the window
    host: List[Span] = field(default_factory=list)
    start: float = 0.0               # the window's span, profiler time
    end: float = 0.0

    @classmethod
    def from_profile(cls, prof, window_s: float) -> 'Trace':
        from torch.autograd import DeviceType
        device, host = [], []
        start = end = None
        for e in prof.events():
            span = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            if e.device_type == DeviceType.CUDA:
                # the benchmark's own spans are echoed on the device's
                # timeline as annotations: no operation ran there
                if not (getattr(e, 'is_user_annotation', False)
                        or e.name.startswith('portbench.')):
                    device.append(span)
            else:
                host.append(span)
                if e.name == WINDOW_SPAN:
                    start, end = span[1], span[2]
        if start is None:
            start = min((s for _, s, _ in device), default=0.0)
            end = start + window_s
        return cls(window_s, device, host, start, end)

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, t) for _, s, t in self.device])

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def kernels(self, name: str) -> List[Span]:
        """Device operations whose name holds ``name``."""
        return [e for e in self.device if name in e[0]]

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, s, t in self.device:
            out[n] += t - s
        return dict(out)

    def n_kernels(self) -> int:
        return sum(1 for n, _, _ in self.device if is_kernel(n))

    def host_labels(self, times: List[float]) -> List[str]:
        """What the host was doing at each profiler time of ``times``
        (ascending): the benchmark's span around it and the innermost host
        operation inside that, by one sweep over the host's spans."""
        host = sorted((e for e in self.host if e[0] != WINDOW_SPAN),
                      key=lambda e: e[1])
        out, active, i = [], [], 0
        for t in times:
            while i < len(host) and host[i][1] <= t:
                active.append(host[i])
                i += 1
            active = [e for e in active if e[2] >= t]
            if not active:
                out.append('host, no operation recorded')
                continue
            inner = max(active, key=lambda e: e[1])[0]
            outer = next((e[0] for e in active
                          if e[0].startswith('portbench.')), inner)
            out.append(inner if outer == inner else f'{outer} / {inner}')
        return out

    def breakdown(self, top: int = 10) -> dict:
        """``device_ops``: the ``top`` device operations by total seconds;
        ``idle_gaps``: the window's idle seconds between device operations
        summed by what the host was doing at each gap's middle, the
        ``top`` largest."""
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])
        busy = merged([(s, t) for _, s, t in self.device])
        holes, prev = [], self.start
        for s, t in busy + [(self.end, self.end)]:
            if s > prev:
                holes.append((prev, s))
            prev = max(prev, t)
        gaps = defaultdict(float)
        labels = self.host_labels([(s + t) / 2 for s, t in holes])
        for (s, t), label in zip(holes, labels):
            gaps[label] += t - s
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])
        return {'device_ops': [[n[:160], v] for n, v in ops[:top]],
                'idle_gaps': [[n[:160], v] for n, v in idle[:top]]}
