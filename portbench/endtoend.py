"""The end-to-end arithmetic: what a user of the system sees, from the host
clock around the calls of the measured window.

A window starts at its first call and closes at the first completion after
``--seconds``; every call completed in it counts. A rate is the work of
every completed call over the span from the window's start to the last
completion; a tail is the percentile of every call's latency, each timed
from the call to its return (the calls end synced: they return host arrays
or read a loss on the host). ``setup_s`` runs from the process's start to
the window's first call.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple


@dataclass
class Window:
    start: float                       # host clock (perf_counter)
    calls: List[Tuple[float, float, float]] = field(default_factory=list)
    # (call, return, work units) per completed call

    @property
    def end(self) -> float:
        return self.calls[-1][1] if self.calls else self.start

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def work(self) -> float:
        return sum(u for _, _, u in self.calls)


def rate(w: Window) -> float:
    return w.work / w.seconds


def p95_ms(w: Window) -> float:
    lat = [(t - s) * 1e3 for s, t, _ in w.calls]
    if len(lat) == 1:
        return lat[0]
    return statistics.quantiles(lat, n=20, method='inclusive')[18]


# End-to-end metric name -> its arithmetic over the window.
METRICS: Dict[str, Callable[[Window], float]] = {
    'topk_pairs_per_s': rate,
    'eval_pairs_per_s': rate,
    'topk_request_p95_ms': p95_ms,
    'train_samples_per_s': rate,
}

