#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``pixelrec_multimodal_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. The cell, its configuration, its traffic and its metrics are found by
name (``portbench/spec.py``). The run makes its inputs from ``--seed``,
sets up the port, serves warm-up calls of the window's own shapes, then
measures for ``--seconds`` (the window closes at the first completion after
it), untraced, and:

* ``--trace 0``: reports the cell's end-to-end metrics from that window;
* ``--trace 1``: profiles two slices of the calls that the cell's file
  names, one with the device's activity alone (busy and window seconds,
  the kernels, the rooflines, the device operations of the breakdown) and
  one with the host's operations too (what the host did in each idle
  gap), and reports the cell's per-layer metrics, each from its reader in
  ``portbench/layer_metrics/``; a rate the metrics need (a share of the
  peak, the idle share) is the untraced window's, since even the device's
  profiler slows a host-bound loop.

Then it checks what the timed path produced against the plain reference
(``portbench/reference/``), with the port's state freed, and prints each
number compared beside its limit as the last lines of standard error, and
one JSON line as the last line of standard output. It exits 2 without the
CUDA devices the cell needs and 3 if JAX or the JAX package was loaded by
the time the result is due, printing no result then.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Optional  # noqa: E402

import torch  # noqa: E402

from portbench import endtoend, spec  # noqa: E402
from portbench.trace import WINDOW_SPAN, Trace  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pixelrec_multimodal_tpu')


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock, from its
    age in ``/proc`` (10 ms steps)."""
    with open('/proc/self/stat') as f:
        start_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return time.perf_counter() - (uptime
                                  - start_ticks / os.sysconf('SC_CLK_TCK'))


def forbidden_modules() -> list:
    """Modules of JAX or the JAX package loaded in this process, compared
    by whole top-level name."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Run:
    """What a per-layer reader reads: the cell, the traced slice of calls
    (``window``: each call's host times and work units) with its device
    trace, and the untraced window's rate (work units a second)."""
    cell: spec.Cell
    trace: Trace
    window: endtoend.Window
    rate: float


def measure(traffic, seconds: Optional[float] = None,
            calls: Optional[int] = None) -> endtoend.Window:
    """Calls back to back until ``seconds`` have passed (the window closes
    at the first completion after) or ``calls`` have completed."""
    from torch.profiler import record_function
    w = endtoend.Window(start=time.perf_counter())
    while True:
        with record_function('portbench.client'):
            traffic.prepare()
        t0 = time.perf_counter()
        with record_function('portbench.call'):
            units = traffic.call()
        t1 = time.perf_counter()
        w.calls.append((t0, t1, units))
        if (seconds is not None and t1 - w.start >= seconds) or \
                (calls is not None and len(w.calls) >= calls):
            return w


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def traced(traffic, calls: int, device, host: bool) -> tuple:
    """A slice of ``calls`` under the profiler, with the device's activity
    and, where ``host``, the host's operations too: (window, trace)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU] if host else []
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            w = measure(traffic, calls=calls)
            sync(device)
            window_s = time.perf_counter() - w.start
    return w, Trace.from_profile(prof, window_s)


def card(device) -> dict:
    """The card's name and its power limit, as ``nvidia-smi`` reports it."""
    out = {'kind': torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader',
             f'--id={torch.device(device).index or 0}'],
            capture_output=True, text=True, timeout=20)
        out['nvidia_smi'] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out['nvidia_smi'] = f'not read: {e}'
    return out


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        options: Optional[dict] = None, started: float = 0.0) -> tuple:
    """One run of ``cell``: (its result line, the readings of the check
    that are not compared, with the set-up's phases). ``options`` reach the
    traffic (a control, for ``calibrate.py``); ``started`` is the process's
    start, where ``setup_s`` begins."""
    on_card = torch.device(device).type == 'cuda'
    traffic = spec.generator(cell.traffic['generator']).Traffic(
        cell, seed, device, options)
    traffic.setup()
    sync(device)
    window = measure(traffic, seconds=seconds)
    metrics, extra, dev_fields, rates = {}, {}, {}, {}
    if trace:
        calls = cell.settings['trace']['calls']
        w, tr = traced(traffic, calls, device, host=not on_card)
        host_tr = (traced(traffic, calls, device, host=True)[1] if on_card
                   else tr)
        ctx = Run(cell, tr, w, endtoend.rate(window))
        for m in cell.per_layer:
            value = spec.layer_reader(m['name'])(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        extra['breakdown'] = {'device_ops': tr.breakdown()['device_ops'],
                              'idle_gaps': host_tr.breakdown()['idle_gaps']}
        rates = {'window': endtoend.rate(window),
                 'device_traced': endtoend.rate(w)}
        dev_fields = {'busy_s': tr.busy_s, 'window_s': tr.window_s}
    else:
        for m in cell.end_to_end:
            value = (window.start - started if m['name'] == 'setup_s'
                     else endtoend.METRICS[m['name']](window))
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    peak = (max(torch.cuda.max_memory_allocated(i) for i in range(cell.chips))
            if on_card else 0)
    device_info = {'platform': 'gpu' if on_card else 'cpu',
                   **(card(device) if on_card else {'kind': 'cpu'}),
                   'count': cell.chips, 'memory_peak_bytes': peak,
                   **dev_fields}
    readings = traffic.readings()
    limits = cell.settings['limits']
    checks = {name: {'value': readings[name], 'limit': limit}
              for name, limit in limits.items()}
    correct = all(c['value'] <= c['limit'] for c in checks.values())
    result = {'correct': correct, 'attempted': readings['attempted'],
              'failed': readings['failed'], 'metrics': metrics,
              'device': device_info, **extra, 'checks': checks}
    readings = {k: v for k, v in readings.items() if k not in checks}
    readings['setup_phases_s'] = traffic.phases.seconds
    if rates:
        readings['rates'] = rates
    # the last look before the result: whatever the check or the
    # reference loaded counts too
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    return result, readings


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    started = process_start()
    # Every build and kernel cache inside the checkout, at fixed paths; the
    # port's own kernels build under build/kernels there.
    os.environ['TORCH_EXTENSIONS_DIR'] = str(ROOT / 'build'
                                             / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(ROOT / 'build' / 'triton')
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f'portbench: {args.workload} needs {cell.chips} CUDA '
              f'device(s); this machine has {have}', file=sys.stderr)
        return 2
    try:
        result, readings = run(cell, args.seed, args.seconds,
                               bool(args.trace), torch.device('cuda', 0),
                               started=started)
    except ForbiddenModules as e:
        print(f'portbench: JAX or the JAX package was loaded: {e}',
              file=sys.stderr)
        return 3
    print(f'readings: {json.dumps(readings)}', file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result['checks'].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
