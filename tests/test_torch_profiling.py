"""The port's profiling utilities (``utils/profiling.py``) against the JAX
package's, on the CPU: ``ThroughputMeter``'s and ``StepTimer``'s
arithmetic and summaries from the same readings, the measuring contexts,
``device_memory_stats`` where no card is present, and a trace with a
named step written as a Chrome trace."""
import json
import time

import jax
import pytest

from pixelrec_multimodal_tpu.utils import profiling as jprof
from pixelrec_multimodal_tpu_torch.utils import profiling as tprof

READINGS = [(256, 0.125), (256, 0.0625), (128, 0.5)]


@pytest.mark.parametrize('meter_kw', [
    dict(), dict(unit='pairs'),
    dict(unit='samples', peak_flops=989e12, flops_per_unit=38.4e9),
    dict(peak_flops=1e12)], ids=['default', 'unit', 'peak', 'peak_only'])
def test_throughput_meter_matches_jax(meter_kw):
    """The same readings give JAX's totals, rate, utilization and summary,
    key for key and value for value."""
    j, t = jprof.ThroughputMeter(**meter_kw), tprof.ThroughputMeter(**meter_kw)
    for n, s in READINGS:
        j.add(n, s)
        t.add(n, s)
    assert (t.total_units, t.total_seconds, t.calls) == (
        j.total_units, j.total_seconds, j.calls)
    assert t.rate == j.rate == 640 / 0.6875
    assert t.utilization() == j.utilization()
    assert t.summary() == j.summary()
    assert ('flops_utilization' in t.summary()) == ('flops_per_unit'
                                                    in meter_kw)
    empty = tprof.ThroughputMeter(**meter_kw)
    assert empty.rate == 0.0 and empty.summary() == jprof.ThroughputMeter(
        **meter_kw).summary()


def test_meter_and_timer_measure_their_blocks():
    """``measure`` and ``phase`` add the block's seconds (and units), as
    JAX's do; an exception inside still counts the call."""
    meter = tprof.ThroughputMeter(unit='pairs')
    with meter.measure(n=1000):
        time.sleep(0.02)
    with pytest.raises(RuntimeError):
        with meter.measure(n=10):
            raise RuntimeError
    assert meter.calls == 2 and meter.total_units == 1010
    assert meter.total_seconds >= 0.02
    timer = tprof.StepTimer()
    for _ in range(2):
        with timer.phase('step'):
            time.sleep(0.01)
    with timer.phase('data'):
        pass
    assert sorted(timer.phases) == ['data', 'step']
    assert timer.phases['step'] >= 0.02
    timer.reset()
    assert timer.phases == {}


def test_step_timer_summary_matches_jax():
    phases = {'step': 1.234, 'data': 0.5, 'eval': 2.0, 'checkpoint': 0.004}
    j, t = jprof.StepTimer(), tprof.StepTimer()
    j.phases.update(phases)
    t.phases.update(phases)
    assert t.summary() == j.summary()
    assert t.summary().startswith('total=3.74s ')


def test_device_memory_stats_without_a_card():
    """No CUDA device here: an empty dict, as JAX's gives for its CPU
    device, which reports no memory statistics."""
    assert tprof.device_memory_stats() == {}
    assert jax.devices()[0].platform == 'cpu'
    assert jprof.device_memory_stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` writes ``trace.json`` with the annotated step in it."""
    import torch
    with tprof.trace(str(tmp_path / 'profile')):
        with tprof.step_annotation('e2e_train_step'):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / 'profile' / tprof.TRACE_FILE)
                        .read_text())['traceEvents']
    assert any(e.get('name') == 'e2e_train_step' for e in events)
