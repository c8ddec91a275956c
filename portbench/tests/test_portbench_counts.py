"""The frozen operation and byte counts against hand counts, and the trace
arithmetic on synthetic events."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import counts, endtoend, spec
from portbench.run import Run
from portbench.trace import Trace, merged, union_seconds

CONCAT = spec.load_json(spec.HERE / 'configs' / 'concat-resnet50-minilm.json')
GATED = spec.load_json(spec.HERE / 'configs' / 'gated-clip-b32-mpnet.json')


def test_pair_ops_by_hand():
    # hidden products 2 (512 x 256 + 256 x 128) = 327,680
    assert counts.pair_ops(CONCAT) == 327_680 + 3 * 512 + 2 * 128 == 329_472
    # M = 6: the softmax 6 M, the gated sum 2 M h1 and the activation h1
    assert counts.pair_ops(GATED) == (327_680 + 2 * 6 * 512 + 512 + 36
                                      + 256) == 334_628


def test_sample_forward_ops_by_hand():
    projections = 2 * (2048 + 384 + 3) * 64
    mlp = 2 * (6 * 64 * 512 + 512 * 256 + 256 * 128) + 2 * 128
    assert counts.sample_forward_ops(CONCAT) == projections + mlp == 1_032_832
    gated = (2 * (768 + 768 + 7) * 128 + 2 * 768 * 6 + 2 * 6 * 128
             + 2 * (128 * 512 + 512 * 256 + 256 * 128) + 2 * 128)
    assert counts.sample_forward_ops(GATED) == gated


def test_request_bytes_by_hand():
    weights = 2 * (512 * 256 + 256 * 128) + 4 * (256 + 128 + 128 + 1)
    assert counts.request_bytes(CONCAT, 512, 65536) == (
        4 * (512 * 512 + 65536 * 512 + 512 * 65536) + weights)
    assert counts.request_bytes(GATED, 2, 3) == (
        4 * (2 * (512 + 6) + 3 * (5 * 512 + 6) + 2 * 3) + weights)
    # the pair kernel's work is bound by the products, not the bytes
    ops = 512 * 65536 * counts.pair_ops(CONCAT)
    assert counts.roofline_seconds(
        ops, counts.request_bytes(CONCAT, 512, 65536)) \
        == ops / counts.PEAK_BF16_FLOPS


def test_union_of_intervals():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.75), (10.0, 10.0)]
    assert union_seconds(spans) == pytest.approx(3.0)
    assert merged(spans) == [(0.0, 2.0), (3.0, 4.0), (10.0, 10.0)]
    assert union_seconds([]) == 0.0


def synthetic_trace() -> Trace:
    device = [('pairwise_mlp_kernel<false>', 0.0, 0.4),
              ('pairwise_mlp_kernel<false>', 0.5, 0.9),
              ('Memcpy DtoH (Device -> Pageable)', 0.9, 0.95),
              ('topk_kernel', 0.92, 1.0)]
    host = [('portbench.window', 0.0, 2.0),
            ('portbench.call', 0.0, 1.2),
            ('aten::nonzero', 0.4, 0.5),
            ('portbench.client', 1.3, 2.0)]
    return Trace(window_s=2.0, device=device, host=host, start=0.0, end=2.0)


def test_trace_busy_idle_and_breakdown():
    t = synthetic_trace()
    assert t.busy_s == pytest.approx(0.9)
    assert t.idle_share == pytest.approx(0.55)
    assert t.n_kernels() == 3
    b = t.breakdown()
    assert b['device_ops'][0] == ['pairwise_mlp_kernel<false>',
                                  pytest.approx(0.8)]
    gaps = dict(b['idle_gaps'])
    assert gaps['portbench.call / aten::nonzero'] == pytest.approx(0.1)
    assert gaps['portbench.client'] == pytest.approx(1.0)
    assert Trace(1.0, [], [], 0.0, 1.0).breakdown()['idle_gaps'] == [
        ['host, no operation recorded', 1.0]]


def slice_of(units):
    return endtoend.Window(start=0.0, calls=[(0.1 * i, 0.1 * i + 0.05, u)
                                             for i, u in enumerate(units)])


def test_layer_readers_on_a_synthetic_trace():
    cell = spec.cell('concat.topk-seen.u512')
    t = synthetic_trace()
    pairs = 2 * 512 * 65536.0
    run = Run(cell, t, slice_of([pairs / 2] * 2), rate=pairs / 2.0)
    least = 2 * 512 * 65536 * 329_472 / counts.PEAK_BF16_FLOPS
    assert spec.layer_reader('K1_roofline')(run) == pytest.approx(
        100 * least / 0.8)
    assert spec.layer_reader('K2_roofline')(run) is None
    assert spec.layer_reader('scan_other_share.topk')(run) == pytest.approx(
        100 * 0.13 / 0.9)
    # busy 0.9 s for the slice's pairs, which the untraced window does in
    # 2 s: idle 55%; a share of the peak takes the untraced window's rate
    assert spec.layer_reader('idle_share.topk')(run) == pytest.approx(55.0)
    assert spec.layer_reader('mfu.topk')(run) == pytest.approx(
        100 * pairs / 2.0 * 329_472 / counts.PEAK_BF16_FLOPS)
    slower = Run(cell, t, run.window, rate=pairs / 4.0)
    assert spec.layer_reader('idle_share.topk')(slower) == pytest.approx(
        77.5)
    train_cell = spec.cell('concat.train.b262144')
    batch = train_cell.config['training']['batch_size']
    train = Run(train_cell, t, slice_of([batch * 1.5] * 2), rate=4e6)
    assert spec.layer_reader('launches_per_step.train')(train) == 1.0
    assert spec.layer_reader('mfu.train')(train) == pytest.approx(
        100 * 4e6 * 3 * 1_032_832 / counts.PEAK_BF16_FLOPS)
    assert spec.layer_reader('idle_share.train')(train) == pytest.approx(
        100 * (1 - 0.9 / (3 * batch) * 4e6))
    empty = Run(cell, Trace(1.0, []), slice_of([]), rate=0.0)
    for name in ('K1_roofline', 'scan_other_share.topk', 'idle_share.topk',
                 'mfu.topk'):
        assert spec.layer_reader(name)(empty) is None


def test_end_to_end_arithmetic():
    w = endtoend.Window(start=10.0, calls=[(10.0 + i, 10.5 + i, 100.0)
                                           for i in range(20)])
    assert endtoend.rate(w) == pytest.approx(2000 / 19.5)
    assert endtoend.p95_ms(w) == pytest.approx(500.0)
    one = endtoend.Window(start=0.0, calls=[(0.0, 0.25, 1.0)])
    assert endtoend.p95_ms(one) == pytest.approx(250.0)


def test_from_profile_keeps_device_operations_not_annotations():
    from torch.autograd import DeviceType

    def event(name, start_us, end_us, device, annotation=False):
        return SimpleNamespace(
            name=name, device_type=device, is_user_annotation=annotation,
            time_range=SimpleNamespace(start=start_us, end=end_us))
    prof = SimpleNamespace(events=lambda: [
        event('portbench.window', 0, 1e6, DeviceType.CPU),
        event('portbench.call', 0, 9e5, DeviceType.CPU),
        event('portbench.call', 0, 9e5, DeviceType.CUDA, annotation=True),
        event('gpu_user_annotation', 0, 9e5, DeviceType.CUDA,
              annotation=True),
        event('pairwise_mlp_kernel', 1e5, 3e5, DeviceType.CUDA)])
    t = Trace.from_profile(prof, 1.0)
    assert [e[0] for e in t.device] == ['pairwise_mlp_kernel']
    assert (t.start, t.end) == (0.0, 1.0)
    assert t.busy_s == pytest.approx(0.2) and t.idle_share == pytest.approx(
        0.8)
