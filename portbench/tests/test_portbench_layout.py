"""BENCHMARK.json and the files the harness finds by name keep to the
benchmark's format, limits and names; a run's last line carries the keys a
result line needs."""
from __future__ import annotations

import copy
import json
import re

import pytest
import torch

from portbench import endtoend, run, spec

BENCH = spec.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
CELLS = [w['name'] for w in BENCH['workloads']]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert len((spec.ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH['paths']) <= 16
    for p in BENCH['paths']:
        assert PATH.match(p) and '..' not in p and not p.startswith('/')
        assert (spec.ROOT / p).is_dir()
    assert len(BENCH['command']) <= 32
    assert all(line(w) for w in BENCH['command'])
    script = spec.ROOT / BENCH['command'][1]
    assert script.is_file()
    assert any(script.resolve().is_relative_to((spec.ROOT / p).resolve())
               for p in BENCH['paths'])
    rs = BENCH['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits in 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    metrics = BENCH['end_to_end'] + BENCH['per_layer']
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    assert len({m['name'] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert line(c['source']) and line(c['why'])
        assert len(c['reduced']) <= 16 and all(NAME.match(k)
                                               for k in c['reduced'])
        assert c['file'].startswith(tuple(p + '/' for p in BENCH['paths']))
        assert (spec.ROOT / c['file']).is_file()
    assert len({c['file'] for c in BENCH['configs']}) == len(BENCH['configs'])
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and line(w['why'])
        assert NAME.match(w['config']) and NAME.match(w['traffic'])
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    assert sum(w['chips'] == 4 for w in BENCH['workloads']) <= max(
        1, len(CELLS) // 4)
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}
    for m in BENCH['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert line(m['layer'])


def test_setup_s_is_reported_by_every_cell_with_its_bound():
    setup = next(m for m in BENCH['end_to_end'] if m['name'] == 'setup_s')
    assert 'workloads' not in setup and setup['bound'] <= 0.25


@pytest.mark.parametrize('name', CELLS)
def test_cell_files_are_found_by_name(name):
    c = spec.cell(name)
    assert c.config['source'] == next(
        x['source'] for x in BENCH['configs'] if x['name'] == c.config_name)
    spec.generator(c.traffic['generator']).Traffic
    assert c.settings['trace']['calls'] >= 1 and c.settings['limits']
    for m in c.per_layer:
        assert callable(spec.layer_reader(m['name']))
    e2e = {m['name'] for m in c.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2 and c.per_layer
    assert all(n == 'setup_s' or n in endtoend.METRICS for n in e2e)


@pytest.mark.parametrize('metric', BENCH['per_layer'],
                         ids=[m['name'] for m in BENCH['per_layer']])
def test_per_layer_metric_cells_report_what_it_moves(metric):
    moved = next(m for m in BENCH['end_to_end']
                 if m['name'] == metric['moves'])
    for cell in metric.get('workloads', CELLS):
        assert cell in CELLS
        assert 'workloads' not in moved or cell in moved['workloads']
    assert (spec.HERE / 'layer_metrics' / f"{metric['name']}.py").is_file()
    layers = {m['layer'] for m in BENCH['per_layer']}
    assert metric['layer'] in layers


def test_every_metric_reader_and_cell_file_is_listed():
    listed = {m['name'] for m in BENCH['per_layer']}
    assert {p.stem for p in (spec.HERE / 'layer_metrics').glob('*.py')} \
        == listed
    assert {p.stem for p in (spec.HERE / 'workloads').glob('*.json')} \
        == set(CELLS)


def test_without_a_card_the_run_exits_non_zero_and_prints_no_result(
        capsys):
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA device')
    rc = run.main(['--workload', CELLS[0], '--seed', '2147483711',
                   '--seconds', '1', '--trace', '0'])
    assert rc != 0 and capsys.readouterr().out == ''


def tiny_cell(name: str, **traffic) -> spec.Cell:
    c = spec.cell(name)
    c.config = copy.deepcopy(c.config)
    c.traffic = {**c.traffic, **traffic}
    c.config.update(n_users=512, n_items=1024)
    return c


@pytest.mark.parametrize('trace', [False, True])
def test_result_line_carries_the_result_keys(trace):
    c = tiny_cell('concat.topk-seen.u512', users_per_request=16,
                  check_rows=8, warmup_requests=1)
    c.settings = {**c.settings, 'trace': {'calls': 2}}
    result, readings = run.run(c, 2147483713, 0.5, trace, 'cpu')
    keys = ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert list(result) == keys + (['breakdown'] if trace else []) + [
        'checks']
    assert set(result['device']) >= {'platform', 'kind', 'count',
                                     'memory_peak_bytes'}
    if trace:
        assert set(result['device']) >= {'busy_s', 'window_s'}
        assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    else:
        assert set(result['metrics']) == {m['name'] for m in c.end_to_end}
    for m in result['metrics'].values():
        assert set(m) == {'value', 'unit'}
    assert result['correct'] is True
    assert all(set(v) == {'value', 'limit'} for v in result['checks'].values())
    json.dumps(result)


@pytest.mark.cuda
def test_a_run_on_the_card_prints_a_correct_result_line(capsys):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rc = run.main(['--workload', 'concat.topk-all.u8192', '--seed',
                   '2147483731', '--seconds', '2', '--trace', '0'])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and result['correct'] is True
    assert result['device']['platform'] == 'gpu'
    assert result['device']['count'] == 1
