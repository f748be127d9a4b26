"""Every cell, configuration and per-layer metric of BENCHMARK.json is
found by name from its files, and BENCHMARK.json keeps to its contract's
shape."""

import json
import os
import re

import pytest

from port_bench.harness.spec import BENCH_DIR, REPO_DIR, Cell, reader_path

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')

with open(os.path.join(REPO_DIR, 'BENCHMARK.json')) as f:
    BENCH = json.load(f)
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['port_bench']
    assert BENCH['command'][1] == 'port_bench/run.py'
    assert 1 <= BENCH['run_seconds'] <= 51


@pytest.mark.parametrize('name', CELLS)
def test_cell_files_found_by_name(name):
    cell = Cell(name)
    assert cell.config['name'] == cell.entry['config']
    assert cell.traffic['kind'] == 'fit'
    assert set(cell.limits) == {'grad_gap', 'change_gap', 'grad_diff',
                                'late_grad_diff'}
    assert sorted(m['name'].split('.')[0] for m in cell.end_to_end) == [
        'setup_s', 'train_samples_per_s']
    assert cell.per_layer, 'a cell reports at least one per-layer metric'
    for m in cell.per_layer:
        reader = cell.reader(m['name'])
        assert callable(reader.read) and isinstance(reader.KERNELS, tuple)


@pytest.mark.parametrize('config', BENCH['configs'],
                         ids=[c['name'] for c in BENCH['configs']])
def test_config_files(config):
    path = os.path.join(REPO_DIR, config['file'])
    assert config['file'] == 'port_bench/configs/{0}.json'.format(
        config['name'])
    with open(path) as f:
        cfg = json.load(f)
    assert cfg['name'] == config['name']
    assert cfg['source'] == config['source']
    assert cfg['reduced'] == config['reduced']
    assert cfg['precision'] == 'float32'
    assert os.path.isfile(os.path.join(BENCH_DIR, 'models',
                                       cfg['family'] + '.py'))
    assert os.path.isfile(os.path.join(BENCH_DIR, 'reference',
                                       cfg['family'] + '.py'))
    used = {w['config'] for w in BENCH['workloads']}
    assert config['name'] in used


def test_names_units_and_metrics():
    names = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    names += CELLS + [c['name'] for c in BENCH['configs']]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {m['name'] for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e
    for m in BENCH['end_to_end']:
        assert UNIT.match(m['unit'])
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in BENCH['per_layer']:
        assert UNIT.match(m['unit'])
        assert m['moves'] in e2e
        assert set(m['workloads']) <= set(CELLS)
        assert os.path.isfile(reader_path(BENCH_DIR, m['name']))
        if 'roofline' in m['name'] or 'mfu' in m['name']:
            assert m['unit'] == '%'


def test_a_metric_without_a_file_of_its_own_reads_its_quantity(tmp_path):
    (tmp_path / 'metrics').mkdir()
    for name in ('mfu', 'mfu.special'):
        (tmp_path / 'metrics' / (name + '.py')).write_text('')
    assert reader_path(str(tmp_path), 'mfu.train').endswith('/mfu.py')
    assert reader_path(str(tmp_path), 'mfu.special').endswith(
        '/mfu.special.py')
