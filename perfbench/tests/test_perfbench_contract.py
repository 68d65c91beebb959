"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
lookup of every file by name."""

import json
import re
import shutil

import pytest

import run
from harness import common

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')


@pytest.fixture(scope='module')
def bench():
    with open(run.ROOT / 'BENCHMARK.json') as f:
        return json.load(f)


def test_keys_and_names(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= bench['run_seconds'] <= 51
    assert 1 <= len(bench['paths']) <= 16
    for p in bench['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
    assert len(bench['command']) <= 32
    for word in bench['command']:
        assert not word.startswith('/') and '..' not in word
    names = [c['name'] for c in bench['configs']]
    names += [w['name'] for w in bench['workloads']]
    names += [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    names += [w['config'] for w in bench['workloads']]
    names += [w['traffic'] for w in bench['workloads']]
    names += [k for c in bench['configs'] for k in c['reduced']]
    for n in names:
        assert NAME.match(n), n
    for kind in ('configs', 'workloads'):
        listed = [e['name'] for e in bench[kind]]
        assert len(listed) == len(set(listed))
    metrics = [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    assert len(metrics) == len(set(metrics))
    for m in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for text in ([c['why'] for c in bench['configs']]
                 + [w['why'] for w in bench['workloads']]
                 + [c['source'] for c in bench['configs']]
                 + [m['layer'] for m in bench['per_layer']]):
        assert 1 <= len(text) <= 200 and '\n' not in text \
            and '\t' not in text


def test_entries_have_the_contract_keys(bench):
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    for w in bench['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4)
    for m in bench['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better',
                                          'bound', 'source'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    assert any(m['name'] == 'setup_s' and 'workloads' not in m
               for m in bench['end_to_end'])
    for m in bench['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better',
                                          'source', 'layer', 'moves'}


def test_every_cell_reports_what_its_metrics_move(bench):
    e2e = {m['name']: m for m in bench['end_to_end']}
    cells = {w['name'] for w in bench['workloads']}

    def reports(metric, cell):
        m = e2e[metric]
        return 'workloads' not in m or cell in m['workloads']

    for cell in cells:
        assert sum(reports(m, cell) for m in e2e) >= 2     # setup_s + one
    for m in bench['per_layer']:
        assert m['moves'] in e2e
        for cell in m.get('workloads', cells):
            assert cell in cells and reports(m['moves'], cell)
    for cell in cells:
        assert any(cell in m.get('workloads', cells)
                   for m in bench['per_layer'])


def test_every_file_is_found_by_name(bench):
    for w in bench['workloads']:
        _, cell, config, traffic = run.load_cell(w['name'])
        assert cell is not None and config['name'] == w['config']
        assert callable(run.driver(traffic['kind']))
        limits = run.limits_of(config, traffic)
        assert limits and all(v >= 0 for v in limits.values())
    for c in bench['configs']:
        assert c['file'].startswith(bench['paths'][0] + '/')
    for m in bench['per_layer']:
        assert callable(common.load_metric(m['name']))


def test_a_kind_is_found_by_its_driver_alone():
    assert callable(run.driver('train_dp'))
    with pytest.raises(SystemExit, match='no driver'):
        run.driver('no_such_kind')


def test_four_card_cells_are_few(bench):
    cells = bench['workloads']
    assert sum(w['chips'] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_a_new_mix_is_picked_up_from_its_file_alone(bench, tmp_path):
    """A later change adds a cell by adding a traffic file and an entry:
    no file of the harness changes."""
    shutil.copytree(run.HERE / 'traffic', tmp_path / run.HERE.name
                    / 'traffic')
    shutil.copytree(run.HERE / 'configs', tmp_path / run.HERE.name
                    / 'configs')
    mix = {'kind': 'serve', 'clients': 1, 'batch': 8, 'height': 1080,
           'width': 1920, 'pool': 4, 'calibration_frames': 8}
    (tmp_path / run.HERE.name / 'traffic' / 'serve_b8_1080p.json') \
        .write_text(json.dumps(mix))
    extra = dict(bench)
    extra['workloads'] = bench['workloads'] + [
        {'name': 'serve.el0.b8_1080p', 'config': 'el0',
         'traffic': 'serve_b8_1080p', 'chips': 1, 'why': 'a test'}]
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(extra))
    _, cell, config, traffic = run.load_cell('serve.el0.b8_1080p',
                                             root=tmp_path)
    assert traffic == mix and config['name'] == 'el0'


def test_the_idle_share_leaves_the_collectives_out():
    """An all-reduce kernel that spins while the other ranks catch up is not
    the step's own work."""
    read = common.load_metric('train_idle_share')
    trace = dict(kind='train', units=1, unit_wall_s=0.01,
                 events=[('conv_fprop', 0.0, 4000.0),
                         ('ncclDevKernel_AllReduce_Sum_f32', 4000.0,
                          9000.0)])
    assert read(trace) == pytest.approx(60.0)
    comm = common.load_metric('dp_comm_ms_per_step')
    assert comm(trace) == pytest.approx(5.0)
    assert comm(dict(trace, events=trace['events'][:1])) is None


def test_readers_of_another_kind_find_nothing(bench):
    empty = dict(kind='none', events=[])
    for m in bench['per_layer']:
        assert common.load_metric(m['name'])(empty) is None
    assert common.load_metric('dp_comm_ms_per_step')(empty) is None


def test_the_verdict_holds_every_number_to_its_limit():
    ok, checks = run.verdict({'a': 1.0, 'b': 0.0}, {'a': 1.0, 'b': 0})
    assert ok and list(checks) == ['a', 'b']
    assert checks['a'] == {'value': 1.0, 'limit': 1.0}
    assert not run.verdict({'a': float('nan')}, {'a': 1.0})[0]
    assert not run.verdict({'a': float('inf')}, {'a': 1.0})[0]
