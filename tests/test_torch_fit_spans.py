"""The spans of the port's fit loops (``utils/profiler.py``'s recorder),
the DBM's mean-field sweep counts (``ops/dbm_ops.dbm_epoch.sweeps`` and
``profiled_sweeps``), and the idle split of ``tools/torch_fit_spans.py``
that reads the spans beside a device trace, on the CPU."""

import json
import os

import numpy as np
import pytest

from boltzmann_machines_tpu_torch import BernoulliRBM, DBM
from boltzmann_machines_tpu_torch.ops.dbm_ops import dbm_epoch
from boltzmann_machines_tpu_torch.utils import RNG, profiler

V, H1, H2 = 6, 5, 4
EPOCHS = 4


@pytest.fixture(scope='module')
def data():
    X = (RNG(1337).rand(60, V) < 0.4).astype('float32')
    return X[:44], X[44:]


def make_rbm(tmp, **kw):
    cfg = dict(n_visible=V, n_hidden=H1, max_epoch=EPOCHS, batch_size=8,
               random_seed=1, verbose=False, save_after_each_epoch=False,
               device='cpu',
               metrics_config=dict(msre=True, pll=True, feg=True,
                                   train_metrics_every_iter=2,
                                   val_metrics_every_epoch=2,
                                   feg_every_epoch=4, n_batches_for_feg=2),
               model_path=os.path.join(tmp, 'rbm') + '/')
    cfg.update(kw)
    return BernoulliRBM(**cfg)


def make_dbm(X, tmp, **kw):
    r1 = BernoulliRBM(n_visible=V, n_hidden=H1, dbm_first=True, max_epoch=1,
                      batch_size=8, random_seed=1, verbose=False,
                      device='cpu', model_path=os.path.join(tmp, 'r1') + '/')
    r2 = BernoulliRBM(n_visible=H1, n_hidden=H2, dbm_last=True, max_epoch=1,
                      batch_size=8, random_seed=2, verbose=False,
                      device='cpu', model_path=os.path.join(tmp, 'r2') + '/')
    r1.fit(X)
    r2.fit(r1.transform(X))
    cfg = dict(n_particles=8, n_gibbs_steps=1, max_mf_updates=20,
               mf_tol=1e-7, learning_rate=0.01, momentum=0.5,
               max_epoch=EPOCHS, batch_size=8, val_metrics_every_epoch=2,
               random_seed=3, verbose=False, save_after_each_epoch=False)
    cfg.update(kw)
    return DBM(rbms=[r1, r2], device='cpu',
               model_path=os.path.join(tmp, 'dbm') + '/', **cfg)


def tree(spans):
    """(name, parent's name) of every span, in order."""
    return [(s.name, None if s.parent is None else spans[s.parent].name)
            for s in spans]


def epoch_children(spans):
    """The names of each ``fit/epoch`` span's children, epoch by epoch."""
    epochs = [i for i, s in enumerate(spans) if s.name == 'fit/epoch']
    return [[s.name for s in spans if s.parent == i] for i in epochs]


@pytest.mark.parametrize('family', ['rbm', 'dbm'])
def test_fit_span_tree(family, data, tmp_path):
    """One ``fit`` span a call: ``fit/stage``, one ``fit/epoch`` an epoch
    (train, readback, then validation on even epochs, the FEG on the
    fourth (RBM), summaries), ``fit/save``; each span inside its parent
    and in the fit call's id."""
    X, X_val = data
    model = make_rbm(str(tmp_path)) if family == 'rbm' else \
        make_dbm(X, str(tmp_path))
    with profiler.recording() as spans:
        model.fit(X, X_val)
    assert spans[0].name == 'fit' and spans[0].parent is None
    assert all(s.call == 0 for s in spans)
    children = [s.name for s in spans if s.parent == 0]
    assert children == ['fit/stage'] + ['fit/epoch'] * EPOCHS + ['fit/save']
    val = ['fit/epoch/val']
    feg = ['fit/epoch/feg'] if family == 'rbm' else []
    head, tail = ['fit/epoch/train', 'fit/epoch/readback'], \
        ['fit/epoch/summaries']
    assert epoch_children(spans) == [head + tail, head + val + tail,
                                     head + tail, head + val + feg + tail]
    assert len(tree(spans)) == 2 + EPOCHS * 4 + 2 + len(feg) + 1
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # siblings follow one another
    for i, j in zip(spans, spans[1:]):
        if i.parent == j.parent:
            assert i.end_ns <= j.start_ns


def test_checkpoint_spans_and_one_call_id_a_fit(data, tmp_path):
    """Checkpoints inside the loop are ``fit/epoch/checkpoint``; a second
    ``fit`` in the same recording is a call of its own."""
    X, X_val = data
    rbm = make_rbm(str(tmp_path), save_after_each_epoch=True, max_epoch=2)
    with profiler.recording() as spans:
        rbm.fit(X)
        rbm.max_epoch = 3
        rbm.fit(X)
    fits = [i for i, s in enumerate(spans) if s.name == 'fit']
    assert len(fits) == 2
    assert [s.call for s in spans] == \
        [fits[0]] * fits[1] + [fits[1]] * (len(spans) - fits[1])
    assert sum(s.name == 'fit/epoch/checkpoint' for s in spans) == 3
    assert not any(s.name == 'fit/epoch/val' for s in spans)


def test_no_span_with_the_recorder_off(data, tmp_path, monkeypatch):
    """With no recording and no profiler open a fit opens no span: the
    recorder is never reached, and a recording closed before keeps what
    it had."""
    X, X_val = data
    with profiler.recording() as spans:
        make_rbm(str(tmp_path / 'a')).fit(X, X_val)
    n = len(spans)

    def refuse(self, name):
        raise AssertionError('a span opened with the recorder off')

    monkeypatch.setattr(profiler.Recorder, 'span', refuse)
    make_rbm(str(tmp_path / 'b')).fit(X, X_val)
    make_dbm(X, str(tmp_path / 'c')).fit(X, X_val)
    assert len(spans) == n and profiler._recorder is None


def test_log_Z_spans(data, tmp_path):
    X, _ = data
    dbm = make_dbm(X, str(tmp_path), max_epoch=1)
    dbm.fit(X)
    with profiler.recording() as spans:
        dbm.log_Z(n_betas=10, n_runs=4, n_gibbs_steps=1)
        dbm.log_Z(n_betas=10, n_runs=4, n_gibbs_steps=1, bdmc=True,
                  bdmc_burn_in=2)
    assert tree(spans) == [('log_Z', None), ('log_Z/ais', 'log_Z'),
                           ('log_Z', None), ('log_Z/ais', 'log_Z'),
                           ('log_Z/bdmc', 'log_Z')]
    assert [s.call for s in spans] == [0, 0, 2, 2, 2]


def test_dbm_sweep_counts_every_step(data, tmp_path):
    """``mf_sweeps`` adds every training step's mean-field sweeps: with the
    train metrics logged at every step, the epochs' logged means times
    their steps; on the plain path every sweep enqueued runs, so
    ``mf_sweeps_enqueued`` equals it.  The launch counts stay apart."""
    X, _ = data
    dbm = make_dbm(X, str(tmp_path), train_metrics_every_iter=1)
    launches = dict(dbm_epoch.launches)
    before = dict(dbm_epoch.sweeps)
    dbm.fit(X)
    got = {k: dbm_epoch.sweeps[k] - before[k] for k in before}
    path = os.path.join(str(tmp_path), 'dbm', 'logs', 'train',
                        'scalars.jsonl')
    with open(path) as f:
        logged = [r['value'] for r in map(json.loads, f)
                  if r['tag'] == 'n_mf_updates']
    steps = -(-len(X) // 8)
    assert len(logged) == EPOCHS
    assert got['mf_sweeps'] == int(np.rint(sum(logged) * steps))
    assert got['mf_sweeps'] >= EPOCHS * steps
    assert got['mf_sweeps_enqueued'] == got['mf_sweeps']
    assert dict(dbm_epoch.launches) == launches
    assert set(dbm_epoch.sweeps) == {'mf_sweeps_enqueued', 'mf_sweeps'}
    assert not set(dbm_epoch.sweeps) & set(dbm_epoch.launches)


def test_dbm_profiled_sweeps_count_the_profiled_epochs(data, tmp_path):
    """``dbm_epoch.profiled_sweeps`` counts the steps and sweeps of the
    epochs run while a profiler session is active, and only those."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    X, _ = data
    dbm = make_dbm(X, str(tmp_path), max_epoch=2)
    before = dict(dbm_epoch.profiled_sweeps)
    whole = dict(dbm_epoch.sweeps)
    dbm.fit(X)
    assert dbm_epoch.profiled_sweeps == before
    dbm.max_epoch = 5
    with profile(activities=[ProfilerActivity.CPU]):
        dbm.fit(X)
    assert not torch.autograd._profiler_enabled()
    got = {k: dbm_epoch.profiled_sweeps[k] - before[k] for k in before}
    ran = dbm_epoch.sweeps['mf_sweeps'] - whole['mf_sweeps']
    assert got['steps'] == 3 * -(-len(X) // 8)
    assert got['steps'] <= got['mf_sweeps'] < ran
    assert got['mf_sweeps_enqueued'] == got['mf_sweeps']
    assert set(dbm_epoch.profiled_sweeps) == \
        {'steps', 'mf_sweeps_enqueued', 'mf_sweeps'}


# ---- the idle split of tools/torch_fit_spans.py, on synthetic traces ----

def load_tool():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'tools', 'torch_fit_spans.py')
    spec = importlib.util.spec_from_file_location('torch_fit_spans', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def tool():
    return load_tool()


def traced(device, host, window_s, start_s, spans):
    from port_bench.harness.trace import Trace
    tr = Trace(device, host, window_s)
    tr.start_s, tr.spans = start_s, spans
    return tr


def total(split):
    return sum(v[0] for v in split.values())


def test_innermost_nests_and_follows(tool):
    assert tool.innermost([(0., 10.), (1., 4.), (2., 3.), (6., 8.)]) == [
        (0., 1., 0), (1., 2., 1), (2., 3., 2), (3., 4., 1), (4., 6., 0),
        (6., 8., 3), (8., 10., 0)]
    assert tool.innermost([(0., 1.), (2., 3.)]) == [(0., 1., 0), (2., 3., 1)]
    assert tool.innermost([]) == []


def test_gaps_split_by_overlap_with_edges_and_calls(tool):
    # window 1.0-11.0; device busy 2-3 and 6-7; spans: fit 1.5-10.5 with
    # fit/epoch 2.5-9 and fit/epoch/train 2.5-5.0, fit/epoch/val 5.0-8.0
    device = [('k', 2., 1.), ('k', 6., 1.)]
    host = [('cudaLaunchKernel', 3.5, 4.0), ('cudaMemcpyAsync', 8.5, 9.5)]
    spans = [('fit', 1.5, 10.5, None, 0), ('fit/epoch', 2.5, 9., 0, 0),
             ('fit/epoch/train', 2.5, 5., 1, 0),
             ('fit/epoch/val', 5., 8., 1, 0)]
    tr = traced(device, host, 10., 1., spans)
    split = tool.idle_by_span(tr)
    # the gap 3-6 crosses train (3-5) and val (5-6)
    assert split['fit/epoch/train'][0] == pytest.approx(2.)
    assert split['fit/epoch/val'][0] == pytest.approx(1. + 1.)
    # the edges: 1-1.5 in no span, 1.5-2 in fit; 10.5-11 in no span
    assert split[tool.OUTSIDE][0] == pytest.approx(0.5 + 0.5)
    assert split['fit'][0] == pytest.approx(0.5 + 1.5)
    assert split['fit/epoch'][0] == pytest.approx(1.)
    assert total(split) == pytest.approx(tr.window_s - tr.busy_s())
    # the host inside a CUDA call meanwhile
    assert split['fit/epoch/train'][1:] == [
        pytest.approx(0.5), {'cudaLaunchKernel': pytest.approx(0.5)}]
    assert split['fit/epoch'][2] == {'cudaMemcpyAsync': pytest.approx(0.5)}
    assert split['fit'][2] == {'cudaMemcpyAsync': pytest.approx(0.5)}
    shares = tool.idle_split([tr])
    assert shares['launch_path'] == pytest.approx(20.)
    assert shares['fit_loop'] == pytest.approx(50.)
    assert shares['outside'] == pytest.approx(10.)
    assert shares['launch_path'] + shares['fit_loop'] + shares['outside'] \
        == pytest.approx(100. * (1. - tr.busy_s() / tr.window_s))


def test_every_gap_is_attributed(tool):
    """More gaps than the longest N_GAPS that ``idle_gaps`` names: all of
    them go to a span, and the sum is the window's idle time."""
    from port_bench.harness.trace import N_GAPS
    n = 3 * N_GAPS
    device = [('k', 1. + 2e-3 * i, 1e-3) for i in range(n)]
    host = [('cudaLaunchKernel', 1. + 2e-3 * i - 5e-4, 1. + 2e-3 * i)
            for i in range(n)]
    end = 1. + 2e-3 * n
    spans = [('fit', 0.5, end + 0.5, None, 0),
             ('fit/epoch', 0.6, end, 0, 0),
             ('fit/epoch/train', 0.6, end - 1e-3, 1, 0)]
    tr = traced(device, host, end + 1., 0., spans)
    split = tool.idle_by_span(tr)
    assert total(split) == pytest.approx(tr.window_s - tr.busy_s(),
                                         abs=1e-9)
    assert split['fit/epoch/train'][0] == pytest.approx(
        (0.4 + (n - 1) * 1e-3), abs=1e-9)
    # each launch fills half a gap (the first, half a millisecond of the
    # leading edge)
    assert split['fit/epoch/train'][2]['cudaLaunchKernel'] == pytest.approx(
        5e-4 * n, abs=1e-9)
    assert sum(length for _, length in tr.idle_gaps()) < \
        tr.window_s - tr.busy_s() - 1e-3


def test_slices_add_up(tool):
    a = traced([('k', 1., 1.)], [], 4., 0.5, [('fit', 0.5, 4.5, None, 0)])
    b = traced([], [], 2., 0., [('fit', 0., 1., None, 0),
                                ('fit/epoch/train', 0.5, 1., 0, 0)])
    shares = tool.idle_split([a, b])
    assert shares['by_span']['fit'][0] == pytest.approx(3. + 0.5)
    assert shares['launch_path'] == pytest.approx(100. * 0.5 / 6.)
    assert shares['outside'] == pytest.approx(100. * 1. / 6.)


def test_launches_outside_fit_is_the_clock_check(tool):
    host = [('cudaLaunchKernel', 1., 1.1), ('cudaLaunchKernelExC', 2., 2.1),
            ('cudaLaunchKernel', 5., 5.1), ('cudaMemcpyAsync', 6., 6.1)]
    tr = traced([], host, 7., 0., [('fit', 0.5, 3., None, 0),
                                   ('log_Z', 4., 6.5, None, 3)])
    assert tool.launches_outside_fit(tr) == 1


def test_epoch_loop_counts_per_slice(tool):
    """``slice_counts`` reads the CD epoch's C loop counts, and
    ``epoch_loop`` gives each slice's calls and steps, None where no slice
    ran the loop (the DBM, or a port without the loop)."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import cd_epoch
    before = dict(cd_epoch.loop)
    try:
        cd_epoch.loop.update(calls=2, steps=430)
        counts = tool.slice_counts()
    finally:
        cd_epoch.loop.update(before)
    assert (counts['loop_calls'], counts['loop_steps']) == (2, 430)
    grown = [{'loop_calls': 1, 'loop_steps': 5500, 'val': 1},
             {'loop_calls': 2, 'loop_steps': 215}]
    assert tool.epoch_loop(grown) == [{'calls': 1, 'steps': 5500},
                                      {'calls': 2, 'steps': 215}]
    assert tool.epoch_loop([{'loop_calls': 0, 'loop_steps': 0}]) is None
    assert tool.epoch_loop([{'mf_sweeps': 3}]) is None


def test_slice_counts_read_the_dbm_graph_counters(tool):
    """``slice_counts`` reads the DBM epoch's graph launches, the turns of
    its WHILE node (a check a turn) and the multinomial layer's softmax
    rows (``dbm_epoch.launches['dbm_softmax']``)."""
    from boltzmann_machines_tpu_torch.ops import dbm_ops
    launches = dict(dbm_ops.dbm_epoch.launches)
    graphs = dbm_ops.dbm_epoch.graph_launches
    try:
        dbm_ops.dbm_epoch.launches.update(dbm_mf_check=9, dbm_softmax=47)
        dbm_ops.dbm_epoch.graph_launches = 5
        counts = tool.slice_counts()
    finally:
        dbm_ops.dbm_epoch.launches.update(launches)
        dbm_ops.dbm_epoch.graph_launches = graphs
    assert (counts['graph_launches'], counts['mf_turns'],
            counts['softmax_rows']) == (5, 9, 47)


def test_capture_spans_puts_the_spans_on_the_trace_base(tool):
    """On the CPU the profiler's host events and the spans share the
    trace's base: an op run inside a span lies inside it."""
    import torch

    from boltzmann_machines_tpu_torch.utils.profiler import annotate

    def fn():
        with annotate('fit'):
            x = torch.ones((128, 128))
            for _ in range(3):
                x = x @ x / 128.
        return 1

    result, tr = tool.capture_spans(fn, 'cpu')
    assert result == 1
    ((name, s, e, parent, call),) = tr.spans
    assert (name, parent, call) == ('fit', None, 0)
    assert tr.start_s <= s <= e <= tr.start_s + tr.window_s
    mm = [h for h in tr.host if h[0] == 'aten::mm']
    assert len(mm) == 3 and all(s <= a and b <= e for _, a, b in mm)
