"""The G-B-M DBM cell (``gbm-dbm-cifar.pcd-b100``) resolves from its files,
and its step's work is the hand count: ``dbm_step_work``'s products and
associations and the multinomial layer's rows (``work/softmax.py``), whose
share of its roofline cannot pass 100%."""

import pytest

from port_bench import work
from port_bench.harness.runner import Context
from port_bench.harness.spec import Cell
from port_bench.harness.trace import Trace
from port_bench.work.softmax import dbm_softmax_work

NAME = 'gbm-dbm-cifar.pcd-b100'


def test_cell_resolves():
    cell = Cell(NAME)
    assert cell.config['family'] == 'gbm_dbm'
    assert (cell.config['n_visible'], cell.config['n_hiddens'],
            cell.config['n_samples']) == (3072, [5000, 1000], 1000)
    assert cell.traffic == {'kind': 'fit', 'batch_size': 100}
    assert {m['name'] for m in cell.per_layer} == {
        'device_idle_pct.train', 'mfu.train', 'gemm_act_roofline.train',
        'assoc_roofline.train', 'launches_per_step.train',
        'mf_sweep_use_pct.train', 'softmax_roofline.train'}


def test_dbm_softmax_by_hand():
    H, B, M, n = 7, 3, 5, 4
    w = dbm_softmax_work(H, B, M, n, k=2)
    # the init's and n sweeps' B rows, two Gibbs sweeps' M rows
    assert w.products == 0
    assert w.flops == 5 * H * (B * (1 + n) + 2 * M)
    # init: pre in, means out; a sweep: pre and old means in, means out;
    # Gibbs: pre in, counts out
    assert w.bytes == 4 * H * (2 * B + 3 * n * B + 2 * 2 * M)


def test_gbm_dbm_step_work_groups():
    """At the slice's sweeps as the port counted them, else as fit logged
    them, else the budget."""
    from port_bench.models import gbm_dbm
    session = object.__new__(gbm_dbm.Session)
    session.config = c = Cell(NAME).config
    V, (H1, H2), M = c['n_visible'], c['n_hiddens'], c['n_particles']
    for window, n_mf in (({'n_mf_run': 16.5, 'n_mf': 3.}, 16.5),
                         ({'n_mf': 3.}, 3.), ({}, c['max_mf_updates'])):
        w = session.work_of_step(100, window)
        assert set(w) == {'gemm_act', 'assoc', 'softmax'}
        want = work.dbm_step_work(V, H1, H2, 100, M, n_mf, 1)
        assert w['gemm_act'].products == want['gemm_act'].products
        assert w['assoc'].bytes == want['assoc'].bytes
        assert w['softmax'].bytes == \
            dbm_softmax_work(H2, 100, M, n_mf, 1).bytes


def test_softmax_share_stops_at_100():
    """The rows done at the bandwidth's pace in the least time read 100%;
    nothing to read is None."""
    reader = Cell(NAME).reader('softmax_roofline.train')
    assert reader.KERNELS == ('dbm_softmax_kernel',)
    w = dbm_softmax_work(1000, 100, 100, 16, 1)
    t = w.least_seconds()
    ctx = Context({'steps': 1}, Trace([('dbm_softmax_kernel', 0., t)], [],
                                      2 * t), {}, {'softmax': w})
    assert reader.read(ctx) == pytest.approx(100.)
    ctx = Context({'steps': 1}, Trace([], [], 1.), {}, {'softmax': w})
    assert reader.read(ctx) is None
