"""The multinomial RBM cell (``mrbm-cifar.cd2-b100``) resolves from its
files, which agree on the chain's k; its ``grbm_features`` rows have the
stated shape and mean; and its step's work is the hand count: the 1 + 2k
products and the association (``cd_step_work``) and the softmax rows the
port counted (``work/cd_softmax.py``), whose share of its roofline cannot
pass 100%."""

import pytest
import torch

from port_bench.harness.data import make_rows
from port_bench.harness.runner import Context
from port_bench.harness.spec import Cell
from port_bench.harness.trace import Trace
from port_bench.models import multinomial_rbm as family
from port_bench.work.cd_softmax import cd_softmax_work

NAME = 'mrbm-cifar.cd2-b100'
V, H, N, B, K = 7800, 512, 512, 100, 2


def test_cell_resolves_and_agrees_on_k():
    cell = Cell(NAME)
    c = cell.config
    assert c['family'] == 'multinomial_rbm'
    assert (c['n_visible'], c['n_hidden'], c['n_samples']) == (V, H, N)
    assert cell.traffic == {'kind': 'fit', 'batch_size': B,
                            'n_gibbs_steps': K}
    assert c['n_gibbs_steps'] == cell.traffic['n_gibbs_steps']
    assert set(c['reduced']) >= {'n_gibbs_steps', 'learning_rate'}
    assert all(key in c['published'] for key in c['reduced'])
    assert {m['name'] for m in cell.per_layer} == {
        'device_idle_pct.train', 'mfu.train', 'gemm_act_roofline.train',
        'assoc_roofline.train', 'launches_per_step.train',
        'cd_softmax_roofline.train'}
    assert [m['name'] for m in cell.end_to_end] == ['train_samples_per_s',
                                                    'setup_s']


def test_a_traffic_of_another_k_is_refused(tmp_path):
    cell = Cell(NAME)
    traffic = dict(cell.traffic, n_gibbs_steps=1)
    with pytest.raises(ValueError, match='k = 1'):
        family.Session.build(
            type('S', (), {'config': cell.config, 'traffic': traffic})(), 0)


def test_grbm_features_shape_and_mean():
    """At the published width on 1 200 rows (the mean is a property of
    the layer, not of the rows' count): within 0.02 of the mean that the
    configuration records from the cell's 50 000."""
    spec = Cell(NAME).config['data']
    X = make_rows(1200, dict(spec, n_train=1000, n_val=200), 3, 'cpu')
    assert X.shape == (1200, V) and X.dtype == torch.float32
    assert float(X.min()) > 0. and float(X.max()) < 1.
    assert abs(float(X[:1000].mean()) - spec['mean_feature']) < 0.02
    assert len(torch.unique(X[:50], dim=0)) == 50


def test_cd_softmax_by_hand():
    # a CD-2 step's three softmax rows of B, each drawing n counts
    w = cd_softmax_work(H, 3 * B, 3 * B * N, N)
    assert w.products == 0
    assert w.flops == 5 * 3 * B * H
    # pre-activations in, means and counts out
    assert w.bytes == 4 * H * 3 * 3 * B
    # a whole-set pass's row of means alone writes no counts
    assert cd_softmax_work(H, 10, 0, N).bytes == 4 * H * 2 * 10


def test_step_work_by_hand():
    session = object.__new__(family.Session)
    session.config = Cell(NAME).config
    w = session.work_of_step(B, {})
    assert set(w) == {'gemm_act', 'assoc'}
    assert w['gemm_act'].products == (1 + 2 * K) * 2 * B * V * H
    # the hidden products write their pre-activations alone, the visible
    # ones means and states
    h = B * V + V * H + B * H + H
    v = B * H + H * V + 2 * B * V + V
    assert w['gemm_act'].bytes == 4 * ((1 + K) * h + K * v)
    assert w['assoc'].products == 2 * 2 * B * V * H
    # a record of a call adds the softmax rows the port counted
    session.X, session.B = torch.zeros((490 * B, 1)), B
    record = {'epochs': 2, 'softmax_rows': {'rows': 301000,
                                            'draws': 301000 * N}}
    got = session.step_work(record)
    assert got['gemm_act'].products == 2 * 490 * w['gemm_act'].products
    assert got['cd_softmax'].bytes == cd_softmax_work(
        H, 301000, 301000 * N, N).bytes
    assert 'cd_softmax' not in session.step_work(
        {'epochs': 1, 'softmax_rows': {'rows': 0, 'draws': 0}})


def test_cd_softmax_share_stops_at_100():
    """Rows done at the bandwidth's pace in the least time read 100%;
    nothing to read is None."""
    reader = Cell(NAME).reader('cd_softmax_roofline.train')
    assert reader.KERNELS == ('cd_softmax_sample_kernel',)
    w = cd_softmax_work(H, 3 * B, 3 * B * N, N)
    t = w.least_seconds()
    ctx = Context({'steps': 1}, Trace([('cd_softmax_sample_kernel', 0., t)],
                                      [], 2 * t), {}, {'cd_softmax': w})
    assert reader.read(ctx) == pytest.approx(100.)
    ctx = Context({'steps': 1}, Trace([], [], 1.), {}, {'cd_softmax': w})
    assert reader.read(ctx) is None
    ctx = Context({'steps': 1}, Trace([('cd_softmax_sample_kernel', 0., t)],
                                      [], 2 * t), {}, {})
    assert reader.read(ctx) is None
