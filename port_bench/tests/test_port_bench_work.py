"""The work functions against hand counts, and the shares of a peak that
can not pass 100% for work done in TF32 or above."""

import pytest

from port_bench import work
from port_bench.harness.runner import Context
from port_bench.harness.spec import Cell
from port_bench.harness.trace import Trace


def test_product_by_hand():
    w = work.product(2, 3, 5, outputs=2)
    assert w.products == 2 * 2 * 3 * 5
    assert w.bytes == 4 * (2 * 3 + 3 * 5 + 2 * 2 * 5 + 5)


def test_cd_step_by_hand():
    V, H, B = 6, 4, 3
    w = work.cd_step_work(V, H, B, k=1, sample_h=True, sample_v=False)
    # h0 (states too), v, h1 (states too): three products of 2 B V H
    assert w['gemm_act'].products == 3 * 2 * B * V * H
    assert w['gemm_act'].bytes == 4 * (
        (B * V + V * H + 2 * B * H + H) + (B * H + H * V + B * V + V) +
        (B * V + V * H + 2 * B * H + H))
    assert w['assoc'].products == 2 * 2 * B * V * H
    assert w['assoc'].flops == 8 * V * H
    assert w['assoc'].bytes == 4 * (2 * B * (V + H) + 4 * V * H)


def test_dbm_step_by_hand():
    V, H1, H2, B, M, n = 5, 4, 3, 2, 6, 7
    a, b = V * H1, H1 * H2
    w = work.dbm_step_work(V, H1, H2, B, M, n, k=1)
    # X.W0, the init of mu1, n sweeps of two, four Gibbs products, recon
    assert w['gemm_act'].products == (2 * B * a + 2 * B * b + n * 4 * B * b +
                                      4 * M * (a + b) + 2 * B * a)
    assert w['assoc'].products == 2 * (B + M) * (a + b)
    # the same total as chip_smoke.py's dbm_step_work
    total = w['gemm_act'].products + w['assoc'].products
    assert total == (2. * B * a + 2. * B * b + n * 4. * B * b +
                     4. * M * (a + b) + 2. * (B + M) * (a + b) +
                     2. * B * a)


def test_ais_beta_by_hand():
    w = work.ais_beta_work(5, 4, 3, 2, 5)['gemm_act']
    assert w.products == (4 * 5 + 2) * 2 * (5 * 4 + 4 * 3)


def test_least_seconds_is_the_slower_bound():
    w = work.Work(495e12, 0., 3.35e12 * 2)
    assert w.least_seconds() == pytest.approx(2.)
    w = work.Work(495e12 * 3, 67e12, 1.)
    assert w.least_seconds() == pytest.approx(4.)


def _ctx(kernel_seconds, window_s, w):
    trace = Trace([('cd_gemm_act_kernel', 0., kernel_seconds),
                   ('assoc_kernel', kernel_seconds, kernel_seconds)],
                  [], window_s)
    return Context({'steps': 1}, trace, {}, {'gemm_act': w, 'assoc': w})


@pytest.mark.parametrize('metric', ['mfu.train', 'gemm_act_roofline.train',
                                    'assoc_roofline.train'])
@pytest.mark.parametrize('w', [work.Work(1e12, 0., 1e6),
                               work.Work(1e6, 1e3, 1e12),
                               work.Work(1e12, 1e11, 1e12)])
def test_shares_of_a_peak_stop_at_100(metric, w):
    """A kernel that did its work at TF32's peak (or moved its bytes at the
    bandwidth's) in the least time reads 100%; no faster time is
    possible, so no honest reading passes 100%."""
    reader = Cell('rbm-mnist.cd1-b10').reader(metric)
    t = w.least_seconds()
    value = reader.read(_ctx(t, 2 * t, w))
    assert value <= 100. * (1 + 1e-12)
    if metric != 'mfu.train':
        assert value == pytest.approx(100.)
