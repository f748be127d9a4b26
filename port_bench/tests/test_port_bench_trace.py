"""The reduction of a device trace: kernel names, busy time as the union
of intervals, idle gaps by host activity, and the trace-capture check."""

import pytest

from port_bench.harness.runner import kernel_counts
from port_bench.harness.trace import Trace, Traces, short_name
from port_bench.models.training import TRACE_PIECES, TRACED_LAUNCHES, \
    trace_plan


def test_short_names():
    assert short_name('void (anonymous namespace)::dbm_gemm_act_kernel'
                      '<true, 2>(GemmArgs)') == 'dbm_gemm_act_kernel'
    assert short_name('void bm::assoc_kernel<float, (int)4>(Args const*)') \
        == 'assoc_kernel'
    assert short_name('std::enable_if<!(false), void>::type '
                      'internal::gemvx::kernel<int, float>(Params<int>)') \
        == 'gemvx::kernel'
    assert short_name('Memcpy HtoD (Pageable -> Device)') == 'Memcpy HtoD'
    assert short_name('') == '(unnamed)'


def test_busy_is_the_union_and_gaps_go_to_the_host_event():
    device = [('a', 0.0, 1.0), ('b', 0.5, 1.0), ('a', 3.0, 1.0)]
    host = [('aten::mm', 1.6, 2.9), ('cudaLaunchKernel', 2.0, 2.2)]
    tr = Trace(device, host, 5.0)
    assert tr.intervals() == [[0.0, 1.5], [3.0, 4.0]]
    assert tr.busy_s() == 2.5
    assert tr.time_by_name() == {'a': 2.0, 'b': 1.0}
    assert tr.kernel_seconds(['b']) == 1.0
    gaps = dict(tr.idle_gaps())
    # the gap 1.5-3.0 has its middle (2.25) in aten::mm only
    assert gaps['aten::mm'] == 1.5
    assert gaps['window edges'] == 1.0


def test_capture_check_counts_each_counter_against_its_kernels():
    tr = Trace([('assoc_kernel', 0., 1.), ('cd_metrics_fe_kernel', 1., 1.),
                ('cd_metrics_kernel', 2., 1.)], [], 3.)
    rows = kernel_counts(tr, {'cd_assoc_update': 2, 'cd_metrics': 2,
                              'cd_bias_stats': 0},
                         {'cd_assoc_update': 'assoc_kernel',
                          'cd_metrics': ('cd_metrics_fe_kernel',
                                         'cd_metrics_kernel')})
    assert rows == [('cd_assoc_update', 2, 1), ('cd_metrics', 2, 2)]


def test_slices_are_read_as_one_trace():
    a = Trace([('k', 0., 1.)], [], 2.)
    b = Trace([('k', 0., 0.5), ('m', 1., 0.5)], [], 4.)
    tr = Traces([a, b])
    assert tr.window_s == 6. and tr.busy_s() == 2.
    assert tr.time_by_name() == {'k': 1.5, 'm': 0.5}
    assert tr.count_by_name() == {'k': 2, 'm': 1}
    assert tr.kernel_seconds(['k']) == 1.5
    assert dict(tr.idle_gaps())['window edges'] == 1. + 2.5


@pytest.mark.parametrize('epochs, period, per_epoch', [
    (104, 2, 66670), (48, 4, 27500), (716, 4, 1075), (2, 2, 10 ** 7),
    (12, 4, 10)])
def test_trace_plan_samples_the_whole_window(epochs, period, per_epoch):
    plan = trace_plan(epochs, period, per_epoch)
    assert sum(u + m + t for u, m, t in plan) == epochs
    assert 1 <= len(plan) <= TRACE_PIECES
    assert all(t >= period and t % period == 0 and u % period == 0
               for u, _, t in plan)
    traced = sum(t for _, _, t in plan)
    assert traced * per_epoch <= max(TRACED_LAUNCHES * 1.25,
                                     len(plan) * period * per_epoch)
    if epochs >= 2 * period:
        # beside each slice, as many epochs timed without the profiler
        assert all(m == t for _, m, t in plan)
    if per_epoch * epochs <= TRACED_LAUNCHES:
        # half of each piece, to the period below
        assert traced >= epochs // 2 - len(plan) * period
