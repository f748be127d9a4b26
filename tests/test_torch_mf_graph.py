"""The host side of the DBM's mean-field graph (ops/dbm_ops.py,
``bm_dbm_mf_graph_*`` of csrc/dbm_ops.cu), on the CPU: the turns a step's
n_mf implies, and the epoch's plan of launches and its count of the
graph's kernels through a stand-in for the kernel library.  The graph
itself runs only on the card (tests/test_torch_cuda.py).
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from boltzmann_machines_tpu_torch.ops import dbm_ops, gemm
from boltzmann_machines_tpu_torch.ops.dbm_ops import count_mf_graph, dbm_epoch


@pytest.mark.parametrize('rows,body,want', [
    ([1., 2., 3.], 4, 3),     # steps stopped in their first turn
    ([50., 50.], 4, 26),      # steps at the budget of 50: 12 turns and 2
    ([4., 8., 5.], 4, 5),     # a stop at a turn's last sweep ends it
    ([3., 1.], 1, 4),         # a sweep a turn: a turn a sweep
    ([], 4, 0),               # no step
    ([0., 0.], 2, 0),         # a budget of 0 runs no turn
])
def test_count_mf_graph(rows, body, want):
    """A step's graph runs ceil(n_mf / body) turns of `body` sweeps."""
    assert count_mf_graph(np.asarray(rows, np.float32), body) == want


def test_count_mf_graph_default_body():
    """Without `body`, the graph's sweeps a turn as the epoch builds it."""
    rows = [1., 5., 9., 50.]
    assert count_mf_graph(rows) == count_mf_graph(rows,
                                                  dbm_ops.MF_BODY_SWEEPS)


class FakeLibrary(object):
    """Each C entry of the kernel library: records its call, returns 0;
    the graph's create hands out a handle, and each launch of the graph
    adds the next of `turns` to the graph's turn word, as the card's
    check kernel counts them."""

    def __init__(self, turns):
        self.calls = []
        self.turns = list(turns)

    def __getattr__(self, name):
        if not name.startswith('bm_'):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            if name == 'bm_dbm_mf_graph_create':
                self.word = args[2] + 4 * (dbm_ops.MF_CHANGE_WORD + args[5])
                args[-1]._obj.value = 4242
            if name == 'bm_dbm_mf_graph_launch':
                ctypes.c_int32.from_address(self.word).value += \
                    self.turns.pop(0)
            return 0
        return entry


# the turns of the graph's launches, one a step: below, at and above one
# turn of the budget's
TURNS = {'first_turn': [1] * 5, 'mixed': [1, 3, 1, 2, 1],
         'whole_budget': [5] * 5, 'budget_0': [0] * 5}


@pytest.mark.parametrize('case', sorted(TURNS))
def test_dbm_epoch_launches_one_graph_a_step(monkeypatch, case):
    """On the kernels' path a step launches the mean-field graph once,
    made once for the call over the sweep's L layer launches (each folding
    its change) with the budget and MF_BODY_SWEEPS sweeps a turn, and
    freed after its last launch; the host counts its own launches, the
    graph's launches, the budget offered a step, and, from the turn count
    the graph keeps (read once, after the last launch), L x body
    ``dbm_gemm_act`` launches and one ``dbm_mf_check`` a turn.  Each
    layer's association takes ``assoc_plan``'s width."""
    NB = 5
    lib = FakeLibrary(TURNS[case])
    monkeypatch.setattr(dbm_ops, '_library', lambda: lib)
    monkeypatch.setattr(dbm_ops, '_stream', lambda device: 0)
    monkeypatch.setattr(dbm_ops, 'launch_plan',
                        lambda *a: (SimpleNamespace(n_tile=8, splits=1),
                                    None, None))
    monkeypatch.setattr(dbm_ops, 'num_sms', lambda device: 132)
    sizes, B, M, k = (12, 7, 5, 4), 3, 4, 2
    budget = 0 if case == 'budget_0' else 17
    L = len(sizes) - 1
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.as_tensor(rng.rand(*shape).astype(np.float32))
    hs = sizes[1:]
    state = {'vb': t(12), 'dvb': t(12), 'v': t(M, 12),
             'hb': tuple(t(h) for h in hs), 'dhb': tuple(t(h) for h in hs),
             'q_means': tuple(t(h) for h in hs),
             'mu_means': tuple(t(h) for h in hs),
             'W': tuple(t(sizes[l], hs[l]) for l in range(L)),
             'dW': tuple(t(sizes[l], hs[l]) for l in range(L)),
             'H': tuple(t(M, h) for h in hs)}
    cfg = dbm_ops.DBMEpochConfig(sizes, k, budget, 1e-7, False,
                                 (False,) * L, 1e-4, 2., (0.2,) * L,
                                 (1e-2,) * L, 0.9)
    dbm_ops.reset_launches()
    dbm_ops._dbm_epoch_cuda(cfg, state, t(NB, B, 12), 0.1, 0.5, 3, 0)
    names = [name for name, _ in lib.calls]
    assert names.count('bm_dbm_mf_graph_create') == 1
    assert names.count('bm_dbm_mf_graph_launch') == NB
    assert names[-1] == 'bm_dbm_mf_graph_destroy'
    assert names.index('bm_dbm_mf_graph_create') < \
        names.index('bm_dbm_mf_graph_launch')
    (_, create), = [c for c in lib.calls if c[0] == 'bm_dbm_mf_graph_create']
    layers, n_layers, _, tol, max_updates, body, _ = create
    assert (n_layers, max_updates, body) == (L, budget,
                                             dbm_ops.MF_BODY_SWEEPS)
    assert np.float32(tol) == np.float32(1e-7)
    assert [layers[l].act for l in range(L)] == \
        [dbm_ops.ACT_SIGMOID_DELTA] * L
    assert all(args[0].value == 4242 for name, args in lib.calls
               if name in ('bm_dbm_mf_graph_launch',
                           'bm_dbm_mf_graph_destroy'))
    # each step's launch of the graph follows its init launches and comes
    # before its Gibbs launches: 1 + L products, the graph, the rest
    step = names[names.index('bm_dbm_mf_graph_launch') - 1 - L:]
    assert step[:L + 2] == ['bm_dbm_gemm_act'] * (L + 1) + \
        ['bm_dbm_mf_graph_launch']
    host = NB * (1 + L + k * (L + 1) + 1)
    assert host == names.count('bm_dbm_gemm_act')
    turns = sum(TURNS[case])
    assert dbm_epoch.launches['dbm_gemm_act'] == host + L * body * turns
    assert [args[-2] for name, args in lib.calls
            if name == 'bm_dbm_assoc_update'] == \
        [gemm.assoc_plan(sizes[l], hs[l], 132).n_tile for l in range(L)] * NB
    assert dbm_epoch.launches['dbm_mf_check'] == turns
    assert dbm_epoch.graph_launches == NB
    assert dbm_epoch.sweeps == {'mf_sweeps_enqueued': NB * budget,
                                'mf_sweeps': 0}
