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


def run_epoch(monkeypatch, turns, budget, units=None, NB=5):
    """``_dbm_epoch_cuda`` of a 12-7-5-4 DBM of `units` (None:
    all-Bernoulli) through the stand-in library whose graph runs `turns`
    turns a launch; returns the library."""
    lib = FakeLibrary(turns)
    monkeypatch.setattr(dbm_ops, '_library', lambda: lib)
    monkeypatch.setattr(dbm_ops, '_stream', lambda device: 0)
    monkeypatch.setattr(dbm_ops, 'launch_plan',
                        lambda *a: (SimpleNamespace(n_tile=8, splits=1),
                                    None, None))
    monkeypatch.setattr(dbm_ops, 'num_sms', lambda device: 132)
    sizes, B, M, k = SIZES, 3, 4, 2
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
                                 (1e-2,) * L, 0.9, units)
    dbm_ops.reset_launches()
    dbm_ops._dbm_epoch_cuda(cfg, state, t(NB, B, 12), 0.1, 0.5, 3, 0)
    return lib


SIZES = (12, 7, 5, 4)


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
    NB, k = 5, 2
    budget = 0 if case == 'budget_0' else 17
    lib = run_epoch(monkeypatch, TURNS[case], budget)
    sizes, hs, L = SIZES, SIZES[1:], len(SIZES) - 1
    names = [name for name, _ in lib.calls]
    assert names.count('bm_dbm_mf_graph_create') == 1
    assert names.count('bm_dbm_mf_graph_launch') == NB
    assert names[-1] == 'bm_dbm_mf_graph_destroy'
    assert names.index('bm_dbm_mf_graph_create') < \
        names.index('bm_dbm_mf_graph_launch')
    (_, create), = [c for c in lib.calls if c[0] == 'bm_dbm_mf_graph_create']
    layers, n_layers, _, tol, max_updates, body, rows, _ = create
    assert (n_layers, max_updates, body) == (L, budget,
                                             dbm_ops.MF_BODY_SWEEPS)
    assert rows is None
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
    assert dbm_epoch.launches['dbm_softmax'] == 0
    assert dbm_epoch.graph_launches == NB
    assert dbm_epoch.sweeps == {'mf_sweeps_enqueued': NB * budget,
                                'mf_sweeps': 0}


def layouts():
    """Unit layouts of the 12-7-5-4 DBM with multinomial layers: the top
    one (G-B-B-M), a middle one (G-B-M-B), and two (B-M-B-M)."""
    from boltzmann_machines_tpu_torch import (BernoulliLayer, GaussianLayer,
                                              MultinomialLayer)
    G, B = GaussianLayer(12, sigma=1.5), BernoulliLayer
    return {'G-B-B-M': (G, B(7), B(5), MultinomialLayer(4, n_samples=9)),
            'G-B-M-B': (G, B(7), MultinomialLayer(5, n_samples=9), B(4)),
            'B-M-B-M': (B(12), MultinomialLayer(7, n_samples=9), B(5),
                        MultinomialLayer(4, n_samples=3))}


@pytest.mark.parametrize('case', ['mixed', 'whole_budget'])
@pytest.mark.parametrize('layout', sorted(layouts()))
def test_dbm_epoch_graph_runs_the_softmax_rows(monkeypatch, layout, case):
    """A DBM with multinomial layers on the kernels' path: each multinomial
    layer of the graph's sweep is an identity product into its
    pre-activations and a ``dbm_softmax`` row node after it (n_samples, its
    shape); the init and each Gibbs sweep launch the same pair from the
    host, the Gibbs rows sampled on the layer's stream; a Gaussian visible
    layer's Gibbs and reconstruction launches carry its sigma.  The graph's
    turns count L x body products, a softmax a multinomial layer a sweep
    and one check a turn (``mf_graph_launches``), and no sampler is
    launched."""
    from boltzmann_machines_tpu_torch.ops import samplers
    units = layouts()[layout]
    NB, k, L = 5, 2, len(SIZES) - 1
    multi = [l for l in range(L)
             if hasattr(units[l + 1], 'n_samples')]
    samplers.reset_launches()
    lib = run_epoch(monkeypatch, TURNS[case], 17, units)
    (_, create), = [c for c in lib.calls if c[0] == 'bm_dbm_mf_graph_create']
    layers, _, _, _, _, body, rows, _ = create
    for l in range(L):
        if l in multi:
            assert layers[l].act == dbm_ops.ACT_IDENTITY
            assert (rows[l].pre, rows[l].n, rows[l].H, rows[l].rows,
                    rows[l].sample) == (layers[l].out,
                                        units[l + 1].n_samples,
                                        SIZES[l + 1], 3, 0)
        else:
            assert layers[l].act == dbm_ops.ACT_SIGMOID_DELTA
            assert rows[l].n == 0
    softmax = [args[0]._obj for name, args in lib.calls
               if name == 'bm_dbm_softmax']
    # a step: the init's and each Gibbs sweep's row of each multinomial
    # layer
    assert len(softmax) == NB * len(multi) * (1 + k)
    gibbs = [a for a in softmax if a.rows == 4]
    assert len(gibbs) == NB * len(multi) * k
    assert {(a.stream_id, a.sample) for a in gibbs} == {
        (dbm_ops.stream_dbm(s, l, L), 0) for s in range(k) for l in multi}
    gauss = [args[0]._obj for name, args in lib.calls
             if name == 'bm_dbm_gemm_act' and args[0]._obj.sigma]
    assert len(gauss) == (NB * (k + 1) if layout.startswith('G') else 0)
    turns = sum(TURNS[case])
    host = NB * (1 + L + k * (L + 1) + 1)
    want = dbm_ops.mf_graph_launches(turns, L, len(multi))
    assert want == {'dbm_gemm_act': L * body * turns,
                    'dbm_softmax': len(multi) * body * turns,
                    'dbm_mf_check': turns}
    assert dbm_epoch.launches['dbm_gemm_act'] == \
        host + want['dbm_gemm_act']
    assert dbm_epoch.launches['dbm_softmax'] == \
        len(softmax) + want['dbm_softmax']
    assert dbm_epoch.launches['dbm_mf_check'] == turns
    assert not any(sum(fn.launches.values()) for fn in (
        samplers.bernoulli_sample, samplers.normal_sample,
        samplers.multinomial_sample))
