"""The fit loop's whole-set passes (``ops/cd_val.py``) on the CPU, where they
run their plain version (``cd_pass_reference``), against the generic path's
validation and free-energy gap batch by batch (``BaseRBM._val_metrics``,
``_feg``); and which fits take them.  The CUDA passes are held against this
plain version draw by draw on the card (tests/test_torch_cuda.py)."""

import json
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from boltzmann_machines_tpu_torch import (BernoulliRBM, GaussianRBM,
                                          MultinomialRBM, parallel)
from boltzmann_machines_tpu_torch.ops import cd_val as cd_val_mod
from boltzmann_machines_tpu_torch.ops.cd_epoch import (pll_flip_index,
                                                       pll_from_flip,
                                                       reset_launches,
                                                       sigma_row)
from boltzmann_machines_tpu_torch.ops.cd_val import cd_val
from boltzmann_machines_tpu_torch.ops.philox import (STREAM_PLL_HHAT,
                                                     STREAM_PLL_HHAT_FLIP,
                                                     multinomial_counts)
from boltzmann_machines_tpu_torch.rbm import base_rbm
from boltzmann_machines_tpu_torch.rbm.base_rbm import (_VAL_SALT, BaseRBM,
                                                       derive_seed)

# 45 rows at batch 8: five full batches and a remainder batch of 5
V, H, N, B = 12, 7, 45, 8
N_SAMPLES = 5
FLAVOURS = ['bernoulli', 'gaussian', 'multinomial']


def make_model(flavour, **kw):
    rng = np.random.RandomState(3)
    cfg = dict(n_visible=V, n_hidden=H, W_init=0.3 * rng.randn(V, H),
               vb_init=0.2 * rng.randn(V), hb_init=0.1 * rng.randn(H),
               batch_size=B, sample_v_states=False, sample_h_states=False,
               metrics_config=dict(msre=True, pll=True, feg=True,
                                   n_batches_for_feg=3),
               random_seed=5, verbose=False, device='cpu')
    cfg.update(kw)
    if flavour == 'gaussian':
        return GaussianRBM(sigma=(rng.rand(V) + 0.5).astype(np.float32),
                           dbm_first=True, **cfg)
    if flavour == 'multinomial':
        return MultinomialRBM(n_samples=N_SAMPLES, dbm_last=True, **cfg)
    return BernoulliRBM(**cfg)


def make_data(flavour, seed, n=N):
    """`n` rows; the remainder batch's rows stand apart (all ones, or three
    times the scale), so that weighting it as one batch, and not by its
    rows, shows."""
    rng = np.random.RandomState(seed)
    if flavour == 'gaussian':
        X = rng.randn(n, V)
        X[n // B * B:] *= 3.
    else:
        X = rng.rand(n, V) < 0.4
        X[n // B * B:] = 1.
    return X.astype(np.float32)


def segments(n):
    return [(s, min(s + B, n)) for s in range(0, n, B)]


def fe_interval(model, X):
    """The interval of the multinomial Monte Carlo free energy's mean over
    batch segments, whatever the count vectors h (h >= 0, sum h = n):
    -mean(X vb) - mean(X W).h, the lgamma constant left out (it cancels in
    the gap)."""
    s = model._state.as_dict()
    lo, hi = [], []
    for s0, s1 in segments(len(X)):
        a = (X[s0:s1] @ s['W']).mean(0)
        t1 = -(X[s0:s1] @ s['vb']).mean()
        lo.append(float(t1 - N_SAMPLES * a.max()))
        hi.append(float(t1 - N_SAMPLES * a.min()))
    return np.mean(lo), np.mean(hi)


@pytest.mark.parametrize('flavour', FLAVOURS)
def test_whole_set_pass_matches_generic_path(flavour, monkeypatch):
    """Sampling off, 45 rows at batch 8.  The pass's msre equals the
    generic ``_val_metrics``' within 1e-6, and both are the mean of the six
    batch means, the remainder one of them: the mean over rows lies more
    than 1e-3 away.  Its PLL equals ``pll_from_flip`` per segment with the
    pass's own flips (and count vectors), averaged.  Its FEG equals the
    generic ``_feg``'s within 1e-5 where the free energy draws nothing; for
    multinomial hidden units both lie in the interval any count vectors
    give.  The FEG's probe rows: the first three batches of the validation
    set, and of a 20-row training set its two batches and its remainder."""
    monkeypatch.setattr(BaseRBM, '_kernel_eligible', lambda self: True)
    m = make_model(flavour)
    m._ensure_state()
    m._fit_seed, m.epoch_ = 2 ** 31 + 11, 4
    X_val = make_data(flavour, 1)
    rows, staged = m._stage_rows(X_val), m._stage_batches(X_val)
    got, want = m._val_pass(rows, 1), m._val_metrics(staged, 1)
    assert abs(got['msre'] - want['msre']) <= 1e-6

    state = m._state.as_dict()
    _, h0 = m._h_states0(state, rows, None)
    v_means = m._gibbs_chain(state, h0, 1, None)[1]
    row_mean = float(torch.mean(torch.square(rows - v_means)))
    assert abs(row_mean - want['msre']) > 1e-3

    cfg = m._cd_config(1)
    seed = derive_seed(m._fit_seed, _VAL_SALT + m.epoch_)
    flips = pll_flip_index(seed, 0, N, V, 'cpu')
    counts = [None, None]
    if flavour == 'multinomial':
        means = torch.full((len(segments(N)), H),
                           float(np.float32(N_SAMPLES) / np.float32(H)))
        counts = [multinomial_counts(means, N_SAMPLES, seed, 0, stream)
                  for stream in (STREAM_PLL_HHAT, STREAM_PLL_HHAT_FLIP)]
    plls = [float(pll_from_flip(
        rows[s0:s1], flips[s0:s1], state['W'], state['vb'], state['hb'],
        cfg.visible, cfg.hidden, sigma_row(cfg, 'cpu'),
        tuple(None if c is None else c[i] for c in counts)))
        for i, (s0, s1) in enumerate(segments(N))]
    assert got['pll'] == pytest.approx(np.mean(plls), rel=1e-6, abs=1e-6)

    X = make_data(flavour, 2, n=20)
    train = m._stage_batches(X)
    feg = m._feg_pass(m._stage_rows(X[:3 * B]), rows)
    feg_generic = m._feg(train, staged)
    if flavour != 'multinomial':
        assert feg == pytest.approx(feg_generic, rel=1e-5, abs=1e-5)
        return
    lo_v, hi_v = fe_interval(m, rows[:3 * B])
    lo_t, hi_t = fe_interval(m, torch.as_tensor(X))
    for value in (feg, feg_generic):
        assert lo_v - hi_t - 1e-4 <= value <= hi_v - lo_t + 1e-4


@pytest.mark.parametrize('flavour', FLAVOURS)
def test_chunks_leave_the_segments_whole(flavour, monkeypatch):
    """A pass cut into chunks of whole batches (CHUNK_BYTES cut to two
    batches' buffers, or one) gives the one-chunk pass's msre, and free
    energy where it draws nothing, bit for bit, sampling off: each
    segment's numbers do not depend on the chunk it falls in."""
    m = make_model(flavour)
    m._ensure_state()
    cfg, state = m._cd_config(1), m._state.as_dict()
    X = m._stage_rows(make_data(flavour, 3))
    whole = cd_val_mod.cd_pass_reference(cfg, state, X, B, 9, 0, 1, True,
                                         True, False)
    assert cd_val_mod.chunk_rows(cfg, N, B, True, True, False) == 6 * B
    one_batch = 4 * B * (V + H + (H if flavour == 'multinomial' else 0))
    monkeypatch.setattr(cd_val_mod, 'CHUNK_BYTES', 2 * one_batch + 700)
    rows_c = cd_val_mod.chunk_rows(cfg, N, B, True, True, False)
    assert rows_c in (B, 2 * B)
    cut = cd_val_mod.cd_pass_reference(cfg, state, X, B, 9, 0, 1, True,
                                       True, False)
    assert torch.equal(cut[0], whole[0]) and float(cut[0]) > 0
    if flavour != 'multinomial':
        assert torch.equal(cut[2], whole[2])


GENERIC_PATHS = ['dropout', 'float64', 'tensor_parallel', 'xla']
LOGGED_KEYS = [('free_energy_gap', 10),
               ('mean_squared_reconstruction_error', 5),
               ('mean_squared_reconstruction_error', 10),
               ('pseudo_loglikelihood', 5), ('pseudo_loglikelihood', 10)]


def fit_logged(path, mesh=None, **kw):
    """A Bernoulli RBM fit, 2 epochs of 40 rows at batch 8, validation on 20
    rows every epoch and the FEG every 2; returns the validation scalars."""
    rng = np.random.RandomState(11)
    X = (rng.rand(60, V) < 0.4).astype(np.float32)
    rng = np.random.RandomState(3)
    cfg = dict(n_visible=V, n_hidden=H, W_init=0.3 * rng.randn(V, H),
               batch_size=8, max_epoch=2, random_seed=5, verbose=False,
               sample_h_states=True, device='cpu',
               metrics_config=dict(msre=True, pll=True, feg=True,
                                   train_metrics_every_iter=2,
                                   val_metrics_every_epoch=1,
                                   feg_every_epoch=2, n_batches_for_feg=2),
               model_path=path)
    cfg.update(kw)
    m = BernoulliRBM(**cfg)
    if mesh is not None:
        m.set_mesh(mesh, model_axis='model')
    m.fit(X[:40], X[40:])
    with open(os.path.join(path, 'logs', 'val', 'scalars.jsonl')) as f:
        return {(r['tag'], r['step']): r['value'] for r in map(json.loads, f)}


@pytest.fixture
def eligible_off_the_card(monkeypatch):
    """``_kernel_eligible``'s rule on the CPU: every condition but the CUDA
    device, so that a CPU fit takes the kernel path (the passes' plain
    version) exactly where a CUDA fit would."""
    rule = BaseRBM._kernel_eligible

    def eligible(self):
        device = self._device
        self._device = torch.device('cuda')
        try:
            return rule(self)
        finally:
            self._device = device
    monkeypatch.setattr(BaseRBM, '_kernel_eligible', eligible)


@pytest.mark.parametrize('path', ['kernel'] + GENERIC_PATHS)
def test_passes_run_on_the_kernel_path_alone(path, tmp_path, monkeypatch,
                                             eligible_off_the_card):
    """``cd_val.passes`` counts a 'val' pass every validation and a 'feg'
    pass a side of every gap on the kernel path: 2 and 2 over the 2
    epochs.  The generic path (kernel='xla'), dropout, float64 and a
    tensor-parallel mesh (one rank) count none, never reach the passes
    (made to raise), and log what the per-batch ``_val_metrics`` and
    ``_feg`` returned."""
    reset_launches()
    returned = []
    if path != 'kernel':
        def unreachable(*args, **kwargs):
            raise AssertionError('a whole-set pass off the kernel path')
        monkeypatch.setattr(base_rbm, 'cd_val', unreachable)
        monkeypatch.setattr(base_rbm, 'cd_feg', unreachable)
        for name in ('_val_metrics', '_feg'):
            def recorded(self, *args, _fn=getattr(BaseRBM, name)):
                out = _fn(self, *args)
                returned.append(out)
                return out
            monkeypatch.setattr(BaseRBM, name, recorded)
    d = str(tmp_path) + '/'
    if path == 'tensor_parallel':
        parallel.initialize('file://' + d + 'store', 1, 0, backend='gloo')
        try:
            logged = fit_logged(d, mesh=parallel.make_mesh())
        finally:
            dist.destroy_process_group()
    else:
        kw = {'kernel': {}, 'xla': dict(kernel='xla'),
              'dropout': dict(dropout=0.9),
              'float64': dict(dtype='float64')}[path]
        logged = fit_logged(d, **kw)
    assert sorted(logged) == LOGGED_KEYS
    if path == 'kernel':
        assert cd_val.passes == {'val': 2, 'feg': 2}
        assert all(math.isfinite(v) for v in logged.values())
        return
    assert cd_val.passes == {'val': 0, 'feg': 0}
    # epoch 1 validates; epoch 2 validates, then measures the gap
    val1, val2, feg = returned
    want = {('mean_squared_reconstruction_error', 5): val1['msre'],
            ('pseudo_loglikelihood', 5): val1['pll'],
            ('mean_squared_reconstruction_error', 10): val2['msre'],
            ('pseudo_loglikelihood', 10): val2['pll'],
            ('free_energy_gap', 10): feg}
    np.testing.assert_array_equal([logged[k] for k in LOGGED_KEYS],
                                  [want[k] for k in LOGGED_KEYS])


def test_sampled_msre_agrees_with_generic_path_in_law(monkeypatch):
    """Both states sampled, k = 2: the pass draws from Philox streams, the
    generic path from a torch.Generator, so their msre differ seed by seed;
    over 8 seeds of each the means lie within 3 standard errors."""
    monkeypatch.setattr(BaseRBM, '_kernel_eligible', lambda self: True)
    m = make_model('bernoulli', sample_v_states=True, sample_h_states=True)
    m._ensure_state()
    X_val = make_data('bernoulli', 4)
    rows, staged = m._stage_rows(X_val), m._stage_batches(X_val)
    passes, generic = [], []
    for i in range(8):
        m._fit_seed = 1000 + i
        passes.append(m._val_pass(rows, 2)['msre'])
        generic.append(m._val_metrics(staged, 2)['msre'])
    se = math.sqrt(np.var(passes, ddof=1) / 8 + np.var(generic, ddof=1) / 8)
    assert 0 < se and abs(np.mean(passes) - np.mean(generic)) <= 3 * se
