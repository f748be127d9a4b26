"""The port's histogram and image summaries against the JAX package's, on
the CPU: ``device_histogram`` bucket for bucket, ``filter_grid_image`` byte
for byte, and the summary tags a fitted RBM or DBM writes (mirrors of
tests/test_summary_writer.py and tests/test_aux.py)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boltzmann_machines_tpu.base.jax_model import \
    device_histogram as jax_device_histogram
from boltzmann_machines_tpu.utils import plot_utils as jax_plot_utils
from boltzmann_machines_tpu_torch import DBM, BernoulliRBM
from boltzmann_machines_tpu_torch.base.torch_model import (device_histogram,
                                                           to_host)
from boltzmann_machines_tpu_torch.utils import RNG, plot_utils


def _values(kind, n=4096, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * 10. ** rng.uniform(-3, 3)).astype(np.float32)
    if kind in ('nan', 'inf'):
        x[rng.rand(n) < 0.05] = np.nan
    if kind == 'inf':
        x[rng.rand(n) < 0.05] = np.inf
        x[:3] = -np.inf
    if kind == 'all_nan':
        x[:] = np.nan
    if kind == 'constant':
        x[:] = 1.5
    return x


@pytest.mark.parametrize('kind', ['finite', 'nan', 'inf', 'all_nan',
                                  'constant'])
@pytest.mark.parametrize('n_buckets', [64, 7])
def test_device_histogram_matches_jax(kind, n_buckets):
    """Counts, min, max and the non-finite count equal; sum and sum_sq
    within rtol 1e-6 (f32 sums over 4096 values in another order)."""
    x = _values(kind)
    want = {k: np.asarray(v)
            for k, v in jax_device_histogram(jnp.asarray(x),
                                             n_buckets).items()}
    got = to_host(device_histogram(torch.as_tensor(x), n_buckets))
    assert got['counts'].dtype == np.int32
    assert got['counts'].shape == (n_buckets,)
    np.testing.assert_array_equal(got['counts'], want['counts'])
    for k in ('min', 'max', 'n_nonfinite'):
        assert got[k] == want[k], k
    for k in ('sum', 'sum_sq'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_device_histogram_of_a_matrix():
    x = np.random.RandomState(1).randn(37, 29).astype(np.float32)
    got = to_host(device_histogram(torch.as_tensor(x)))
    want = jax_device_histogram(jnp.asarray(x))
    np.testing.assert_array_equal(got['counts'], np.asarray(want['counts']))
    assert got['counts'].sum() == x.size


@pytest.mark.parametrize('v_shape,n_filters', [((6, 6, 1), 4),
                                               ((4, 5, 3), 7),
                                               ((28, 28, 1), 30)])
def test_filter_grid_image_matches_jax(v_shape, n_filters):
    h, w, c = v_shape
    W = np.random.RandomState(2).randn(h * w * c, 33).astype(np.float32)
    got = plot_utils.filter_grid_image(W, v_shape, n_filters)
    want = jax_plot_utils.filter_grid_image(W, v_shape, n_filters)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    X = np.arange(4 * 6).reshape(4, 2, 3).astype(float)
    np.testing.assert_array_equal(
        plot_utils.im_reshape(X, n_width=2, n_height=2, normalize=True),
        jax_plot_utils.im_reshape(X, n_width=2, n_height=2, normalize=True))


def _event_payloads(logdir):
    out = b''
    for p in sorted(os.listdir(logdir)):
        if p.startswith('events.out'):
            with open(os.path.join(logdir, p), 'rb') as f:
                out += f.read()
    return out


def test_fit_writes_device_histograms_and_filter_images(tmp_model_dir):
    """A fit with summaries enabled lands the histogram and image events
    (tests/test_summary_writer.py's RBM case)."""
    X = (np.random.RandomState(0).rand(64, 36) < 0.5).astype('float32')
    rbm = BernoulliRBM(n_visible=36, n_hidden=9, max_epoch=2, batch_size=16,
                       random_seed=1, verbose=False, display_filters=4,
                       v_shape=(6, 6, 1),
                       metrics_config=dict(msre=True,
                                           train_metrics_every_iter=2),
                       device='cpu', model_path=tmp_model_dir)
    rbm.fit(X)
    data = _event_payloads(rbm._train_summary_dirpath)
    assert b'W_filters' in data
    assert b'\x89PNG' in data
    for tag in (b'W', b'vb', b'hb', b'dW', b'dvb', b'dhb'):
        assert tag in data


def test_summaries_follow_the_cadence(tmp_model_dir):
    """Summaries only in an epoch that logged a train metric and is a
    multiple of summaries_every_epoch; no train metric, no summaries."""
    X = (np.random.RandomState(0).rand(32, 16) < 0.5).astype('float32')

    def fit(path, **kw):
        rbm = BernoulliRBM(n_visible=16, n_hidden=4, max_epoch=3,
                           batch_size=16, random_seed=1, verbose=False,
                           display_filters=2, v_shape=(4, 4, 1),
                           device='cpu', model_path=tmp_model_dir + path,
                           **kw)
        rbm.fit(X)
        return _event_payloads(rbm._train_summary_dirpath)

    every2 = fit('a/', summaries_every_epoch=2,
                 metrics_config=dict(msre=True, train_metrics_every_iter=1))
    assert every2.count(b'W_filters') == 1        # epoch 2 of 3
    assert every2.count(b'\x89PNG') == 1
    off = fit('b/', metrics_config=dict(msre=False, pll=False,
                                        l2_loss=False))
    assert b'W_filters' not in off and b'dhb' not in off


def test_hidden_activation_image_summary(tmp_model_dir):
    """display_hidden_activations streams a (batch x n) activation image
    with the train summaries (tests/test_aux.py's case), and the probe
    draws nothing from the model's host RNG: the fit's state is the one
    of a fit without it."""
    X = RNG(1).rand(32, 12).astype('float32')

    def fit(path, n):
        rbm = BernoulliRBM(n_visible=12, n_hidden=8, max_epoch=1,
                           batch_size=16, random_seed=1, verbose=False,
                           display_hidden_activations=n,
                           save_after_each_epoch=False,
                           metrics_config=dict(msre=True,
                                               train_metrics_every_iter=1),
                           device='cpu', model_path=tmp_model_dir + path)
        rbm.fit(X)
        return rbm

    rbm = fit('a/', 6)
    data = _event_payloads(rbm._train_summary_dirpath)
    assert b'hidden_activation_means' in data
    assert b'\x89PNG' in data
    plain = fit('b/', 0)
    np.testing.assert_array_equal(rbm.get_params_arrays()['weights/W'],
                                  plain.get_params_arrays()['weights/W'])
    assert rbm._rng.randint(1000) == plain._rng.randint(1000)


def test_dbm_fit_writes_cumulative_filters_and_particles(tmp_model_dir):
    X = (np.random.RandomState(0).rand(64, 16) < 0.5).astype('float32')
    r1 = BernoulliRBM(n_visible=16, n_hidden=8, dbm_first=True, max_epoch=1,
                      batch_size=16, random_seed=1, verbose=False,
                      device='cpu', model_path=tmp_model_dir + 'r1/')
    r1.fit(X)
    r2 = BernoulliRBM(n_visible=8, n_hidden=6, dbm_last=True, max_epoch=1,
                      batch_size=16, random_seed=2, verbose=False,
                      device='cpu', model_path=tmp_model_dir + 'r2/')
    r2.fit(r1.transform(X))
    dbm = DBM(rbms=[r1, r2], n_particles=8, n_gibbs_steps=1,
              max_mf_updates=3, learning_rate=0.01, momentum=0.5,
              max_epoch=2, batch_size=16, random_seed=3, verbose=False,
              display_filters=4, display_particles=4, v_shape=(4, 4, 1),
              train_metrics_every_iter=2, device='cpu',
              model_path=tmp_model_dir + 'dbm/')
    dbm.fit(X)
    data = _event_payloads(dbm._train_summary_dirpath)
    assert b'W_filters_0' in data and b'W_filters_1' in data
    assert b'negative_particles' in data
    assert b'W_0' in data and b'hb_1' in data and b'vb' in data


def test_dbm_summary_stats_match_jax_arrays(tmp_model_dir):
    """The DBM's summary reduction on a given state: the cumulative
    filters are W_0 @ ... @ W_l's first columns and the particles the
    first chains (atol 1e-6: one f32 product in another order), the
    histograms those of the JAX function on the same arrays."""
    X = (np.random.RandomState(0).rand(32, 16) < 0.5).astype('float32')
    r1 = BernoulliRBM(n_visible=16, n_hidden=8, dbm_first=True, max_epoch=1,
                      batch_size=16, random_seed=1, verbose=False,
                      device='cpu', model_path=tmp_model_dir + 'r1/')
    r2 = BernoulliRBM(n_visible=8, n_hidden=6, dbm_last=True, max_epoch=1,
                      batch_size=16, random_seed=2, verbose=False,
                      device='cpu', model_path=tmp_model_dir + 'r2/')
    dbm = DBM(rbms=[r1, r2], n_particles=8, display_filters=3,
              display_particles=5, v_shape=(4, 4, 1), random_seed=3,
              device='cpu', model_path=tmp_model_dir + 'dbm/')
    dbm._ensure_state()
    state = dbm._state.as_dict()
    s = dbm._summary_device_stats(state)
    W0, W1 = (w.numpy() for w in state['W'])
    np.testing.assert_allclose(s['W_filters'][0], W0[:, :3], atol=1e-6)
    np.testing.assert_allclose(s['W_filters'][1], (W0 @ W1)[:, :3],
                               atol=1e-6)
    np.testing.assert_array_equal(s['particles'], state['v'][:5].numpy())
    want = jax_device_histogram(jnp.asarray(W1))
    np.testing.assert_array_equal(s['W'][1]['counts'],
                                  np.asarray(want['counts']))
