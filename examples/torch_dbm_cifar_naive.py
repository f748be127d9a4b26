#!/usr/bin/env python
"""
"Naive" 3-layer Gaussian-Bernoulli-Multinomial DBM on CIFAR-10, with the
PyTorch/CUDA package (boltzmann_machines_tpu_torch) on one GPU.

The counterpart of examples/dbm_cifar_naive.py (reference
examples/dbm_cifar_naive.py:45-424), line for line: SVD "smoothing" (zero
the 1000 smallest singular values, cached to X_s.npy), standardization,
Gaussian RBM 3072->5000 (dbm_first), Multinomial RBM 5000->1000 with 1000
tied softmax samples (dbm_last), 3-layer G-B-M DBM, and a BN+ReLU+Dropout
MLP fine-tuned from the G-RBM weights; the same arguments, defaults and
stage caching.  Each stage prints its wall as a ``[stage]`` line, as
examples/dbm_cifar.py does.

Reference result to match (README.md:256): 59.78% test accuracy.

Runs on the card; ``--device cpu`` runs it on the CPU.  ``--n-hiddens``
(default 5000 1000, the published widths; the M-RBM draws as many samples
as it has units) cuts the widths for a smoke run, e.g.

    python examples/torch_dbm_cifar_naive.py --device cpu --n-train 1200 \
        --n-val 200 --n-hiddens 24 100 --epochs 1 1 1 --mlp-epochs 1 \
        --data-path /tmp/cifar_smoke
"""

import argparse
import os

import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from boltzmann_machines_tpu_torch import DBM, GaussianRBM, MultinomialRBM
from boltzmann_machines_tpu_torch.finetune import MLPClassifier
from boltzmann_machines_tpu_torch.utils import (RNG, Stopwatch,
                                                one_hot_decision_function,
                                                unhot)
from boltzmann_machines_tpu_torch.utils.dataset import load_cifar10


def stage_cached(dirpath):
    """A stage is reusable only if a finished checkpoint exists --
    a bare directory can be left behind by an interrupted run."""
    return os.path.isfile(os.path.join(dirpath, 'params.json'))


def finish_stage(model, fit_args):
    """Resume-aware stage loading: a params.json written MID-RUN by
    checkpoint_every_epoch must neither pass for a finished model nor
    restart the stage from scratch -- resume training from the loaded
    epoch (trajectory-identical resume is a framework guarantee,
    tests/test_rbm.py).  Mirrors the reference's idempotent stage
    semantics (dbm_mnist.py:48,85,131) extended to partial checkpoints."""
    if model.epoch_ >= model.max_epoch:
        return model
    print('  (partial checkpoint: resuming at epoch %d/%d)'
          % (model.epoch_, model.max_epoch))
    model.fit(*fit_args())
    return model

def load_data(args):
    try:
        X, y = load_cifar10(mode='train', path=args.data_path)
        X_test, y_test = load_cifar10(mode='test', path=args.data_path)
    except (IOError, OSError):
        n = args.n_train + args.n_val
        print('CIFAR-10 files not found; using %d synthetic stand-in rows'
              % n)
        rng = RNG(42)
        # chunked f32 generation: one multi-GB buffer, no f64 intermediates
        # (a multi-GB first touch of fresh pages is slow on some hosts)
        X = np.empty((n, 3072), np.float32)
        for lo in range(0, n, 4096):
            hi = min(lo + 4096, n)
            X[lo:hi] = (rng.rand(hi - lo, 3072) * 255.).astype(np.float32)
        y = rng.randint(0, 10, n)
        X_test = rng.rand(1024, 3072) * 255.
        y_test = rng.randint(0, 10, 1024)
    X = np.asarray(X, np.float32)  # no copy when already f32 (stand-in)
    X /= 255.
    X_test = np.asarray(X_test, np.float32)
    X_test /= 255.
    RNG(seed=42).shuffle(X)
    RNG(seed=42).shuffle(y)
    n_train = min(len(X), args.n_train)
    n_val = min(len(X), args.n_val)
    return (X[:n_train], np.asarray(y[:n_train]),
            X[-n_val:], np.asarray(y[-n_val:]),
            X_test, np.asarray(y_test))


def make_smoothing(X_train, n_train, args):
    """Drop the 1000 smallest singular values of the (centered) training
    matrix (reference dbm_cifar_naive.py:45-75), cached to disk."""
    X_s_path = os.path.join(args.data_path, 'X_s.npy')
    if os.path.isfile(X_s_path):
        X_s = np.load(X_s_path)
        if len(X_s) == n_train:
            return X_s

    print('\nSmoothing data (SVD) ...')
    X_m = X_train.mean(axis=0)
    Xc = X_train - X_m
    with Stopwatch(verbose=True):
        U, s, Vh = np.linalg.svd(Xc, full_matrices=False)
        s[-1000:] = 0.
        X_s = (U * s) @ Vh
        X_s += X_m
    os.makedirs(args.data_path, exist_ok=True)
    np.save(X_s_path, X_s)
    return X_s


def make_grbm(X_train, X_val, args):
    if stage_cached(args.grbm_dirpath):
        print('\nLoading G-RBM ...\n')
        return finish_stage(GaussianRBM.load_model(args.grbm_dirpath,
                                                   device=args.device),
                            lambda: (X_train, X_val))
    print('\nTraining G-RBM ...\n')
    grbm = GaussianRBM(n_visible=32 * 32 * 3, n_hidden=args.n_hiddens[0],
                       sigma=1.,
                       W_init=0.0008, vb_init=0., hb_init=0.,
                       n_gibbs_steps=args.n_gibbs_steps[0],
                       learning_rate=args.lr[0],
                       momentum=np.geomspace(0.5, 0.9, 8),
                       max_epoch=args.epochs[0],
                       batch_size=args.batch_size[0],
                       l2=args.l2[0],
                       sample_v_states=True, sample_h_states=True,
                       sparsity_cost=0.,
                       dbm_first=True,
                       metrics_config=dict(msre=True, feg=True,
                                           train_metrics_every_iter=1000,
                                           val_metrics_every_epoch=2,
                                           feg_every_epoch=2,
                                           n_batches_for_feg=50),
                       verbose=True, display_filters=12,
                       display_hidden_activations=24, v_shape=(32, 32, 3),
                       dtype='float32', random_seed=args.random_seed[0],
                       checkpoint_every_epoch=args.checkpoint_every,
                       summaries_every_epoch=args.summaries_every,
                       device=args.device, model_path=args.grbm_dirpath)
    grbm.fit(X_train, X_val)
    return grbm


def make_mrbm(Q_train, Q_val, args):
    if stage_cached(args.mrbm_dirpath):
        print('\nLoading M-RBM ...\n')
        return finish_stage(MultinomialRBM.load_model(args.mrbm_dirpath,
                                                      device=args.device),
                            lambda: (Q_train, Q_val))
    print('\nTraining M-RBM ...\n')
    mrbm = MultinomialRBM(n_visible=args.n_hiddens[0],
                          n_hidden=args.n_hiddens[1],
                          n_samples=args.n_hiddens[1],
                          W_init=0.01, hb_init=0., vb_init=0.,
                          n_gibbs_steps=args.n_gibbs_steps[1],
                          learning_rate=args.lr[1],
                          momentum=np.geomspace(0.5, 0.9, 8),
                          max_epoch=args.epochs[1],
                          batch_size=args.batch_size[1],
                          l2=args.l2[1],
                          sample_h_states=True, sample_v_states=False,
                          sparsity_cost=0.,
                          dbm_last=True,
                          metrics_config=dict(msre=True, pll=True, feg=True,
                                              train_metrics_every_iter=400,
                                              val_metrics_every_epoch=2,
                                              feg_every_epoch=2,
                                              n_batches_for_feg=50),
                          verbose=True, display_hidden_activations=100,
                          random_seed=1337, dtype='float32',
                          checkpoint_every_epoch=args.checkpoint_every,
                          summaries_every_epoch=args.summaries_every,
                          device=args.device, model_path=args.mrbm_dirpath)
    mrbm.fit(Q_train, Q_val)
    return mrbm


def make_rbm_transform(rbm, X, path, np_dtype=None):
    if os.path.isfile(path):
        H = np.load(path)
        if len(X) == len(H):
            return H
    H = rbm.transform(X, np_dtype=np_dtype)
    np.save(path, H)
    return H


def make_dbm(data, rbms, particles, args):
    X_train, X_val = data
    Q, G = particles
    if stage_cached(args.dbm_dirpath):
        print('\nLoading DBM ...\n')
        dbm = DBM.load_model(args.dbm_dirpath, device=args.device)
        dbm.load_rbms(list(rbms))
        return finish_stage(dbm, lambda: (X_train, X_val))
    print('\nTraining DBM ...\n')
    dbm = DBM(rbms=list(rbms),
              n_particles=args.n_particles,
              v_particle_init=X_train[:args.n_particles].copy(),
              h_particles_init=(Q[:args.n_particles].copy(),
                                G[:args.n_particles].copy()),
              n_gibbs_steps=args.n_gibbs_steps[2],
              max_mf_updates=args.max_mf_updates,
              mf_tol=args.mf_tol,
              learning_rate=np.geomspace(args.lr[2], 1e-5, args.epochs[2]),
              momentum=np.geomspace(0.5, 0.9, 10),
              max_epoch=args.epochs[2],
              batch_size=args.batch_size[2],
              l2=args.l2[2],
              max_norm=args.max_norm,
              sample_v_states=True, sample_h_states=(True, True),
              sparsity_cost=0.,
              train_metrics_every_iter=1000,
              val_metrics_every_epoch=2,
              random_seed=args.random_seed[2],
              verbose=True, save_after_each_epoch=True,
              display_filters=12, display_particles=36, v_shape=(32, 32, 3),
              dtype='float32', checkpoint_every_epoch=args.checkpoint_every,
              summaries_every_epoch=args.summaries_every,
              device=args.device, model_path=args.dbm_dirpath)
    dbm.fit(X_train, X_val)
    return dbm


def make_mlp(train, val, test, weights, args):
    X_train, y_train = train
    X_val, y_val = val
    X_test, y_test = test
    W, hb = weights

    layer = dict(units=args.n_hiddens[0], activation='relu', batch_norm=True,
                 dropout=args.mlp_dropout, lr_multiplier=args.mlp_lrm[0])
    if W is not None and hb is not None:
        layer['weights'] = (W, hb)

    mlp = MLPClassifier(n_inputs=3 * 32 * 32, layers=[layer], n_classes=10,
                        l2=args.mlp_l2, learning_rate=0.001,
                        max_epoch=args.mlp_epochs,
                        batch_size=args.mlp_batch_size,
                        val_metric=args.mlp_val_metric,
                        random_seed=3333, verbose=True, device=args.device)
    with Stopwatch(verbose=True):
        try:
            mlp.fit(X_train, y_train, X_val, y_val)
        except KeyboardInterrupt:
            pass

    y_proba = mlp.predict_proba(X_test)
    y_pred = unhot(one_hot_decision_function(y_proba), n_classes=10)
    acc = float(np.mean(y_pred == np.asarray(y_test)))
    print('Test accuracy: {0:.4f}'.format(acc))

    os.makedirs(os.path.dirname(args.mlp_save_prefix) or '.',
                exist_ok=True)
    np.save(args.mlp_save_prefix + 'y_pred.npy', y_pred)
    np.save(args.mlp_save_prefix + 'y_test.npy', np.asarray(y_test))
    np.save(args.mlp_save_prefix + 'W_finetuned.npy', mlp.get_weights(0)[0])
    import json
    with open(args.mlp_save_prefix + 'accuracy.json', 'w') as f:
        json.dump({'test_accuracy': acc}, f)


def main():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--n-train', type=int, default=49000)
    parser.add_argument('--n-val', type=int, default=1000)
    parser.add_argument('--data-path', type=str, default=None,
                        help='data root (default: BMT_DATA_DIR or repo data/)')
    parser.add_argument('--n-hiddens', type=int, default=(5000, 1000),
                        nargs='+', help='the G-RBM and M-RBM widths (the '
                        "M-RBM's n_samples is its width)")
    parser.add_argument('--n-gibbs-steps', type=int, default=(1, 1, 1), nargs='+')
    parser.add_argument('--lr', type=float, default=(5e-4, 1e-4, 8e-5), nargs='+')
    parser.add_argument('--epochs', type=int, default=(120, 180, 1500), nargs='+')
    parser.add_argument('--batch-size', type=int, default=(100, 100, 100), nargs='+')
    parser.add_argument('--l2', type=float, default=(0.01, 0.05, 1e-8), nargs='+')
    parser.add_argument('--random-seed', type=int, default=(1337, 1111, 2222), nargs='+')
    parser.add_argument('--grbm-dirpath', type=str, default='../models/grbm_cifar_naive/')
    parser.add_argument('--mrbm-dirpath', type=str, default='../models/mrbm_cifar_naive/')
    parser.add_argument('--dbm-dirpath', type=str, default='../models/dbm_cifar_naive/')
    parser.add_argument('--n-particles', type=int, default=100)
    parser.add_argument('--max-mf-updates', type=int, default=50)
    parser.add_argument('--mf-tol', type=float, default=1e-11)
    parser.add_argument('--max-norm', type=float, default=4.)
    parser.add_argument('--checkpoint-every', type=int, default=1,
                        help='save a checkpoint every N epochs (final state '
                             'is always saved); raise on slow device links')
    parser.add_argument('--summaries-every', type=int, default=1,
                        help='write histogram/image summaries every N epochs')
    parser.add_argument('--mlp-no-init', action='store_true')
    parser.add_argument('--mlp-l2', type=float, default=1e-4)
    parser.add_argument('--mlp-lrm', type=float, default=(0.1, 1.), nargs='+')
    parser.add_argument('--mlp-epochs', type=int, default=100)
    parser.add_argument('--mlp-val-metric', type=str, default='val_acc')
    parser.add_argument('--mlp-batch-size', type=int, default=128)
    parser.add_argument('--mlp-dropout', type=float, default=0.64)
    parser.add_argument('--mlp-save-prefix', type=str, default='../data/grbm_naive_')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device of every stage ('cpu' only when "
                             "asked for)")
    args = parser.parse_args()
    # cache files (X_s/X_aug/Q/G .npy) live under the data root too
    from boltzmann_machines_tpu_torch.utils.dataset import resolve_data_dir
    args.data_path = resolve_data_dir(args.data_path)


    for name in ('n_gibbs_steps', 'lr', 'epochs', 'batch_size', 'l2',
                 'random_seed'):
        val = getattr(args, name)
        if isinstance(val, (list, tuple)) and len(val) == 1:
            setattr(args, name, list(val) * 3)

    # per-stage wall clocks, printed as each stage completes and summed at
    # the end (as examples/dbm_cifar.py prints them)
    import time as _time
    _t0 = _time.monotonic()
    _stages = []

    def _stage_done(name):
        now = _time.monotonic()
        prev = _t0 + sum(s for _, s in _stages)
        _stages.append((name, now - prev))
        print('\n[stage] %-28s %8.1f s  (total %8.1f s)\n'
              % (name, _stages[-1][1], now - _t0), flush=True)

    print('\nPreparing data ...\n')
    X_train, y_train, X_val, y_val, X_test, y_test = load_data(args)
    _stage_done('load data')

    X_s = make_smoothing(X_train, len(X_train), args)
    _stage_done('SVD smoothing')

    # standardize
    X_mean = X_s.mean(axis=0)
    X_std = X_s.std(axis=0) + 1e-8
    X_train_s = (X_s - X_mean) / X_std
    X_val_s = (X_val - X_mean) / X_std
    X_test_s = (X_test - X_mean) / X_std

    grbm = make_grbm(X_train_s, X_val_s, args)
    _stage_done('G-RBM')

    # --epochs G 0 0 runs the G-RBM + fine-tune slice only (the reference's
    # 59.78% accuracy is the G-RBM classifier, README.md:256; the M-RBM/DBM
    # stages only feed the generative model)
    if args.epochs[1] > 0:
        print('\nExtracting G-RBM features ...\n')
        Q_train = make_rbm_transform(grbm, X_train_s,
                                     os.path.join(args.data_path, 'Q_train_naive.npy'))
        Q_val = make_rbm_transform(grbm, X_val_s,
                                   os.path.join(args.data_path, 'Q_val_naive.npy'))
        _stage_done('G-RBM features')

        mrbm = make_mrbm(Q_train, Q_val, args)
        _stage_done('M-RBM')

        if args.epochs[2] > 0:
            print('\nExtracting M-RBM features ...\n')
            G_train = make_rbm_transform(mrbm, Q_train,
                                         os.path.join(args.data_path, 'G_train_naive.npy'))
            _stage_done('M-RBM features')

            make_dbm((X_train_s, X_val_s), (grbm, mrbm), (Q_train, G_train), args)
            _stage_done('3-layer DBM')

    print('\nDiscriminative fine-tuning ...\n')
    W = hb = None
    if not args.mlp_no_init:
        weights = grbm.get_params_arrays(scope='weights')
        W, hb = weights['W'], weights['hb']
    make_mlp((X_train_s, y_train), (X_val_s, y_val), (X_test_s, y_test),
             (W, hb), args)
    _stage_done('MLP fine-tune')

    print('\n[stage] composite end-to-end: %.1f s (%.1f min)\n'
          % (_time.monotonic() - _t0, (_time.monotonic() - _t0) / 60.))
    for name, secs in _stages:
        print('[stage]   %-28s %8.1f s' % (name, secs))


if __name__ == '__main__':
    main()
