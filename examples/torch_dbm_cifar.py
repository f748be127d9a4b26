#!/usr/bin/env python
"""
3-layer Gaussian-Bernoulli-Multinomial DBM on (augmented) CIFAR-10 with
patch-wise pretraining, with the PyTorch/CUDA package
(boltzmann_machines_tpu_torch) on one GPU.

The counterpart of examples/dbm_cifar.py (reference
examples/dbm_cifar.py:57-687), line for line: x10 data augmentation (1-px
shifts + horizontal mirror, uint8-cached), 26 small 192->300 Gaussian RBMs
on 8x8 patches (4x4 grid + 3x3 offset grid + one on the 4x4-downsampled
image), quilting of small weights into a 3072->7800 G-RBM initialization
with overlap averaging, G-RBM -> M-RBM 7800->512 (float16 features,
widened exactly) -> 3-layer DBM, and BN+ReLU+Dropout MLP fine-tuning; the
same arguments, defaults, stage caching and ``[stage]`` walls.

Reference result to match (README.md:323-325): 64.38% / 68.11% test
accuracy without / with augmentation.

Runs on the card; ``--device cpu`` runs it on the CPU.
``--n-small-hidden`` (default 300) and ``--n-hiddens`` (the M-RBM's width
and n_samples, default 512: the published widths) cut the widths for a
smoke run, e.g.

    python examples/torch_dbm_cifar.py --device cpu --n-train 200 \
        --n-val 100 --n-small-hidden 36 --n-hiddens 100 --small-epochs 1 \
        --epochs 1 1 1 --increase-n-gibbs-steps-every 1 --mlp-epochs 1 \
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
from boltzmann_machines_tpu_torch.utils.dataset import (load_cifar10,
                                                        im_flatten,
                                                        im_unflatten)


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
        # honor --n-train/--n-val so wall-clocks stay comparable with the
        # reference's 49k-row scale even without the real dataset
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


def make_augmentation(X_train, y_train, n_train, args):
    """x10 augmentation: 4 one-pixel shifts + horizontal mirror of all
    (reference dbm_cifar.py:57-106); cached as uint8."""
    X_aug_path = os.path.join(args.data_path, 'X_aug.npy')
    y_aug = np.asarray(list(y_train) * 10)
    RNG(seed=1337).shuffle(y_aug)

    if os.path.isfile(X_aug_path):
        X_aug = np.load(X_aug_path)
        if len(X_aug) == 10 * n_train:
            X = X_aug.astype(np.float32)
            X /= 255.  # in place: multi-GB temporaries are expensive to
            # first-touch on some hosts
            return X, y_aug

    print('\nAugmenting data ...')
    with Stopwatch(verbose=True):
        from boltzmann_machines_tpu_torch.utils.native import (
            augment_x10, augment_x10_u8_flat)
        X_im = im_unflatten(X_train)
        # fused native path writes the uint8 cache layout directly (1 byte
        # per pixel first-touched instead of 4 + two conversion passes)
        X_u8 = augment_x10_u8_flat(X_im)
        if X_u8 is not None:
            RNG(seed=1337).shuffle(X_u8)
        else:  # numpy fallback: float augmentation + host conversion
            X_aug = augment_x10(X_im)
            RNG(seed=1337).shuffle(X_aug)
            X_u8 = im_flatten((X_aug * 255.).astype('uint8'))
        os.makedirs(args.data_path, exist_ok=True)
        np.save(X_aug_path, X_u8)
    X = X_u8.astype(np.float32)
    X /= 255.  # in place (one 6 GB pass instead of two)
    return X, y_aug


def small_patches(X_im, i, j, offset=0):
    return im_flatten(X_im[:, offset + 8 * i:offset + 8 * (i + 1),
                           offset + 8 * j:offset + 8 * (j + 1), :])


def downsampled(X_im):
    """(N, 32, 32, 3) -> 4x4 block means -> (N, 8*8*3)."""
    Z = X_im.transpose(0, 3, 1, 2)
    Z = Z.reshape((-1, 3, 8, 4, 8, 4)).mean(axis=5).mean(axis=3)
    return im_flatten(Z.transpose(0, 2, 3, 1))


def make_small_rbms(X_train, X_val, args):
    """Train 26 small 192->300 Gaussian RBMs on 8x8 patches
    (dbm_cifar.py:108-219)."""
    _memo = {}

    def X_im():
        # lazy: the NHWC copy of the full training set is ~6 GB; skip it
        # entirely when every small-RBM stage is cached
        if 'x' not in _memo:
            _memo['x'] = im_unflatten(X_train)
        return _memo['x']

    Xv_im = im_unflatten(X_val)

    config = dict(n_visible=8 * 8 * 3, n_hidden=args.n_small_hidden, sigma=1.,
                  W_init=0.001, vb_init=0., hb_init=0., n_gibbs_steps=1,
                  learning_rate=args.small_lr,
                  momentum=np.geomspace(0.5, 0.9, 8),
                  max_epoch=args.small_epochs,
                  batch_size=args.small_batch_size,
                  l2=args.small_l2,
                  sample_v_states=True, sample_h_states=True,
                  sparsity_target=args.small_sparsity_target,
                  sparsity_cost=args.small_sparsity_cost,
                  dbm_first=True,
                  metrics_config=dict(msre=True, feg=True,
                                      train_metrics_every_iter=2000,
                                      val_metrics_every_epoch=2,
                                      feg_every_epoch=2,
                                      n_batches_for_feg=100),
                  verbose=True, display_filters=12,
                  display_hidden_activations=36, v_shape=(8, 8, 3),
                  dtype='float32', device=args.device)

    small_rbms = []

    def train_one(rbm_id, patches, seed):
        """`patches`: () -> (Xp, Xpv), evaluated only when the stage is
        not cached -- each patch extraction is a ~380 MB host copy."""
        dirpath = args.small_dirpath_prefix + str(rbm_id) + '/'
        if stage_cached(dirpath):
            print('\nLoading small RBM #{0} ...\n'.format(rbm_id))
            return finish_stage(GaussianRBM.load_model(dirpath,
                                                       device=args.device),
                                patches)
        print('\nTraining small RBM #{0} ...\n'.format(rbm_id))
        rbm = GaussianRBM(random_seed=seed, checkpoint_every_epoch=args.checkpoint_every,
                          summaries_every_epoch=args.summaries_every,
                          model_path=dirpath, **config)
        Xp, Xpv = patches()
        rbm.fit(Xp, Xpv)
        return rbm

    # 16 on the regular 4x4 grid
    for i in range(4):
        for j in range(4):
            rbm_id = 4 * i + j
            small_rbms.append(train_one(
                rbm_id,
                lambda i=i, j=j: (small_patches(X_im(), i, j),
                                  small_patches(Xv_im, i, j)),
                9000 + rbm_id))

    # 9 on the half-offset 3x3 grid
    for i in range(3):
        for j in range(3):
            rbm_id = 16 + 3 * i + j
            small_rbms.append(train_one(
                rbm_id,
                lambda i=i, j=j: (small_patches(X_im(), i, j, offset=4),
                                  small_patches(Xv_im, i, j, offset=4)),
                args.small_random_seed + rbm_id))

    # 1 on the 4x4-downsampled image
    small_rbms.append(train_one(
        25, lambda: (downsampled(X_im()), downsampled(Xv_im)), 9000 + 25))
    return small_rbms


def make_large_weights(small_rbms, H):
    """Quilt 26 small (192, H = 300) weight blocks into a (3072, 26 H =
    7800) G-RBM initialization with overlap averaging
    (dbm_cifar.py:221-276)."""
    W = np.zeros((H * 26, 32, 32, 3), dtype=np.float32)
    W[...] = RNG(seed=1234).rand(*W.shape) * 5e-6
    vb = np.zeros((32, 32, 3))
    hb = np.zeros(H * 26)

    def paste(rbm_id, oi, oj):
        weights = small_rbms[rbm_id].get_params_arrays(scope='weights')
        W_small = im_unflatten(weights['W'].T)  # (300, 8, 8, 3)
        W[H * rbm_id:H * (rbm_id + 1), oi:oi + 8, oj:oj + 8, :] = W_small
        vb[oi:oi + 8, oj:oj + 8, :] += im_unflatten(weights['vb'])
        hb[H * rbm_id:H * (rbm_id + 1)] = weights['hb']

    for i in range(4):
        for j in range(4):
            paste(4 * i + j, 8 * i, 8 * j)
    for i in range(3):
        for j in range(3):
            paste(16 + 3 * i + j, 4 + 8 * i, 4 + 8 * j)

    weights = small_rbms[25].get_params_arrays(scope='weights')
    W_small = im_unflatten(weights['W'].T)      # (300, 8, 8, 3)
    vb_small = im_unflatten(weights['vb'])      # (8, 8, 3)
    for i in range(8):
        for j in range(8):
            U = W_small[:, i, j, :]             # (300, 3)
            U = U[:, None, None, :]             # (300, 1, 1, 3)
            W[-H:, 4 * i:4 * (i + 1), 4 * j:4 * (j + 1), :] = U / 16.
            vb[4 * i:4 * (i + 1), 4 * j:4 * (j + 1), :] += \
                vb_small[i, j, :].reshape((1, 1, 3)) / 16.
    hb[-H:] = weights['hb']

    W = im_flatten(W).T                         # (3072, 7800)
    vb /= 2.
    vb[4:-4, 4:-4, :] /= 1.5
    vb = im_flatten(vb)
    return W, vb, hb


def make_grbm(X_train, X_val, small_rbms, args):
    if stage_cached(args.grbm_dirpath):
        print('\nLoading G-RBM ...\n')
        return finish_stage(GaussianRBM.load_model(args.grbm_dirpath,
                                                   device=args.device),
                            lambda: (X_train, X_val))
    print('\nAssembling weights for large Gaussian RBM ...\n')
    W, vb, hb = make_large_weights(small_rbms, args.n_small_hidden)
    print('\nTraining G-RBM ...\n')
    grbm = GaussianRBM(n_visible=32 * 32 * 3,
                       n_hidden=args.n_small_hidden * 26,
                       sigma=1., W_init=W, vb_init=vb, hb_init=hb,
                       n_gibbs_steps=args.n_gibbs_steps[0],
                       learning_rate=args.lr[0],
                       momentum=np.geomspace(0.5, 0.9, 8),
                       max_epoch=args.epochs[0],
                       batch_size=args.batch_size[0],
                       l2=args.l2[0],
                       sample_v_states=True, sample_h_states=True,
                       sparsity_target=0.1, sparsity_cost=1e-4,
                       dbm_first=True,
                       metrics_config=dict(msre=True, feg=True,
                                           train_metrics_every_iter=1000,
                                           val_metrics_every_epoch=1,
                                           feg_every_epoch=2,
                                           n_batches_for_feg=50),
                       verbose=True, display_filters=24,
                       display_hidden_activations=36, v_shape=(32, 32, 3),
                       random_seed=args.random_seed[0], dtype='float32',
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
    epochs = args.epochs[1]
    n_every = args.increase_n_gibbs_steps_every
    n_steps = max(1, epochs // n_every)
    n_gibbs_steps = np.arange(args.n_gibbs_steps[1],
                              args.n_gibbs_steps[1] + n_steps)
    learning_rate = args.lr[1] / np.arange(1, 1 + n_steps)
    n_gibbs_steps = np.repeat(n_gibbs_steps, n_every)
    learning_rate = np.repeat(learning_rate, n_every)

    mrbm = MultinomialRBM(n_visible=args.n_small_hidden * 26,
                          n_hidden=args.n_hiddens[0],
                          n_samples=args.n_hiddens[0],
                          W_init=0.001, hb_init=0., vb_init=0.,
                          n_gibbs_steps=n_gibbs_steps,
                          learning_rate=learning_rate,
                          momentum=np.geomspace(0.5, 0.9, 8),
                          max_epoch=max(args.epochs[1], n_every),
                          batch_size=args.batch_size[1],
                          l2=args.l2[1],
                          sample_h_states=True, sample_v_states=True,
                          sparsity_target=0.2, sparsity_cost=1e-4,
                          dbm_last=True,
                          metrics_config=dict(msre=True, pll=True, feg=True,
                                              train_metrics_every_iter=1000,
                                              val_metrics_every_epoch=2,
                                              feg_every_epoch=2,
                                              n_batches_for_feg=50),
                          verbose=True, display_hidden_activations=100,
                          random_seed=args.random_seed[1], dtype='float32',
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
              learning_rate=np.geomspace(args.lr[2], 1e-6, args.epochs[2]),
              momentum=np.geomspace(0.5, 0.9, 10),
              max_epoch=args.epochs[2],
              batch_size=args.batch_size[2],
              l2=args.l2[2],
              max_norm=args.max_norm,
              sample_v_states=True, sample_h_states=(True, True),
              sparsity_target=args.sparsity_target,
              sparsity_cost=args.sparsity_cost,
              sparsity_damping=args.sparsity_damping,
              train_metrics_every_iter=1000,
              val_metrics_every_epoch=2,
              random_seed=args.random_seed[2],
              verbose=True, display_filters=12, display_particles=36,
              v_shape=(32, 32, 3), dtype='float32',
              checkpoint_every_epoch=args.checkpoint_every,
              summaries_every_epoch=args.summaries_every,
              device=args.device, model_path=args.dbm_dirpath)
    dbm.fit(X_train, X_val)
    return dbm


def make_mlp(train, val, test, weights, args):
    X_train, y_train = train
    X_val, y_val = val
    X_test, y_test = test
    W, hb = weights

    layer = dict(units=args.n_small_hidden * 26, activation='relu',
                 batch_norm=True, dropout=args.mlp_dropout,
                 lr_multiplier=args.mlp_lrm[0])
    if W is not None and hb is not None:
        layer['weights'] = (W, hb)

    mlp = MLPClassifier(n_inputs=3 * 32 * 32, layers=[layer], n_classes=10,
                        l2=args.mlp_l2, learning_rate=0.001,
                        max_epoch=args.mlp_epochs,
                        batch_size=args.mlp_batch_size,
                        val_metric=args.mlp_val_metric,
                        early_stopping_patience=6, reduce_lr_patience=3,
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


def main():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--n-train', type=int, default=49000)
    parser.add_argument('--n-val', type=int, default=1000)
    parser.add_argument('--data-path', type=str, default=None,
                        help='data root (default: BMT_DATA_DIR or repo data/)')
    parser.add_argument('--no-aug', action='store_true')
    parser.add_argument('--small-lr', type=float, default=1e-3, nargs='+')
    parser.add_argument('--small-epochs', type=int, default=100)
    parser.add_argument('--small-batch-size', type=int, default=48)
    parser.add_argument('--small-l2', type=float, default=1e-3)
    parser.add_argument('--small-sparsity-target', type=float, default=0.1)
    parser.add_argument('--small-sparsity-cost', type=float, default=1e-3)
    parser.add_argument('--small-random-seed', type=int, default=9000)
    parser.add_argument('--n-small-hidden', type=int, default=300,
                        help='hidden units of each small patch RBM (the '
                             'G-RBM has 26 times as many)')
    parser.add_argument('--small-dirpath-prefix', type=str,
                        default='../models/rbm_cifar_small_')
    parser.add_argument('--increase-n-gibbs-steps-every', type=int, default=16)
    parser.add_argument('--n-hiddens', type=int, default=(512,), nargs='+',
                        help="the M-RBM's width (and n_samples)")
    parser.add_argument('--n-gibbs-steps', type=int, default=(1, 1, 1), nargs='+')
    parser.add_argument('--lr', type=float, default=(5e-4, 5e-5, 4e-5), nargs='+')
    parser.add_argument('--epochs', type=int, default=(64, 33, 100), nargs='+')
    parser.add_argument('--batch-size', type=int, default=(100, 100, 100), nargs='+')
    parser.add_argument('--l2', type=float, default=(1e-3, 0.005, 0.), nargs='+')
    parser.add_argument('--random-seed', type=int, default=(1111, 2222, 3333), nargs='+')
    parser.add_argument('--grbm-dirpath', type=str, default='../models/grbm_cifar/')
    parser.add_argument('--mrbm-dirpath', type=str, default='../models/mrbm_cifar/')
    parser.add_argument('--dbm-dirpath', type=str, default='../models/dbm_cifar/')
    parser.add_argument('--n-particles', type=int, default=100)
    parser.add_argument('--max-mf-updates', type=int, default=50)
    parser.add_argument('--mf-tol', type=float, default=1e-11)
    parser.add_argument('--max-norm', type=float, default=4.)
    parser.add_argument('--sparsity-target', type=float, default=(0.2, 0.2), nargs='+')
    parser.add_argument('--sparsity-cost', type=float, default=(1e-4, 1e-3), nargs='+')
    parser.add_argument('--sparsity-damping', type=float, default=0.9)
    parser.add_argument('--checkpoint-every', type=int, default=1,
                        help='save a checkpoint every N epochs (final state '
                             'is always saved); raise on slow device links')
    parser.add_argument('--summaries-every', type=int, default=1,
                        help='write histogram/image summaries every N epochs')
    parser.add_argument('--mlp-no-init', action='store_true')
    parser.add_argument('--mlp-l2', type=float, default=1e-4)
    parser.add_argument('--mlp-lrm', type=float, default=(0.01, 1.), nargs='+')
    parser.add_argument('--mlp-epochs', type=int, default=100)
    parser.add_argument('--mlp-val-metric', type=str, default='val_acc')
    parser.add_argument('--mlp-batch-size', type=int, default=128)
    parser.add_argument('--mlp-dropout', type=float, default=0.7)
    parser.add_argument('--mlp-save-prefix', type=str, default='../data/grbm_')
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
    # the end -- the composite's end-to-end record (the reference reports
    # 1 d 13 h 8 m, its examples/dbm_cifar.py:15-16)
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

    if not args.no_aug:
        X_train, y_train = make_augmentation(X_train, y_train, len(X_train),
                                             args)
        _stage_done('x10 augmentation')

    # center using the (augmented) training mean.  The augmented X_train
    # is a fresh array, so center it in place (skips a 6 GB copy); the
    # --no-aug X_train is a VIEW of the loaded buffer that may overlap
    # X_val (both slice the same array), so that path must copy.
    X_mean = X_train.mean(axis=0)
    if args.no_aug:
        X_train_c = X_train - X_mean
    else:
        X_train -= X_mean
        X_train_c = X_train
    X_val_c = X_val - X_mean
    X_test_c = X_test - X_mean

    small_rbms = make_small_rbms(X_train_c, X_val_c, args)
    _stage_done('26 small patch RBMs')

    grbm = make_grbm(X_train_c, X_val_c, small_rbms, args)
    _stage_done('quilt + G-RBM')

    print('\nExtracting G-RBM features ...\n')
    Q_train = make_rbm_transform(grbm, X_train_c,
                                 os.path.join(args.data_path, 'Q_train_cifar.npy'),
                                 np_dtype=np.float16)
    Q_val = make_rbm_transform(grbm, X_val_c,
                               os.path.join(args.data_path, 'Q_val_cifar.npy'),
                               np_dtype=np.float16)
    _stage_done('G-RBM features')

    # the f16 feature matrices go to fit/transform uncast: the RBM widens
    # them to f32 (exactly) as it stages them, so no caller keeps an extra
    # 2x-sized copy (at 490k x 7800 each `astype` is 15.3 GB)
    mrbm = make_mrbm(Q_train, Q_val, args)
    _stage_done('M-RBM')

    print('\nExtracting M-RBM features ...\n')
    G_train = make_rbm_transform(mrbm, Q_train,
                                 os.path.join(args.data_path, 'G_train_cifar.npy'))
    _stage_done('M-RBM features')

    make_dbm((X_train_c, X_val_c), (grbm, mrbm),
             (Q_train[:args.n_particles].astype(np.float32), G_train), args)
    _stage_done('3-layer DBM')

    print('\nDiscriminative fine-tuning ...\n')
    W = hb = None
    if not args.mlp_no_init:
        weights = grbm.get_params_arrays(scope='weights')
        W, hb = weights['W'], weights['hb']
    make_mlp((X_train_c, y_train), (X_val_c, y_val), (X_test_c, y_test),
             (W, hb), args)
    _stage_done('MLP fine-tune')

    print('\n[stage] composite end-to-end: %.1f s (%.1f min)\n'
          % (_time.monotonic() - _t0, (_time.monotonic() - _t0) / 60.))
    for name, secs in _stages:
        print('[stage]   %-28s %8.1f s' % (name, secs))


if __name__ == '__main__':
    main()
