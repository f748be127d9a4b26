#!/usr/bin/env python
"""
2-layer DBM on MNIST: greedy RBM pretraining -> joint PCD + mean-field
training -> AIS log Z / ELBO -> discriminative fine-tuning, with the
PyTorch/CUDA package (boltzmann_machines_tpu_torch) on one GPU.

The counterpart of examples/dbm_mnist.py (reference
examples/dbm_mnist.py:47-378), line for line; same cached
multi-stage pipeline (each stage skipped when its model directory exists)
and the same hyperparameters: RBM#1 784->512 (dbm_first, CD-1), RBM#2
512->1024 (dbm_last, stepped CD-k up / lr down schedule), 100 persistent
particles initialized from data / transforms, lr geomspace -> 5e-6, max-norm
6, up to 50 MF updates per step.

Reference results to match (README.md:190-225): AIS log Z ~ 1040.39 (200k
betas), test ELBO ~ -86.37, fine-tuned test error 1.32%.

AIS runs the linear beta ladder.  Runs on the card; ``--device cpu`` runs
it on the CPU (e.g. a cut-size smoke run on a machine without one):

    python examples/torch_dbm_mnist.py --device cpu --n-train 300 \
        --n-val 100 --n-hiddens 32 24 --epochs 1 1 1 \
        --increase-n-gibbs-steps-every 1 --mlp-epochs 1 \
        --n-betas 50 --n-ais-runs 8
"""

import argparse
import os

import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from boltzmann_machines_tpu_torch import BernoulliRBM, DBM
from boltzmann_machines_tpu_torch.finetune import MLPClassifier
from boltzmann_machines_tpu_torch.utils import RNG, Stopwatch, one_hot_decision_function, unhot
from boltzmann_machines_tpu_torch.utils.dataset import load_mnist, make_synthetic_mnist


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
        X, y = load_mnist(mode='train', path=args.data_path)
        X_test, y_test = load_mnist(mode='test', path=args.data_path)
    except (IOError, OSError):
        print('MNIST files not found; using synthetic stand-in data')
        # honor --n-train/--n-val so wall-clocks stay comparable
        # with the reference's full-dataset scale
        X, y = make_synthetic_mnist(args.n_train + args.n_val)
        X_test, y_test = make_synthetic_mnist(2048, seed=7)
    X = X / 255.
    X_test = X_test / 255.
    RNG(seed=42).shuffle(X)
    RNG(seed=42).shuffle(y)
    n_train = min(len(X), args.n_train)
    n_val = min(len(X), args.n_val)
    return (X[:n_train], y[:n_train], X[-n_val:], y[-n_val:], X_test, y_test)


def make_rbm1(X, args):
    if stage_cached(args.rbm1_dirpath):
        print('\nLoading RBM #1 ...\n')
        return finish_stage(BernoulliRBM.load_model(args.rbm1_dirpath,
                                                    device=args.device),
                            lambda: (X,))
    print('\nTraining RBM #1 ...\n')
    rbm1 = BernoulliRBM(n_visible=784, n_hidden=args.n_hiddens[0],
                        W_init=0.001, vb_init=0., hb_init=0.,
                        n_gibbs_steps=args.n_gibbs_steps[0],
                        learning_rate=args.lr[0],
                        momentum=[0.5] * 5 + [0.9],
                        max_epoch=args.epochs[0],
                        batch_size=args.batch_size[0],
                        l2=args.l2[0],
                        sample_h_states=True, sample_v_states=True,
                        sparsity_cost=0.,
                        dbm_first=True,
                        metrics_config=dict(msre=True, pll=True,
                                            train_metrics_every_iter=500),
                        verbose=True,
                        checkpoint_every_epoch=args.checkpoint_every,
                        summaries_every_epoch=args.summaries_every,
                        display_filters=30,
                        display_hidden_activations=24, v_shape=(28, 28),
                        random_seed=args.random_seed[0], dtype='float32',
                        device=args.device, model_path=args.rbm1_dirpath)
    rbm1.fit(X)
    return rbm1


def make_rbm2(Q, args):
    if stage_cached(args.rbm2_dirpath):
        print('\nLoading RBM #2 ...\n')
        return finish_stage(BernoulliRBM.load_model(args.rbm2_dirpath,
                                                    device=args.device),
                            lambda: (Q,))
    print('\nTraining RBM #2 ...\n')
    epochs = args.epochs[1]
    n_every = args.increase_n_gibbs_steps_every
    n_steps = max(1, epochs // n_every)
    n_gibbs_steps = np.arange(args.n_gibbs_steps[1],
                              args.n_gibbs_steps[1] + n_steps)
    learning_rate = args.lr[1] / np.arange(1, 1 + n_steps)
    n_gibbs_steps = np.repeat(n_gibbs_steps, n_every)
    learning_rate = np.repeat(learning_rate, n_every)

    rbm2 = BernoulliRBM(n_visible=args.n_hiddens[0],
                        n_hidden=args.n_hiddens[1],
                        W_init=0.005, vb_init=0., hb_init=0.,
                        n_gibbs_steps=n_gibbs_steps,
                        learning_rate=learning_rate,
                        momentum=[0.5] * 5 + [0.9],
                        max_epoch=max(args.epochs[1], n_every),
                        batch_size=args.batch_size[1],
                        l2=args.l2[1],
                        sample_h_states=True, sample_v_states=True,
                        sparsity_cost=0.,
                        dbm_last=True,
                        metrics_config=dict(msre=True, pll=True,
                                            train_metrics_every_iter=500),
                        verbose=True,
                        checkpoint_every_epoch=args.checkpoint_every,
                        summaries_every_epoch=args.summaries_every,
                        display_hidden_activations=24,
                        random_seed=args.random_seed[1], dtype='float32',
                        device=args.device, model_path=args.rbm2_dirpath)
    rbm2.fit(Q)
    return rbm2


def make_dbm(data, rbms, transforms, args):
    X_train, X_val = data
    Q, G = transforms
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
              learning_rate=np.geomspace(args.lr[2], 5e-6, 400),
              momentum=np.geomspace(0.5, 0.9, 10),
              max_epoch=args.epochs[2],
              batch_size=args.batch_size[2],
              l2=args.l2[2],
              max_norm=args.max_norm,
              sample_v_states=True,
              sample_h_states=(True, True),
              sparsity_target=args.sparsity_target,
              sparsity_cost=args.sparsity_cost,
              sparsity_damping=args.sparsity_damping,
              train_metrics_every_iter=400,
              val_metrics_every_epoch=2,
              random_seed=args.random_seed[2],
              verbose=True,
              checkpoint_every_epoch=args.checkpoint_every,
              summaries_every_epoch=args.summaries_every,
              display_filters=10, display_particles=20,
              v_shape=(28, 28), dtype='float32',
              device=args.device, model_path=args.dbm_dirpath)
    dbm.fit(X_train, X_val)
    return dbm


def make_mlp(train, val, test, w1, w2, args):
    X_train, y_train = train
    X_val, y_val = val
    X_test, y_test = test
    (W, hb), (W2, hb2) = w1, w2

    layers = [dict(units=args.n_hiddens[0], activation='sigmoid',
                   lr_multiplier=args.mlp_lrm[0]),
              dict(units=args.n_hiddens[1], activation='sigmoid',
                   lr_multiplier=args.mlp_lrm[1])]
    if W is not None:
        layers[0]['weights'] = (W, hb)
    if W2 is not None:
        layers[1]['weights'] = (W2, hb2)

    mlp = MLPClassifier(n_inputs=784, layers=layers, n_classes=10,
                        l2=args.mlp_l2, learning_rate=0.001,
                        max_epoch=args.mlp_epochs,
                        batch_size=args.mlp_batch_size,
                        val_metric=args.mlp_val_metric,
                        random_seed=3333, verbose=True,
                        device=args.device)
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
    np.save(args.mlp_save_prefix + 'W1_finetuned.npy', mlp.get_weights(0)[0])
    np.save(args.mlp_save_prefix + 'W2_finetuned.npy', mlp.get_weights(1)[0])


def main():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--n-train', type=int, default=59000)
    parser.add_argument('--n-val', type=int, default=1000)
    parser.add_argument('--data-path', type=str, default=None,
                        help='data root (default: BMT_DATA_DIR or repo data/)')
    parser.add_argument('--increase-n-gibbs-steps-every', type=int, default=20)
    parser.add_argument('--n-hiddens', type=int, default=(512, 1024), nargs='+')
    parser.add_argument('--n-gibbs-steps', type=int, default=(1, 1, 1), nargs='+')
    parser.add_argument('--lr', type=float, default=(0.05, 0.01, 2e-3), nargs='+')
    parser.add_argument('--epochs', type=int, default=(64, 120, 500), nargs='+')
    parser.add_argument('--batch-size', type=int, default=(48, 48, 100), nargs='+')
    parser.add_argument('--l2', type=float, default=(1e-3, 2e-4, 1e-7), nargs='+')
    parser.add_argument('--random-seed', type=int, default=(1337, 1111, 2222), nargs='+')
    parser.add_argument('--checkpoint-every', type=int, default=1,
                        help='save a checkpoint every N epochs (final '
                             'state always saved)')
    parser.add_argument('--summaries-every', type=int, default=1,
                        help='write histogram/image summaries every N epochs')
    parser.add_argument('--rbm1-dirpath', type=str, default='../models/dbm_mnist_rbm1/')
    parser.add_argument('--rbm2-dirpath', type=str, default='../models/dbm_mnist_rbm2/')
    parser.add_argument('--dbm-dirpath', type=str, default='../models/dbm_mnist/')
    parser.add_argument('--n-particles', type=int, default=100)
    parser.add_argument('--max-mf-updates', type=int, default=50)
    parser.add_argument('--mf-tol', type=float, default=1e-7)
    parser.add_argument('--max-norm', type=float, default=6.)
    parser.add_argument('--sparsity-target', type=float, default=(0.2, 0.1), nargs='+')
    parser.add_argument('--sparsity-cost', type=float, default=(1e-4, 5e-5), nargs='+')
    parser.add_argument('--sparsity-damping', type=float, default=0.9)
    parser.add_argument('--n-betas', type=int, default=20000,
                        help='number of AIS intermediate distributions (0 to skip)')
    parser.add_argument('--n-ais-runs', type=int, default=100)
    parser.add_argument('--ais-save-path', type=str, default=None,
                        help='npz path for {log_Z, log_low, log_high, '
                             'avg_test_elbo} (quality-parity gate hook)')
    parser.add_argument('--mlp-no-init', action='store_true')
    parser.add_argument('--mlp-l2', type=float, default=1e-5)
    parser.add_argument('--mlp-lrm', type=float, default=(0.01, 0.1, 1.), nargs='+')
    parser.add_argument('--mlp-epochs', type=int, default=100)
    parser.add_argument('--mlp-val-metric', type=str, default='val_acc')
    parser.add_argument('--mlp-batch-size', type=int, default=128)
    parser.add_argument('--mlp-save-prefix', type=str, default='../data/dbm_')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device of every stage ('cpu' only when "
                             "asked for)")
    args = parser.parse_args()

    # broadcast length-1 list args (reference dbm_mnist.py:305-317)
    for name in ('n_gibbs_steps', 'lr', 'epochs', 'batch_size', 'l2',
                 'random_seed'):
        val = getattr(args, name)
        if isinstance(val, (list, tuple)) and len(val) == 1:
            setattr(args, name, list(val) * 3)

    print('\nPreparing data ...\n')
    X_train, y_train, X_val, y_val, X_test, y_test = load_data(args)

    rbm1 = make_rbm1(X_train, args)
    Q = rbm1.transform(X_train).astype('float32')
    rbm2 = make_rbm2(Q, args)
    G = rbm2.transform(Q).astype('float32')

    dbm = make_dbm((X_train, X_val), (rbm1, rbm2), (Q, G), args)

    if args.n_betas > 0:
        print('\nEstimating log Z by AIS ...\n')
        with Stopwatch(verbose=True):
            log_mean, (log_low, log_high), _ = dbm.log_Z(
                n_betas=args.n_betas, n_runs=args.n_ais_runs)
        print('log Z = {0:.2f}  [{1:.2f}, {2:.2f}]'.format(
            log_mean, log_low, log_high))
        elbo = dbm.log_proba(X_test, log_mean)
        print('average test ELBO = {0:.2f}'.format(float(elbo.mean())))
        if args.ais_save_path:
            os.makedirs(os.path.dirname(args.ais_save_path) or '.',
                        exist_ok=True)
            np.savez(args.ais_save_path, log_Z=log_mean,
                     log_low=log_low, log_high=log_high,
                     avg_test_elbo=float(elbo.mean()))

    print('\nDiscriminative fine-tuning ...\n')
    W = hb = W2 = hb2 = None
    if not args.mlp_no_init:
        weights = dbm.get_params_arrays(scope='weights')
        W, hb = weights['W_0'], weights['hb_0']
        W2, hb2 = weights['W_1'], weights['hb_1']
    make_mlp((X_train, y_train), (X_val, y_val), (X_test, y_test),
             (W, hb), (W2, hb2), args)


if __name__ == '__main__':
    main()
