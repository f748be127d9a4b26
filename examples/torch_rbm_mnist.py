#!/usr/bin/env python
"""
Train a Bernoulli-Bernoulli RBM on MNIST and use it for classification,
with the PyTorch/CUDA package (boltzmann_machines_tpu_torch) on one GPU.

The counterpart of examples/rbm_mnist.py (reference
examples/rbm_mnist.py:42-241), line for line: same pipeline
(CD-1 RBM with momentum warmup and logit-mean visible biases, then a
784-1024-10 sigmoid MLP warm-started from (W, hb) and fine-tuned with
per-layer Adam learning rates + early stopping), same stage caching by
model-directory existence.

Reference results to match (README.md:155-175): 1.27% test error after
fine-tuning; val PLL ~ -0.017 after 110 epochs.

Runs on the card; ``--device cpu`` runs it on the CPU (e.g. a cut-size
smoke run on a machine without one):

    python examples/torch_rbm_mnist.py --device cpu --n-train 300 \
        --n-val 100 --n-hidden 32 --epochs 1 --mlp-epochs 1
"""

import argparse
import os

import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from boltzmann_machines_tpu_torch import BernoulliRBM, logit_mean
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
        print('MNIST files not found under {0}; using synthetic stand-in '
              'data (fetch the real dataset for paper numbers)'.format(args.data_path))
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
    return (X[:n_train], y[:n_train], X[-n_val:], y[-n_val:],
            X_test, y_test)


def make_rbm(X_train, X_val, args):
    if stage_cached(args.model_dirpath):
        print('\nLoading model ...\n')
        rbm = finish_stage(BernoulliRBM.load_model(args.model_dirpath,
                                                   device=args.device),
                           lambda: (X_train, X_val))
    else:
        print('\nTraining model ...\n')
        rbm = BernoulliRBM(n_visible=784,
                           n_hidden=args.n_hidden,
                           W_init=args.w_init,
                           vb_init=logit_mean(X_train) if args.vb_init else 0.,
                           hb_init=args.hb_init,
                           n_gibbs_steps=args.n_gibbs_steps,
                           learning_rate=args.lr,
                           momentum=np.geomspace(0.5, 0.9, 8),
                           max_epoch=args.epochs,
                           batch_size=args.batch_size,
                           l2=args.l2,
                           sample_v_states=args.sample_v_states,
                           sample_h_states=True,
                           dropout=args.dropout,
                           sparsity_target=args.sparsity_target,
                           sparsity_cost=args.sparsity_cost,
                           sparsity_damping=args.sparsity_damping,
                           metrics_config=dict(
                               msre=True,
                               pll=True,
                               feg=True,
                               train_metrics_every_iter=1000,
                               val_metrics_every_epoch=2,
                               feg_every_epoch=4,
                               n_batches_for_feg=50,
                           ),
                           verbose=True,
                           checkpoint_every_epoch=args.checkpoint_every,
                           summaries_every_epoch=args.summaries_every,
                           display_filters=30,
                           display_hidden_activations=24,
                           v_shape=(28, 28),
                           random_seed=args.random_seed,
                           dtype=args.dtype,
                           device=args.device,
                           model_path=args.model_dirpath)
        rbm.fit(X_train, X_val)
    return rbm


def make_mlp(train, val, test, weights, args):
    X_train, y_train = train
    X_val, y_val = val
    X_test, y_test = test
    W, hb = weights

    layer = dict(units=args.n_hidden, activation='sigmoid',
                 lr_multiplier=args.mlp_lrm[0])
    if W is not None and hb is not None:
        layer['weights'] = (W, hb)

    mlp = MLPClassifier(n_inputs=784, layers=[layer], n_classes=10,
                        l2=args.mlp_l2, learning_rate=0.001,
                        max_epoch=args.mlp_epochs,
                        batch_size=args.mlp_batch_size,
                        val_metric=args.mlp_val_metric,
                        random_seed=1111, verbose=True,
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
    W_finetuned, _ = mlp.get_weights(0)
    np.save(args.mlp_save_prefix + 'W_finetuned.npy', W_finetuned)


def main():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('--n-train', type=int, default=55000)
    parser.add_argument('--n-val', type=int, default=5000)
    parser.add_argument('--data-path', type=str, default=None,
                        help='data root (default: BMT_DATA_DIR or repo data/)')
    parser.add_argument('--n-hidden', type=int, default=1024)
    parser.add_argument('--w-init', type=float, default=0.01)
    parser.add_argument('--vb-init', action='store_false')
    parser.add_argument('--hb-init', type=float, default=0.)
    parser.add_argument('--n-gibbs-steps', type=int, default=1, nargs='+')
    parser.add_argument('--lr', type=float, default=0.05, nargs='+')
    parser.add_argument('--epochs', type=int, default=120)
    parser.add_argument('--batch-size', type=int, default=10)
    parser.add_argument('--l2', type=float, default=1e-5)
    parser.add_argument('--sample-v-states', action='store_true')
    parser.add_argument('--dropout', type=float, default=None)
    parser.add_argument('--sparsity-target', type=float, default=0.1)
    parser.add_argument('--sparsity-cost', type=float, default=1e-5)
    parser.add_argument('--sparsity-damping', type=float, default=0.9)
    parser.add_argument('--random-seed', type=int, default=1337)
    parser.add_argument('--dtype', type=str, default='float32')
    parser.add_argument('--checkpoint-every', type=int, default=1,
                        help='save a checkpoint every N epochs (final state '
                             'is always saved)')
    parser.add_argument('--summaries-every', type=int, default=1,
                        help='write histogram/image summaries every N epochs')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device of every stage ('cpu' only when "
                             "asked for)")
    parser.add_argument('--model-dirpath', type=str,
                        default='../models/rbm_mnist/')
    parser.add_argument('--mlp-no-init', action='store_true')
    parser.add_argument('--mlp-l2', type=float, default=1e-5)
    parser.add_argument('--mlp-lrm', type=float, default=(0.1,), nargs='+')
    parser.add_argument('--mlp-epochs', type=int, default=100)
    parser.add_argument('--mlp-val-metric', type=str, default='val_acc')
    parser.add_argument('--mlp-batch-size', type=int, default=128)
    parser.add_argument('--mlp-save-prefix', type=str, default='../data/rbm_')
    args = parser.parse_args()

    print('\nPreparing data ...\n')
    X_train, y_train, X_val, y_val, X_test, y_test = load_data(args)

    rbm = make_rbm(X_train, X_val, args)

    print('\nDiscriminative fine-tuning ...\n')
    W, hb = None, None
    if not args.mlp_no_init:
        weights = rbm.get_params_arrays(scope='weights')
        W, hb = weights['W'], weights['hb']
    make_mlp((X_train, y_train), (X_val, y_val), (X_test, y_test),
             (W, hb), args)


if __name__ == '__main__':
    main()
