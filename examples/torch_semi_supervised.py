#!/usr/bin/env python
"""Semi-supervised experiment runner: reproduce the reference's
labeled-subset tables (reference README.md:170-175 for the RBM,
README.md:214-219 for the DBM) with one command, with the PyTorch/CUDA
package (boltzmann_machines_tpu_torch) on one GPU.

The counterpart of examples/semi_supervised.py: the same subsets, recipes,
arguments and markdown table; the generative stages are those of
examples/torch_rbm_mnist.py and torch_dbm_mnist.py.  Runs on the card;
``--device cpu`` runs it on the CPU.

The idea (reference README.md:168): pretrain the generative model on the
full unlabeled corpus, then fine-tune a classifier on shrinking labeled
subsets, warm-started from the generative weights vs. randomly
initialized.  The per-subset MLP hyperparameters follow the reference's
reproduction recipes (reference docs/rbm_discriminative.md,
docs/dbm_discriminative.md): smaller batches for the small subsets,
val_loss early-stopping + more epochs at 100 labels, first-layer lr
multiplier 0.1 (full) / 0.01 (subsets) when warm-started and 1.0 when
trained from scratch.

Emits the README-style markdown table on stdout and to --out.

Usage:
    python torch_semi_supervised.py              # RBM table (4 x {warm, cold})
    python torch_semi_supervised.py --model dbm  # DBM table
    python torch_semi_supervised.py --quick      # tiny smoke (CI)

Real MNIST is picked up automatically from --data-path / $BMT_DATA_DIR /
data/; otherwise a synthetic stand-in is used (numbers then demonstrate
the machinery + the warm-start gain direction, not the published values).
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from boltzmann_machines_tpu_torch.finetune import MLPClassifier
from boltzmann_machines_tpu_torch.utils import (RNG, Stopwatch,
                                                one_hot_decision_function,
                                                unhot)
from boltzmann_machines_tpu_torch.utils.dataset import load_mnist, \
    make_synthetic_mnist


# per-subset MLP configs: (label, n_train, n_val, batch_size, val_metric,
# max_epoch, warm first-layer lrm) -- reference docs/rbm_discriminative.md
SUBSETS = [
    ('60k (55k + 5k)', 55000, 5000, 128, 'val_acc', 100, 0.1),
    ('10k (9k + 1k)', 9000, 1000, 128, 'val_acc', 100, 0.01),
    ('1k (900 + 100)', 900, 100, 32, 'val_acc', 100, 0.01),
    ('100 (90 + 10)', 90, 10, 32, 'val_loss', 1000, 0.01),
]


def load_data(args):
    try:
        X, y = load_mnist(mode='train', path=args.data_path)
        X_test, y_test = load_mnist(mode='test', path=args.data_path)
        real = True
    except (IOError, OSError):
        print('MNIST not found; using synthetic stand-in data '
              '(table shape + machinery only, not the published numbers)')
        n = 4096 if args.quick else 60000
        X, y = make_synthetic_mnist(n)
        X_test, y_test = make_synthetic_mnist(2048, seed=7)
        real = False
    X = np.asarray(X, np.float32) / 255.
    X_test = np.asarray(X_test, np.float32) / 255.
    RNG(seed=42).shuffle(X)
    RNG(seed=42).shuffle(y)
    return X, np.asarray(y), X_test, np.asarray(y_test), real


def pretrain_weights(X, args):
    """Train (or load the cached) generative model on the FULL training
    set and return the per-hidden-layer warm-start weights."""
    if args.model == 'rbm':
        import torch_rbm_mnist as rbm_mnist
        rbm_args = argparse.Namespace(
            n_hidden=args.n_hidden, w_init=0.01, vb_init=True, hb_init=0.,
            n_gibbs_steps=[1], lr=[0.05], epochs=args.epochs,
            batch_size=args.batch_size, l2=1e-5, sample_v_states=False,
            dropout=None, sparsity_target=0.1, sparsity_cost=1e-5,
            sparsity_damping=0.9, random_seed=1337, dtype='float32',
            checkpoint_every=max(args.epochs // 4, 1),
            summaries_every=max(args.epochs // 4, 1), device=args.device,
            model_dirpath=args.model_dirpath)
        rbm = rbm_mnist.make_rbm(X[:55000], X[-5000:], rbm_args)
        w = rbm.get_params_arrays(scope='weights')
        return [(w['W'], w['hb'])], [args.n_hidden]
    else:  # dbm: reuse the dbm_mnist pipeline stages
        import torch_dbm_mnist as dbm_mnist
        d = argparse.Namespace(
            increase_n_gibbs_steps_every=20, n_hiddens=args.n_hiddens,
            n_gibbs_steps=[1, 1, 1], lr=[0.05, 0.01, 2e-3],
            epochs=list(args.dbm_epochs), batch_size=[48, 48, 100],
            l2=[1e-3, 2e-4, 1e-7], random_seed=[1337, 1111, 2222],
            checkpoint_every=20, summaries_every=20,
            rbm1_dirpath=args.rbm1_dirpath, rbm2_dirpath=args.rbm2_dirpath,
            dbm_dirpath=args.dbm_dirpath, n_particles=100,
            max_mf_updates=50, mf_tol=1e-7, max_norm=6.,
            sparsity_target=[0.2, 0.1], sparsity_cost=[1e-4, 5e-5],
            sparsity_damping=0.9, device=args.device)
        rbm1 = dbm_mnist.make_rbm1(X[:55000], d)
        Q = rbm1.transform(X[:55000]).astype('float32')
        rbm2 = dbm_mnist.make_rbm2(Q, d)
        G = rbm2.transform(Q).astype('float32')
        dbm = dbm_mnist.make_dbm((X[:55000], X[-1000:]), (rbm1, rbm2),
                                 (Q, G), d)
        weights = dbm.get_params_arrays(scope='weights')
        return ([(weights['W_0'], weights['hb_0']),
                 (weights['W_1'], weights['hb_1'])], list(args.n_hiddens))


def finetune(X, y, X_test, y_test, weights, units, subset, warm, args):
    label, n_train, n_val, bs, val_metric, n_ep, warm_lrm = subset
    n_val = min(n_val, max(len(X) // 10, 1))
    n_train = min(n_train, len(X) - n_val)
    X_train, y_train = X[:n_train], y[:n_train]
    X_val, y_val = X[-n_val:], y[-n_val:]
    if args.quick:
        n_ep = 2

    layers = []
    for i, n_units in enumerate(units):
        # warm-start lr multipliers follow the reference recipes: first
        # hidden layer warm_lrm, each further hidden layer 10x more
        # (DBM: 0.01, 0.1; reference dbm_mnist.py --mlp-lrm default),
        # output layer 1.0; from-scratch runs use 1.0 everywhere
        layer = dict(units=n_units, activation='sigmoid',
                     lr_multiplier=min(warm_lrm * 10. ** i, 1.) if warm
                     else 1.)
        if warm:
            layer['weights'] = weights[i]
        layers.append(layer)

    mlp = MLPClassifier(n_inputs=784, layers=layers, n_classes=10,
                        l2=1e-5, learning_rate=0.001, max_epoch=n_ep,
                        batch_size=bs, val_metric=val_metric,
                        random_seed=1111, verbose=args.verbose,
                        device=args.device)
    mlp.fit(X_train, y_train, X_val, y_val)
    y_proba = mlp.predict_proba(X_test)
    y_pred = unhot(one_hot_decision_function(y_proba), n_classes=10)
    return float(np.mean(y_pred == y_test))


def main():
    ap = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument('--model', choices=('rbm', 'dbm'), default='rbm')
    ap.add_argument('--data-path', type=str, default=None)
    ap.add_argument('--subsets', type=int, nargs='+', default=None,
                    help='labeled-set sizes to run (default: all four)')
    ap.add_argument('--quick', action='store_true',
                    help='tiny epochs everywhere (CI smoke)')
    ap.add_argument('--verbose', action='store_true')
    ap.add_argument('--out', type=str, default='../data/semi_supervised.md')
    # rbm pretrain
    ap.add_argument('--n-hidden', type=int, default=1024)
    ap.add_argument('--epochs', type=int, default=120)
    ap.add_argument('--batch-size', type=int, default=100)
    ap.add_argument('--model-dirpath', type=str,
                    default='../models/rbm_mnist/')
    # dbm pretrain
    ap.add_argument('--n-hiddens', type=int, nargs='+', default=(512, 1024))
    ap.add_argument('--dbm-epochs', type=int, nargs='+',
                    default=(64, 120, 500))
    ap.add_argument('--rbm1-dirpath', type=str,
                    default='../models/dbm_mnist_rbm1/')
    ap.add_argument('--rbm2-dirpath', type=str,
                    default='../models/dbm_mnist_rbm2/')
    ap.add_argument('--dbm-dirpath', type=str,
                    default='../models/dbm_mnist/')
    ap.add_argument('--device', type=str, default='cuda',
                    help="torch device of every stage ('cpu' only when "
                         "asked for)")
    args = ap.parse_args()
    if args.quick:
        args.epochs = 2
        args.dbm_epochs = (2, 2, 2)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    X, y, X_test, y_test, real = load_data(args)
    print('\nPretraining {0} on the full unlabeled corpus ...\n'
          .format(args.model.upper()))
    weights, units = pretrain_weights(X, args)

    subsets = SUBSETS
    if args.subsets:
        subsets = [s for s in SUBSETS if s[1] + s[2] in args.subsets]

    rows = []
    for subset in subsets:
        total = subset[1] + subset[2]
        accs = {}
        for warm in (True, False):
            tag = 'fine-tuning' if warm else 'random init'
            print('== {0} labels, {1} =='.format(total, tag))
            with Stopwatch(verbose=True):
                accs[warm] = finetune(X, y, X_test, y_test, weights, units,
                                      subset, warm, args)
            print('   acc: {0:.4f}'.format(accs[warm]))
        rows.append((subset[0], accs[True], accs[False]))

    name = args.model.upper()
    lines = ['| number of labeled data pairs (train + val) | '
             '%s + fine-tuning | random initialization | gain |' % name,
             '| :---: | :---: | :---: | :---: |']
    for label, warm_acc, cold_acc in rows:
        lines.append('| %s | %.2f%% | %.2f%% | **%+.2f%%** |'
                     % (label, 100 * warm_acc, 100 * cold_acc,
                        100 * (warm_acc - cold_acc)))
    if not real:
        lines.append('')
        lines.append('*(synthetic stand-in data -- machinery check, '
                     'not the published numbers)*')
    table = '\n'.join(lines)
    print('\n' + table)
    out = os.path.join(os.path.dirname(__file__), args.out) \
        if not os.path.isabs(args.out) else args.out
    os.makedirs(os.path.dirname(out) or '.', exist_ok=True)
    with open(out, 'w') as f:
        f.write(table + '\n')
    with open(os.path.splitext(out)[0] + '.json', 'w') as f:
        json.dump({'model': args.model, 'real_data': real,
                   'rows': [{'subset': r[0], 'warm': r[1], 'cold': r[2]}
                            for r in rows]}, f, indent=2)
    print('\nwrote {0}'.format(out))


if __name__ == '__main__':
    main()
