"""Warm-start against random-init accuracy of the fine-tuning MLP, over MLP
seeds, for the port and the JAX package, on sklearn's bundled digits.

    JAX_PLATFORMS=cpu python tools/torch_digits_seeds.py [N_SEEDS]

Trains the port's BernoulliRBM of tests/test_torch_real_digits.py (64 x
256, 600 epochs, on the CPU), then for MLP seeds 1..N_SEEDS (default 6)
fine-tunes each package's MLPClassifier from that RBM's (W, hb) and from
random init, on the labelled subsets of tests/test_real_digits.py, and
prints the test accuracies: how far one seed's verdict is from the spread
of the two packages' MLPs on the same RBM."""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

from sklearn.datasets import load_digits  # noqa: E402
from sklearn.model_selection import train_test_split  # noqa: E402

from boltzmann_machines_tpu.finetune import MLPClassifier as JaxMLP  # noqa
from boltzmann_machines_tpu_torch import BernoulliRBM  # noqa: E402
from boltzmann_machines_tpu_torch.finetune import MLPClassifier  # noqa


def main(n_seeds=6):
    with tempfile.TemporaryDirectory() as tmp:
        run(n_seeds, tmp + '/')


def run(n_seeds, tmp):
    d = load_digits()
    X = ((d.data / 16.) > 0.5).astype('float32')
    X_train, X_test, y_train, y_test = train_test_split(
        X, d.target, test_size=360, random_state=1337, stratify=d.target)
    rbm = BernoulliRBM(
        n_visible=64, n_hidden=256, n_gibbs_steps=1, learning_rate=0.05,
        momentum=list(np.geomspace(0.5, 0.9, 8)), max_epoch=600,
        batch_size=32, l2=1e-4, sparsity_target=0.1, sparsity_cost=1e-4,
        random_seed=1337, verbose=False, save_after_each_epoch=False,
        device='cpu', model_path=tmp)
    rbm.fit(X_train[:1408])
    w = rbm.get_params_arrays('weights')

    def split(n_labels):
        if n_labels >= len(X_train):
            Xs, ys = X_train, y_train
        else:
            Xs, _, ys, _ = train_test_split(
                X_train, y_train, train_size=n_labels, random_state=11,
                stratify=y_train)
        n_val = max(n_labels // 5, 20)
        return train_test_split(Xs, ys, test_size=n_val, random_state=7,
                                stratify=ys)

    cases = [('all labels, multiplier 0.01', len(X_train), 64, 0.01),
             ('320 labels, multiplier 0.01', 320, 32, 0.01),
             ('128 labels, multiplier 0.01', 128, 16, 0.01)]
    Xt, Xv, yt, yv = train_test_split(X_train, y_train, test_size=160,
                                      random_state=7, stratify=y_train)
    for label, n_labels, batch_size, mult in cases + [
            ('160 held out, multiplier 0.1', None, 64, 0.1)]:
        Xt_, Xv_, yt_, yv_ = (Xt, Xv, yt, yv) if n_labels is None \
            else split(n_labels)
        for pkg, cls, kw in (('port', MLPClassifier, dict(device='cpu')),
                             ('jax', JaxMLP, {})):
            row = {}
            for warm in (True, False):
                accs = []
                for seed in range(1, n_seeds + 1):
                    layers = [dict(units=256, activation='sigmoid',
                                   weights=(w['W'], w['hb']) if warm
                                   else None,
                                   lr_multiplier=mult if warm else 1.)]
                    mlp = cls(n_inputs=64, layers=layers, n_classes=10,
                              max_epoch=100, batch_size=batch_size,
                              random_seed=seed, verbose=False, **kw)
                    mlp.fit(Xt_, yt_, Xv_, yv_)
                    accs.append(float((mlp.predict(X_test) ==
                                       y_test).mean()))
                row['warm' if warm else 'cold'] = accs
            print('%s, %s: warm %s (mean %.4f); cold %s (mean %.4f)' % (
                label, pkg, ' '.join('%.4f' % a for a in row['warm']),
                np.mean(row['warm']),
                ' '.join('%.4f' % a for a in row['cold']),
                np.mean(row['cold'])), flush=True)


if __name__ == '__main__':
    main(*map(int, sys.argv[1:]))
