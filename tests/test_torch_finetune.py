"""The port's fine-tuning MLP and multi_adam (boltzmann_machines_tpu_torch
.finetune, .utils.optimizers) against the JAX package's, on the CPU:
mirrors of tests/test_finetune.py, fits from one carried-over state
compared epoch by epoch, the plateau schedule, the optimizer against
optax's, and dropout by its statistics."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boltzmann_machines_tpu.finetune import MLPClassifier as JaxMLP
from boltzmann_machines_tpu.utils.optimizers import \
    multi_adam as jax_multi_adam
from boltzmann_machines_tpu_torch.convert import mlp_from_jax, mlp_to_jax
from boltzmann_machines_tpu_torch.finetune import MLPClassifier
from boltzmann_machines_tpu_torch.utils import RNG
from boltzmann_machines_tpu_torch.utils.optimizers import (
    multi_adam, multiplier_of, scale_by_multipliers, set_learning_rate)


@pytest.fixture(autouse=True)
def true_f32():
    # the parity below is in true f32 (no TF32 on a card that has it)
    torch.backends.cuda.matmul.allow_tf32 = False


def _toy_data(n=512, d=16, seed=0):
    rng = RNG(seed)
    X = rng.rand(n, d).astype('float32')
    w = rng.randn(d, 3)
    y = np.argmax(X @ w, axis=1)
    return X, y


# --------------------------------------------------------------------- #
# mirrors of tests/test_finetune.py                                      #
# --------------------------------------------------------------------- #
def test_mlp_learns_and_warm_start():
    X, y = _toy_data()
    mlp = MLPClassifier(16, [dict(units=8, activation='sigmoid')],
                        n_classes=3, max_epoch=30, batch_size=64,
                        early_stopping_patience=100, verbose=False,
                        random_seed=1, device='cpu')
    mlp.fit(X[:384], y[:384], X[384:], y[384:])
    assert mlp.score(X[384:], y[384:]) > 0.7

    # warm start from trained weights: the arrays come back unchanged
    W, b = mlp.get_weights(0)
    assert W.shape == (16, 8) and b.shape == (8,)
    mlp2 = MLPClassifier(16, [dict(units=8, activation='sigmoid',
                                   weights=(W, b))],
                         n_classes=3, max_epoch=1, batch_size=64,
                         verbose=False, random_seed=2, device='cpu')
    mlp2._init_params()
    np.testing.assert_array_equal(mlp2.get_weights(0)[0], W)
    np.testing.assert_array_equal(mlp2.get_weights(0)[1], b)


def test_mlp_bn_dropout_path():
    X, y = _toy_data()
    mlp = MLPClassifier(16, [dict(units=8, activation='relu',
                                  batch_norm=True, dropout=0.3)],
                        n_classes=3, max_epoch=10, batch_size=64,
                        verbose=False, random_seed=1, device='cpu')
    mlp.fit(X[:384], y[:384], X[384:], y[384:])
    proba = mlp.predict_proba(X[384:])
    np.testing.assert_allclose(proba.sum(1), 1., atol=1e-5)
    # deterministic at inference (dropout off)
    np.testing.assert_array_equal(proba, mlp.predict_proba(X[384:]))
    # the running stats moved off their init
    layer = mlp._net.dense[0]
    assert not torch.equal(layer.mean, torch.zeros_like(layer.mean))


def test_multi_adam_multipliers():
    params = {'dense_1': {'w': torch.ones(4, requires_grad=True)},
              'dense_2': {'w': torch.ones(4, requires_grad=True)}}
    opt = multi_adam(params, learning_rate=0.1,
                     lr_multipliers={'dense_1': 0.1})
    for d in params.values():
        d['w'].grad = torch.ones(4)
    opt.step()
    u1 = float(params['dense_1']['w'][0].detach()) - 1.
    u2 = float(params['dense_2']['w'][0].detach()) - 1.
    # same adam direction, 10x smaller step on dense_1
    assert abs(u1 * 10 - u2) < 1e-6
    assert u2 < 0  # descent
    assert sorted(g['lr_multiplier'] for g in opt.param_groups) == [0.1, 1.]


def test_multiplier_prefix_is_segment_bounded():
    mults = {'1': 0.5, 'dense/0': 0.1}
    assert multiplier_of('1/W', mults) == 0.5
    assert multiplier_of('1', mults) == 0.5
    assert multiplier_of('10/W', mults) == 1.
    assert multiplier_of('dense/0/b', mults) == 0.1
    assert multiplier_of('dense/01/b', mults) == 1.


# --------------------------------------------------------------------- #
# multi_adam against optax's                                             #
# --------------------------------------------------------------------- #
def test_multi_adam_matches_optax():
    """Three steps of the same gradients on nested params: every update
    within 1e-6 of the JAX package's multi_adam (optax scale_by_adam,
    float32 rounding in another order), and the '1' / '10' prefix rule."""
    rng = np.random.RandomState(0)
    shapes = {'1': {'W': (3, 4), 'b': (4,)}, '10': {'W': (4, 2)},
              'head': {'W': (2, 2)}}
    init = {k: {n: rng.randn(*s).astype(np.float32) for n, s in v.items()}
            for k, v in shapes.items()}
    grads = [{k: {n: rng.randn(*s).astype(np.float32)
                  for n, s in v.items()} for k, v in shapes.items()}
             for _ in range(3)]
    mults = {'1': 0.1, 'head': 3.}
    lr = 0.01

    jopt = jax_multi_adam(learning_rate=lr, lr_multipliers=mults)
    jparams = {k: {n: jnp.asarray(a) for n, a in v.items()}
               for k, v in init.items()}
    jstate = jopt.init(jparams)
    params = {k: {n: torch.tensor(a, requires_grad=True)
                  for n, a in v.items()} for k, v in init.items()}
    opt = multi_adam(params, learning_rate=lr, lr_multipliers=mults)
    for g in grads:
        jg = {k: {n: jnp.asarray(a) for n, a in v.items()}
              for k, v in g.items()}
        jupd, jstate = jopt.update(jg, jstate, jparams)
        before = {k: {n: p.detach().clone() for n, p in v.items()}
                  for k, v in params.items()}
        for k, v in params.items():
            for n, p in v.items():
                p.grad = torch.tensor(g[k][n])
        opt.step()
        for k, v in params.items():
            for n, p in v.items():
                upd = (p.detach() - before[k][n]).numpy()
                np.testing.assert_allclose(upd, np.asarray(jupd[k][n]),
                                           rtol=0, atol=1e-6,
                                           err_msg='{0}/{1}'.format(k, n))
        jparams = {k: {n: jparams[k][n] + jupd[k][n] for n in v}
                   for k, v in jparams.items()}

    # scale_by_multipliers: the same structure, -lr * multiplier each
    upd = {k: {n: torch.ones(1) for n in v} for k, v in shapes.items()}
    scaled = scale_by_multipliers(upd, mults, lr)
    assert float(scaled['1']['W']) == pytest.approx(-lr * 0.1)
    assert float(scaled['10']['W']) == pytest.approx(-lr)
    assert float(scaled['head']['W']) == pytest.approx(-lr * 3.)

    set_learning_rate(opt, 1.)
    assert sorted(g['lr'] for g in opt.param_groups) == [0.1, 1., 3.]


# --------------------------------------------------------------------- #
# parity with the JAX MLPClassifier from one carried-over state          #
# --------------------------------------------------------------------- #
def _recorded_jax(mlp):
    """Record the JAX fit's per-epoch train loss, learning rate and
    (val loss, val acc) at full precision by wrapping its programs on this
    instance (the JAX package itself is untouched)."""
    rec = {'loss': [], 'lr': [], 'val': []}
    build = mlp._build_programs

    def recording_build():
        train_epoch, train_step, evaluate = build()

        def te(*args):
            out = train_epoch(*args)
            rec['loss'].append(float(out[3]))
            rec['lr'].append(float(args[5]))
            return out

        def ev(*args):
            out = evaluate(*args)
            rec['val'].append((float(out[0]), float(out[1])))
            return out

        return te, train_step, ev

    mlp._build_programs = recording_build
    return rec


PARITY_CASES = {
    # sigmoid, no BN, a multiplier on layer 0, 300 rows: 4 batches of 64
    # and a remainder of 44
    'sigmoid_remainder': dict(
        layers=[dict(units=8, activation='sigmoid', lr_multiplier=0.1)],
        n_train=300, batch_size=64, epochs=6),
    'relu_bn': dict(
        layers=[dict(units=8, activation='relu', batch_norm=True)],
        n_train=384, batch_size=64, epochs=6),
    'two_hidden_multipliers': dict(
        layers=[dict(units=10, activation='sigmoid', lr_multiplier=0.01),
                dict(units=6, activation='sigmoid', lr_multiplier=0.1)],
        n_train=384, batch_size=32, epochs=5),
}


def _fit_pair(case, **kw):
    X, y = _toy_data()
    n = case['n_train']
    args = dict(n_inputs=16, layers=case['layers'], n_classes=3,
                max_epoch=case['epochs'], batch_size=case['batch_size'],
                learning_rate=0.01, l2=1e-3, verbose=False, random_seed=5)
    args.update(kw)
    jm = JaxMLP(**args)
    jm._init_params()
    params = [{k: np.asarray(v) for k, v in p.items()} for p in jm._params]
    bn = [None if s is None else {k: np.asarray(v) for k, v in s.items()}
          for s in jm._bn_stats]
    pm = mlp_from_jax(params, bn, MLPClassifier(device='cpu', **args))
    rec = _recorded_jax(jm)
    jm.fit(X[:n], y[:n], X[n:n + 128], y[n:n + 128])
    pm.fit(X[:n], y[:n], X[n:n + 128], y[n:n + 128])
    return jm, pm, rec, X[400:]


@pytest.mark.parametrize('name', sorted(PARITY_CASES))
def test_fit_matches_jax(name):
    """Both packages fit from the same state with dropout off: the
    per-epoch train loss and val loss within rtol 1e-4 and val acc equal
    (f32 sums in another order; acc is a count of argmax agreements), the
    final parameters and BN running stats within atol 2e-4, predict_proba
    within atol 1e-4.

    Under batch norm the dense bias before it has a gradient that is zero
    but for rounding (BN subtracts the batch mean), and Adam scales that
    noise, of the size of its eps, up to steps of ~lr: the two packages'
    biases walk apart, and with them the running mean, which eval mode
    subtracts.  So with BN the per-epoch validation numbers are not
    compared; the bias and the running mean are carried from JAX into the
    port after the fit, and then the validation loss and acc and
    predict_proba are held to the same tolerances.  The train loss does
    not see the bias and is compared every epoch."""
    case = PARITY_CASES[name]
    jm, pm, rec, X_test = _fit_pair(case)
    bn_layers = [i for i, c in enumerate(case['layers'])
                 if c.get('batch_norm')]
    hist = pm.history_
    assert len(hist) == len(rec['loss']) == len(rec['val'])
    np.testing.assert_allclose([h['loss'] for h in hist], rec['loss'],
                               rtol=1e-4)
    if not bn_layers:
        np.testing.assert_allclose([h['val_loss'] for h in hist],
                                   [v for v, _ in rec['val']], rtol=1e-4)
        assert [h['val_acc'] for h in hist] == [a for _, a in rec['val']]

    params, bn = mlp_to_jax(pm)
    for i, (p, jp) in enumerate(zip(params, jm._params)):
        assert sorted(p) == sorted(jp)
        for k in p:
            if i in bn_layers and k == 'b':
                continue
            np.testing.assert_allclose(p[k], np.asarray(jp[k]), rtol=0,
                                       atol=2e-4, err_msg='%d/%s' % (i, k))
    for i, (st, jst) in enumerate(zip(bn, jm._bn_stats)):
        assert (st is None) == (jst is None) == (i not in bn_layers)
        if st is not None:
            np.testing.assert_allclose(st['var'], np.asarray(jst['var']),
                                       rtol=0, atol=2e-4)

    if bn_layers:
        for i in bn_layers:
            params[i]['b'] = np.asarray(jm._params[i]['b'])
            bn[i]['mean'] = np.asarray(jm._bn_stats[i]['mean'])
        mlp_from_jax(params, bn, pm)
        X, y = _toy_data()
        n = case['n_train']
        Yv = torch.nn.functional.one_hot(torch.as_tensor(y[n:n + 128]), 3)
        vloss, vacc = pm._evaluate(torch.as_tensor(X[n:n + 128]),
                                   Yv.to(torch.float32))
        np.testing.assert_allclose(vloss, rec['val'][-1][0], rtol=1e-4)
        assert vacc == rec['val'][-1][1]
    np.testing.assert_allclose(pm.predict_proba(X_test),
                               jm.predict_proba(X_test), rtol=0, atol=1e-4)


def test_plateau_schedule_matches_jax():
    """reduce_lr_patience=1, early_stopping_patience=3: the rate is cut at
    the same epochs (the rate of every epoch equal) and the fit stops at
    the same epoch."""
    case = dict(PARITY_CASES['sigmoid_remainder'], epochs=40)
    jm, pm, rec, _ = _fit_pair(case, reduce_lr_patience=1,
                               early_stopping_patience=3,
                               reduce_lr_factor=0.5, min_lr=1e-4)
    lrs = [h['lr'] for h in pm.history_]
    assert len(lrs) == len(rec['lr']) < 40    # stopped early, same epoch
    np.testing.assert_allclose(lrs, rec['lr'], rtol=1e-6)
    assert len(set(lrs)) > 1                  # the rate was cut
    # every group carries the reduced rate times its multiplier
    assert min(lrs) < 0.01


def test_new_fit_keeps_parameters_and_restarts_adam():
    """A second fit starts from the fitted parameters with a fresh Adam
    state, as the JAX one does: the two packages still agree after it."""
    case = PARITY_CASES['sigmoid_remainder']
    jm, pm, rec, X_test = _fit_pair(dict(case, epochs=2))
    X, y = _toy_data(seed=3)
    jm.fit(X[:300], y[:300], X[300:428], y[300:428])
    pm.fit(X[:300], y[:300], X[300:428], y[300:428])
    np.testing.assert_allclose([h['loss'] for h in pm.history_],
                               rec['loss'][2:], rtol=1e-4)
    np.testing.assert_allclose(pm.predict_proba(X_test),
                               jm.predict_proba(X_test), rtol=0, atol=1e-4)


# --------------------------------------------------------------------- #
# dropout, by its statistics                                             #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize('drop', [0.3, 0.5])
def test_dropout_statistics(drop):
    """Over 4096 x 64 masks the kept share is 1 - p within 3 sigma, and
    kept units are scaled by 1 / keep exactly: the hidden layer's output
    is the constant sigmoid(1) (zero W, bias 1), read at the head's
    input."""
    n, units = 4096, 64
    W = np.zeros((8, units), np.float32)
    b = np.ones(units, np.float32)
    mlp = MLPClassifier(8, [dict(units=units, activation='sigmoid',
                                 weights=(W, b), dropout=drop)],
                        n_classes=2, verbose=False, device='cpu')
    mlp._init_params()
    seen = []
    mlp._net.dense[-1].register_forward_pre_hook(
        lambda module, args: seen.append(args[0].detach()))
    g = torch.Generator().manual_seed(0)
    mlp._net(torch.zeros(n, 8), train=True, generator=g)
    h = seen[-1]
    keep = 1. - drop
    kept = h != 0
    share = float(kept.float().mean())
    sigma = np.sqrt(keep * (1. - keep) / h.numel())
    assert abs(share - keep) < 3 * sigma, (share, keep, sigma)
    expect = torch.sigmoid(torch.tensor(1.)) / keep
    assert torch.all(h[kept] == expect)
    # inference: no mask
    mlp._net(torch.zeros(n, 8), train=False)
    assert torch.all(seen[-1] == torch.sigmoid(torch.tensor(1.)))
