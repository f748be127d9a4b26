"""Drive the PyTorch/CUDA port (boltzmann_machines_tpu_torch) once on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the package's two CUDA sources (csrc/cd_epoch.cu and
   csrc/dbm_ops.cu), one nvcc each, started together;
3. CD kernels vs plain: the CD epoch kernels against their plain PyTorch
   version (``cd_epoch_reference``) at 784 x 1024, batch 10 and 256, with
   sampling off and on;
4. the RBM path: ``BernoulliRBM(784, 1024).fit`` with the hyperparameters
   of examples/rbm_mnist.py on synthetic MNIST, through the kernels (their
   launch counts checked against the schedule), then transform, save and
   load_model on the card;
5. CD timings: a training epoch, kernels vs plain version;
6. DBM kernels vs plain: the DBM epoch, sampler and AIS kernels against
   their plain versions at 784-512-1024 (examples/dbm_mnist.py's widths),
   the epoch with mean-field that runs its whole budget and with
   mean-field that converges;
7. the DBM path of examples/dbm_mnist.py on the card: RBM #1 and RBM #2
   pretraining through the CD kernels, ``DBM.fit`` through the DBM epoch
   kernels, transform, ``sample_v`` and AIS ``log_Z`` through their
   kernels, ``log_proba``, save and load_model -- launch counts checked;
   then the AIS kernel against its plain version on the trained DBM,
   sampling on;
8. AIS on the card against a brute-force log Z of a 6-5-4 DBM;
9. DBM timings: epoch step, sampler sweep and AIS beta, kernels vs plain.

Any failure raises (non-zero exit).  The line before the last is the
kernels' JSON line; the last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

V, H = 784, 1024
LR, MOMENTUM = 0.05, 0.9
CSRC = 'boltzmann_machines_tpu_torch/csrc/'
REPLACES = {
    'cd_epoch': 'boltzmann_machines_tpu/ops/pallas_ops.py:1343',
    'dbm_epoch': 'boltzmann_machines_tpu/ops/pallas_dbm.py:373',
    'dbm_sample': 'boltzmann_machines_tpu/ops/pallas_dbm.py:481',
    'ais': 'boltzmann_machines_tpu/ops/pallas_dbm.py:516',
}


def say(*parts):
    print(*parts, flush=True)


def environment(torch):
    say('torch', torch.__version__, 'cuda', torch.version.cuda,
        'devices', torch.cuda.device_count())
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    # the card's name and power limit, as nvidia-smi gives them
    say(smi.stdout.strip().splitlines()[0])
    # TF32 off wherever the plain version runs on the card (true f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build():
    from boltzmann_machines_tpu_torch.ops._build import build_all
    t0 = time.perf_counter()
    libs = build_all(['cd_epoch', 'dbm_ops'])
    say('build: %s in %.1f s' % (' '.join(map(os.path.relpath, libs)),
                                 time.perf_counter() - t0))
    for lib in libs:
        with open(lib + '.log') as f:
            for line in f:
                if 'Function properties' in line or 'Used' in line \
                        or 'spill' in line:
                    say('  nvcc:', line.strip())


def make_data(n, seed=42):
    import numpy as np
    from boltzmann_machines_tpu_torch.utils.dataset import make_synthetic_mnist
    X, _ = make_synthetic_mnist(n, seed=seed)
    return (X / 255.).astype(np.float32)


def init_state(torch, X, seed=1337):
    from boltzmann_machines_tpu_torch import logit_mean
    g = torch.Generator(device='cuda')
    g.manual_seed(seed)
    f32 = dict(dtype=torch.float32, device='cuda')
    return {
        'W': 0.01 * torch.randn((V, H), generator=g, **f32),
        'vb': torch.as_tensor(logit_mean(X), **f32),
        'hb': torch.zeros(H, **f32), 'dW': torch.zeros((V, H), **f32),
        'dvb': torch.zeros(V, **f32), 'dhb': torch.zeros(H, **f32),
        'q_means': torch.zeros(H, **f32),
    }


def config(sample_v, sample_h, metrics_every):
    from boltzmann_machines_tpu_torch.ops.cd_epoch import CDEpochConfig
    return CDEpochConfig(
        n_visible=V, n_hidden=H, k=1, sample_v_states=sample_v,
        sample_h_states=sample_h, propup_mult=1., propdown_mult=1., l2=1e-5,
        sparsity_target=0.1, sparsity_cost=1e-5, sparsity_damping=0.9,
        metrics_every=metrics_every, compute_pll=True)


# Tolerances, kernel vs plain version on the same inputs.  Both compute in
# true f32 (no TF32) but sum in another order, so each step differs by a
# few ulps; 50 steps of momentum carry that to ~1e-6 on W.
#   state:   |d| <= 1e-5 + 1e-5 |ref|
#   q_means: |d| <= 1e-5 B + 1e-4 |ref|  (a batch SUM of hidden means, each
#            off by ~1e-5: the 784-term pre-activations pick up W's ~1e-6)
#   msre:    |d| <= 1e-6                 (a mean of ~1e5 squares, ~0.05)
#   l2:      |d| <= 1e-5 |ref|           (a sum of 8e5 squares)
#   pll:     |d| <= 0.1 + 1e-3 |ref|     (784 x the difference of two
#            batch-mean free energies of magnitude ~1e2-1e3 in f32)
TOL = {'state': (1e-5, 1e-5), 'q_means': (1e-5, 1e-4), 'msre': (1e-6, 0.),
       'l2': (0., 1e-5), 'pll': (0.1, 1e-3)}
ROWS = ('msre', 'pll', 'l2')


def diffs(got, want, B):
    """{name: (max |d|, max excess over the tolerance)}; an excess <= 0 is
    within tolerance."""
    out = {}
    pairs = [(k, got[0][k], want[0][k], k if k in TOL else 'state')
             for k in got[0]]
    pairs += [(name, a, b, name) for name, a, b in zip(ROWS, got[1:], want[1:])]
    for name, a, b, tol in pairs:
        atol, rtol = TOL[tol]
        if name == 'q_means':
            atol *= B
        d = (a - b).abs()
        out[name] = (float(d.max()),
                     float((d - atol - rtol * b.abs()).max()))
    return out


def kernel_vs_plain(torch):
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        cd_epoch, cd_epoch_reference)
    nb = 50
    X_all = make_data(nb * 256)
    worst = 0.
    for B in (10, 256):
        X = torch.as_tensor(X_all[:nb * B].reshape(nb, B, V), device='cuda')
        state = init_state(torch, X_all)
        # metrics every 10 iterations so the metric kernel runs 5 times
        cfg = config(False, False, 10)
        got = cd_epoch(cfg, state, X, LR, MOMENTUM, 7, 0)
        want = cd_epoch_reference(cfg, state, X, LR, MOMENTUM, 7, 0)
        torch.cuda.synchronize()
        d = diffs(got, want, B)
        say('B=%d sampling off, %d steps, max|kernel-plain|: %s' % (
            B, nb, ' '.join('%s=%.3g' % (k, v[0]) for k, v in d.items())))
        bad = [k for k, v in d.items() if v[1] > 0]
        if bad:
            raise AssertionError('kernel and plain version disagree on %s '
                                 '(B=%d, sampling off): %s' % (bad, B, d))
        worst = max(worst, d['W'][0])
        if not all(float(r.abs().max()) > 0 for r in got[1:]):
            raise AssertionError('metric rows were not written')

        # Sampling on (visible and hidden): both draw the same Philox
        # uniforms, so sampled states agree except where a mean lies within
        # rounding (~3e-8) of its uniform -- about 0.02 such draws per step
        # at B=256 (7e5 draws).  One flip changes the gradient by up to 1/B
        # and chains diverge after it, so each step starts both from the
        # kernel's state: a step is exact (within the tolerances above) or
        # holds a flip, bounded by 2 lr/B on dW; at least 40 of 50 steps
        # must be exact.
        cfg = config(True, True, 10)
        s = init_state(torch, X_all)
        exact, max_d = 0, 0.
        for i in range(nb):
            got = cd_epoch(cfg, s, X[i:i + 1], LR, MOMENTUM, 11, i)
            want = cd_epoch_reference(cfg, s, X[i:i + 1], LR, MOMENTUM, 11,
                                      i)
            d = diffs(got, want, B)
            if all(v[1] <= 0 for v in d.values()):
                exact += 1
            elif d['dW'][0] > 2 * LR / B + 1e-5:
                raise AssertionError(
                    'sampled step %d (B=%d) differs beyond a threshold flip: '
                    'max|d dW|=%.3g' % (i, B, d['dW'][0]))
            max_d = max(max_d, d['W'][0])
            s = got[0]
        say('B=%d sampling on, %d steps from the same state: %d exact, '
            'max|W kernel-plain|=%.3g' % (B, nb, exact, max_d))
        if exact < 40:
            raise AssertionError('only %d of %d sampled steps exact' % (
                exact, nb))
    return worst


def recon_msre(rbm, X):
    """Mean-field (one up-down pass on means) reconstruction error, in
    numpy from the model's weights."""
    import numpy as np
    w = rbm.get_params_arrays(scope='weights')
    Hm = 1. / (1. + np.exp(-(X @ w['W'] + w['hb'])))
    Vm = 1. / (1. + np.exp(-(Hm @ w['W'].T + w['vb'])))
    return float(np.mean((X - Vm) ** 2))


def main_path(torch, tmpdir):
    import numpy as np
    from boltzmann_machines_tpu_torch import BernoulliRBM, logit_mean
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        cd_epoch, reset_launches)
    X = make_data(12000, seed=7)
    X_train, X_val = X[:9995], X[-2000:]
    epochs, B, every = 3, 10, 1000
    rbm = BernoulliRBM(
        n_visible=V, n_hidden=H, W_init=0.01, vb_init=logit_mean(X_train),
        hb_init=0., n_gibbs_steps=1, learning_rate=LR,
        momentum=np.geomspace(0.5, 0.9, 8), max_epoch=epochs, batch_size=B,
        l2=1e-5, sample_v_states=False, sample_h_states=True, dropout=None,
        sparsity_target=0.1, sparsity_cost=1e-5, sparsity_damping=0.9,
        # rbm_mnist.py's metrics; the FEG cadence cut from 4 to 2 epochs so
        # that it runs within this short fit
        metrics_config=dict(msre=True, pll=True, feg=True,
                            train_metrics_every_iter=every,
                            val_metrics_every_epoch=2, feg_every_epoch=2,
                            n_batches_for_feg=50),
        verbose=True, display_filters=0, display_hidden_activations=0,
        random_seed=1337, device='cuda', model_path=tmpdir + '/rbm/')
    # mean-field reconstruction error of the validation rows, before and
    # after training (the per-epoch train msre above is one logged batch)
    msre_val0 = recon_msre(rbm, X_val)
    reset_launches()
    t0 = time.perf_counter()
    rbm.fit(X_train, X_val)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cd_epoch.launches)
    n_iter = epochs * math.ceil(len(X_train) / B)
    expect = {'cd_gemm_act': 3 * n_iter, 'cd_bias_stats': n_iter,
              'cd_assoc_update': n_iter, 'cd_metrics': n_iter // every}
    say('fit: %d epochs, %d iterations in %.2f s; launches %s' % (
        epochs, rbm.iter_, dt, launches))
    if launches != expect or rbm.iter_ != n_iter:
        raise AssertionError('launch counts %s, schedule implies %s' % (
            launches, expect))

    with open(tmpdir + '/rbm/logs/train/scalars.jsonl') as f:
        msre = [r['value'] for r in map(json.loads, f)
                if r['tag'] == 'mean_squared_reconstruction_error']
    say('train msre per epoch:', msre)
    if len(msre) != epochs or not all(map(math.isfinite, msre)) \
            or not msre[-1] < msre[0]:
        raise AssertionError('msre not finite and falling: %s' % msre)

    msre_val1 = recon_msre(rbm, X_val)
    say('validation mean-field msre: %.5f before, %.5f after' % (
        msre_val0, msre_val1))
    if not msre_val1 < msre_val0:
        raise AssertionError('training did not lower the reconstruction '
                             'error')

    Hf = rbm.transform(X_val)
    if Hf.shape != (len(X_val), H) or not np.all(np.isfinite(Hf)) \
            or Hf.min() < 0 or Hf.max() > 1:
        raise AssertionError('transform: bad output %s' % (Hf.shape,))
    r1 = BernoulliRBM.load_model(tmpdir + '/rbm/', device='cuda')
    r2 = BernoulliRBM.load_model(tmpdir + '/rbm/', device='cuda')
    s0, s1 = rbm.get_params_arrays(), r1.get_params_arrays()
    for k in s0:
        if not np.array_equal(s0[k], s1[k]):
            raise AssertionError('load_model changed %s' % k)
    if r1._state.W.device.type != 'cuda' or \
            not np.array_equal(r1.transform(X_val), r2.transform(X_val)):
        raise AssertionError('loaded models differ')
    say('save / load_model(device="cuda"): 7 state arrays identical, '
        'transform reproducible, shape %s' % (Hf.shape,))
    return launches


def timings(torch):
    """Seconds per epoch of ~10k samples, kernels vs plain version, in
    turns (plain, kernel, plain, kernel, kernel, plain; the first run of
    each is a warm-up), with the metrics of bench.py's reference config
    (every 1000 iterations).  Sampling as on the main path (hidden states
    sampled), and off: the plain version draws its Philox uniforms with
    ~200 small int64 ops per draw, which the sampling-off runs leave out."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        cd_epoch, cd_epoch_reference)
    out = {}
    X_all = make_data(10240, seed=3)
    fns = {'kernel': cd_epoch, 'plain': cd_epoch_reference}
    for B in (10, 256):
        nb = len(X_all) // B
        X = torch.as_tensor(X_all[:nb * B].reshape(nb, B, V), device='cuda')
        state = init_state(torch, X_all)
        out[(B, 'steps')] = nb
        for sample_h in (True, False):
            cfg = config(False, sample_h, 1000)
            times = {'kernel': [], 'plain': []}
            for name in ('plain', 'kernel', 'plain', 'kernel', 'kernel',
                         'plain'):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[name](cfg, state, X, LR, MOMENTUM, 5, 0)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
            for name in times:
                t = min(times[name][1:])
                out[(B, name, sample_h)] = t
                say('B=%d sample_h=%d %s: epoch of %d samples in %.4f s '
                    '(runs %s), %.0f samples/s, %.1f us/step' % (
                        B, sample_h, name, nb * B, t,
                        ' '.join('%.4f' % x for x in times[name]),
                        nb * B / t, 1e6 * t / nb))
    return out


# ---------------------------------------------------------------------- #
# the DBM slice: examples/dbm_mnist.py at its published widths            #
# ---------------------------------------------------------------------- #
DBM_SIZES = (784, 512, 1024)
DBM_B = DBM_M = 100
DBM_LR, DBM_MOM = 2e-3, 0.5            # the first values of its schedules
SPARSITY_TARGET, SPARSITY_COST = (0.2, 0.1), (1e-4, 5e-5)
# AIS ladder of the DBM path: dbm_mnist.py's 20 000 betas, uncut (~40 s)
N_BETAS = 20000

# Tolerances of the DBM kernels against their plain versions on the same
# inputs (true f32 on both sides, sums in another order):
#   state:   |d| <= 1e-5 + 1e-5 |ref|   (W, biases, accumulators, particles;
#            20 steps of lr 2e-3 carry a few ulps per step)
#   q_means, mu_means: |d| <= 1e-5 (B + M) + 1e-4 |ref|  (EMAs of batch
#            SUMS over 100 rows of means that are each off by ~1e-6)
#   msre:    |d| <= 1e-6                (a mean of 7.8e4 squares)
#   n_mf:    |d| <= 1 sweep             (the infinity-norm change sits at
#            f32 rounding of the means near mf_tol = 1e-7, so the two sum
#            orders may stop one sweep apart; a sweep then moves mu by
#            <= 1e-7, below the state tolerance); equal at mf_tol = 1e-4
#   sampler: v, H |d| <= 1e-4 after 50 sweeps on means
#   AIS:     log-weights |d| <= 0.05    (each log p~ is ~1.3e3 nats summed
#            over 1.8e3 softplus terms, f32 ulp 1.2e-4 at that size, and
#            2 x 200 of them accumulate as a random walk)
DBM_TOL = {'state': (1e-5, 1e-5), 'sums': (1e-5 * (DBM_B + DBM_M), 1e-4),
           'msre': 1e-6, 'n_mf': 1, 'sample': 1e-4, 'ais': 0.05}


def dbm_init(torch, X, seed=2222):
    """A DBM state at dbm_mnist's widths: small random weights, data-driven
    visible biases, particles from data and uniform hidden means."""
    from boltzmann_machines_tpu_torch import logit_mean
    g = torch.Generator(device='cuda')
    g.manual_seed(seed)
    f32 = dict(dtype=torch.float32, device='cuda')
    hs = DBM_SIZES[1:]
    zeros = [torch.zeros(h, **f32) for h in hs]
    return {
        'vb': torch.as_tensor(logit_mean(X), **f32),
        'hb': tuple(-0.5 + z for z in zeros),
        'W': tuple(0.03 * torch.randn((DBM_SIZES[l], hs[l]), generator=g,
                                      **f32) for l in range(2)),
        'dvb': torch.zeros(DBM_SIZES[0], **f32),
        'dhb': tuple(zeros), 'dW': tuple(torch.zeros(
            (DBM_SIZES[l], hs[l]), **f32) for l in range(2)),
        'q_means': tuple(zeros), 'mu_means': tuple(zeros),
        'v': torch.as_tensor(X[:DBM_M], **f32),
        'H': tuple(torch.rand((DBM_M, h), generator=g, **f32) for h in hs),
    }


def dbm_config(sample, k=1, mf_tol=1e-7):
    from boltzmann_machines_tpu_torch.ops.dbm_ops import DBMEpochConfig
    return DBMEpochConfig(DBM_SIZES, k, 50, mf_tol, sample, (sample, sample),
                          1e-7, 6., SPARSITY_TARGET, SPARSITY_COST, 0.9)


def dbm_diffs(got, want):
    """{name: (max |d|, max excess over the tolerance)} of two epoch
    results; n_mf by its own rule."""
    from boltzmann_machines_tpu_torch.ops.dbm_ops import STATE_KEYS
    out = {}
    for key in STATE_KEYS:
        a, b = got[0][key], want[0][key]
        pairs = list(zip(a, b)) if isinstance(b, tuple) else [(a, b)]
        atol, rtol = DBM_TOL['sums' if key in ('q_means', 'mu_means')
                             else 'state']
        d = max(float((x - y).abs().max()) for x, y in pairs)
        e = max(float(((x - y).abs() - atol - rtol * y.abs()).max())
                for x, y in pairs)
        out[key] = (d, e)
    d = float((got[1] - want[1]).abs().max())
    out['msre'] = (d, d - DBM_TOL['msre'])
    d = float((got[2] - want[2]).abs().max())
    out['n_mf'] = (d, d - DBM_TOL['n_mf'])
    return out


def compare_epoch(torch, cfg, state, X, n_mf_equal):
    """The DBM epoch kernel against its plain version on the same inputs,
    sampling off.  Returns ({name: (max |d|, excess)}, kernel n_mf rows);
    with `n_mf_equal` the n_mf rows must be equal."""
    from boltzmann_machines_tpu_torch.ops import dbm_ops
    got = dbm_ops.dbm_epoch(cfg, state, X, DBM_LR, DBM_MOM, 7, 0)
    want = dbm_ops.dbm_epoch_reference(cfg, state, X, DBM_LR, DBM_MOM, 7, 0)
    torch.cuda.synchronize()
    d = dbm_diffs(got, want)
    n_mf_k, n_mf_p = got[2].tolist(), want[2].tolist()
    nb = len(n_mf_k)
    say('dbm_epoch sampling off, mf_tol %g, %d steps, max|kernel-plain|: %s'
        % (cfg.mf_tol, nb, ' '.join('%s=%.3g' % (k, v[0])
                                    for k, v in d.items())))
    say('  n_mf kernel %s' % n_mf_k)
    say('  n_mf plain  %s (%d of %d rows equal)' % (
        n_mf_p, sum(a == b for a, b in zip(n_mf_k, n_mf_p)), nb))
    bad = [k for k, v in d.items() if v[1] > 0]
    if n_mf_equal and n_mf_k != n_mf_p:
        bad.append('n_mf rows')
    if bad:
        raise AssertionError('DBM epoch kernel and plain version disagree '
                             'on %s (sampling off, mf_tol %g): %s' % (
                                 bad, cfg.mf_tol, d))
    if not all(1 <= n <= cfg.max_mf_updates for n in n_mf_k):
        raise AssertionError('n_mf rows out of range: %s' % n_mf_k)
    return d, n_mf_k


def dbm_kernels_vs_plain(torch):
    """The three DBM kernels against their plain versions at full width.
    Returns the max |W kernel - plain| (epoch), |v| (sampler) and
    |log_w| (AIS), sampling off."""
    from boltzmann_machines_tpu_torch.ops import dbm_ops
    nb = 20
    X_all = make_data(nb * DBM_B, seed=11)
    X = torch.as_tensor(X_all.reshape(nb, DBM_B, DBM_SIZES[0]),
                        device='cuda')
    state = dbm_init(torch, X_all)
    err = {}

    # From this random state mean-field never meets mf_tol = 1e-7: every
    # minibatch runs the whole budget of 50 sweeps.
    d, _ = compare_epoch(torch, dbm_config(False), state, X, False)
    err['dbm_epoch'] = d['W'][0]
    # At mf_tol = 1e-4 it converges after a few sweeps, so the done flag,
    # the change folded over all blocks by atomicMax and the skipped sweeps
    # are held against the plain loop.  The change crosses 1e-4 about three
    # orders of magnitude above its f32 rounding, so the rows must be equal.
    _, n_mf = compare_epoch(torch, dbm_config(False, mf_tol=1e-4), state, X,
                            True)
    if not min(n_mf) < 50:
        raise AssertionError('mean-field did not converge at mf_tol 1e-4: '
                             '%s' % n_mf)

    # Sampling on: both draw the same Philox uniforms; a state differs only
    # where a mean lies within rounding of its uniform (~0.01 such draws per
    # step among 2.3e5), and the chains part after it.  So each step starts
    # both from the kernel's state: a step is exact (within the tolerances
    # above) or holds a flip, which moves a particle statistic by 1/M and dW
    # by at most lr / M per flipped unit; at least 15 of 20 exact.
    cfg = dbm_config(True)
    s, exact, max_d = state, 0, 0.
    for i in range(nb):
        got = dbm_ops.dbm_epoch(cfg, s, X[i:i + 1], DBM_LR, DBM_MOM, 13, i)
        want = dbm_ops.dbm_epoch_reference(cfg, s, X[i:i + 1], DBM_LR,
                                           DBM_MOM, 13, i)
        d = dbm_diffs(got, want)
        if all(v[1] <= 0 for v in d.values()):
            exact += 1
        elif d['dW'][0] > 4 * DBM_LR / DBM_M + 1e-5:
            raise AssertionError('sampled DBM step %d differs beyond a few '
                                 'threshold flips: %s' % (i, d))
        max_d = max(max_d, d['W'][0])
        s = got[0]
    say('dbm_epoch sampling on, %d steps from the same state: %d exact, '
        'max|W kernel-plain|=%.3g' % (nb, exact, max_d))
    if exact < 15:
        raise AssertionError('only %d of %d sampled DBM steps exact' % (
            exact, nb))

    # the sampler: 50 sweeps on means, then sampled sweeps from one state
    scfg = dbm_ops.DBMSampleConfig(DBM_SIZES, False, (False, False))
    got = dbm_ops.dbm_sample(scfg, state, 50, 3)
    want = dbm_ops.dbm_sample_reference(scfg, state, 50, 3)
    dv = float((got[1] - want[1]).abs().max())
    dh = max(float((a - b).abs().max())
             for a, b in zip(got[0]['H'], want[0]['H']))
    say('dbm_sample sampling off, 50 sweeps: max|v kernel-plain|=%.3g '
        'max|H|=%.3g' % (dv, dh))
    if max(dv, dh) > DBM_TOL['sample']:
        raise AssertionError('sampler kernel and plain version disagree')
    err['dbm_sample'] = dv
    scfg = dbm_ops.DBMSampleConfig(DBM_SIZES, True, (True, True))
    s, exact, n_diff = state, 0, 0
    for i in range(nb):
        got = dbm_ops.dbm_sample(scfg, s, 1, 100 + i)
        want = dbm_ops.dbm_sample_reference(scfg, s, 1, 100 + i)
        n = sum(int(((a - b).abs() > DBM_TOL['sample']).sum())
                for a, b in zip(got[0]['H'], want[0]['H']))
        exact += n == 0 and bool(((got[1] - want[1]).abs()
                                  <= DBM_TOL['sample']).all())
        n_diff += n
        s = got[0]
    say('dbm_sample sampling on, %d single sweeps from the same state: %d '
        'exact, %d hidden states differ of %d' % (
            nb, exact, n_diff, nb * DBM_M * sum(DBM_SIZES[1:])))
    if exact < 15 or n_diff > 1e-4 * nb * DBM_M * sum(DBM_SIZES[1:]):
        raise AssertionError('sampled sweeps differ beyond threshold flips')

    # AIS, sampling off: 100 runs, k = 5, 200 betas
    acfg = dbm_ops.AISConfig(*DBM_SIZES, 200, 5, False, False, False)
    x0 = (torch.rand((100, DBM_SIZES[1]), device='cuda') < 0.5).float()
    got = dbm_ops.ais(acfg, state, 5, x0)
    want = dbm_ops.ais_reference(acfg, state, 5, x0)
    d = float((got - want).abs().max())
    say('ais sampling off, 100 runs x %d betas, k=5: max|log_w '
        'kernel-plain|=%.3g (log_w in [%.1f, %.1f])' % (
            acfg.n_betas, d, float(want.min()), float(want.max())))
    if not d <= DBM_TOL['ais']:
        raise AssertionError('AIS kernel and plain version disagree: %g' % d)
    err['ais'] = d
    return err


def read_tag(path, tag):
    with open(path) as f:
        return [(r['step'], r['value']) for r in map(json.loads, f)
                if r['tag'] == tag]


def dbm_mnist_path(torch, tmpdir):
    """examples/dbm_mnist.py stages 1-3 and AIS at its published widths on
    ~10k synthetic MNIST rows, through the kernels.  Depth cuts: 2 epochs
    per stage (64 / 120 / 500 in the example), RBM #2's stepped schedule
    k = 1, 2 and lr = 0.01, 0.005 over those 2 epochs (one step each;
    schedules are indexed by the 1-based epoch, as in the example), the
    metric cadences (500 and 400 iterations) cut to 100 and 20 so that they
    log within the run, validation every epoch (2 in the example), no image
    summaries (not ported)."""
    import numpy as np
    from boltzmann_machines_tpu_torch import BernoulliRBM, DBM
    from boltzmann_machines_tpu_torch.ops import dbm_ops
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        cd_epoch, reset_launches)
    X = make_data(11000, seed=42)
    X_train, X_val = X[:10000], X[-1000:]
    X_test = make_data(1000, seed=7)
    n_rbm_iter = 2 * math.ceil(len(X_train) / 48)
    reset_launches()
    dbm_ops.reset_launches()
    t0 = time.perf_counter()
    rbm1 = BernoulliRBM(
        n_visible=784, n_hidden=512, W_init=0.001, vb_init=0., hb_init=0.,
        n_gibbs_steps=1, learning_rate=0.05, momentum=[0.5] * 5 + [0.9],
        max_epoch=2, batch_size=48, l2=1e-3, sample_h_states=True,
        sample_v_states=True, sparsity_cost=0., dbm_first=True,
        metrics_config=dict(msre=True, pll=True,
                            train_metrics_every_iter=100),
        verbose=True, random_seed=1337, device='cuda',
        model_path=tmpdir + '/rbm1/')
    rbm1.fit(X_train)
    Q = rbm1.transform(X_train).astype('float32')
    rbm2 = BernoulliRBM(
        n_visible=512, n_hidden=1024, W_init=0.005, vb_init=0., hb_init=0.,
        n_gibbs_steps=[1, 1, 2], learning_rate=[0.01, 0.01, 0.005],
        momentum=[0.5] * 5 + [0.9], max_epoch=2, batch_size=48, l2=2e-4,
        sample_h_states=True, sample_v_states=True, sparsity_cost=0.,
        dbm_last=True, metrics_config=dict(msre=True, pll=True,
                                           train_metrics_every_iter=100),
        verbose=True, random_seed=1111, device='cuda',
        model_path=tmpdir + '/rbm2/')
    rbm2.fit(Q)
    G = rbm2.transform(Q).astype('float32')
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    cd_launches = dict(cd_epoch.launches)
    # k = 1 then k = 2: 1 + 2k GEMM launches per step
    expect = {'cd_gemm_act': n_rbm_iter // 2 * (3 + 3 + 3 + 5),
              'cd_bias_stats': 2 * n_rbm_iter,
              'cd_assoc_update': 2 * n_rbm_iter,
              'cd_metrics': 2 * (n_rbm_iter // 100)}
    say('pretraining: RBM #1 and RBM #2, %d iterations each, in %.2f s; '
        'launches %s' % (n_rbm_iter, t_pre, cd_launches))
    if cd_launches != expect:
        raise AssertionError('CD launch counts %s, schedule implies %s' % (
            cd_launches, expect))

    dbm = DBM(
        rbms=[rbm1, rbm2], n_particles=DBM_M,
        v_particle_init=X_train[:DBM_M].copy(),
        h_particles_init=(Q[:DBM_M].copy(), G[:DBM_M].copy()),
        n_gibbs_steps=1, max_mf_updates=50, mf_tol=1e-7,
        learning_rate=np.geomspace(DBM_LR, 5e-6, 400),
        momentum=np.geomspace(DBM_MOM, 0.9, 10), max_epoch=2,
        batch_size=DBM_B, l2=1e-7, max_norm=6., sample_v_states=True,
        sample_h_states=(True, True), sparsity_target=SPARSITY_TARGET,
        sparsity_cost=SPARSITY_COST, sparsity_damping=0.9,
        train_metrics_every_iter=20, val_metrics_every_epoch=1,
        random_seed=2222, verbose=True, display_filters=0,
        display_particles=0, device='cuda', model_path=tmpdir + '/dbm/')
    t0 = time.perf_counter()
    dbm.fit(X_train, X_val)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    n_iter = 2 * math.ceil(len(X_train) / DBM_B)
    L, max_mf = 2, 50
    launches = dict(dbm_ops.dbm_epoch.launches)
    expect = {'dbm_gemm_act': n_iter * (1 + L + L * max_mf + (L + 1) + 1),
              'dbm_mf_check': n_iter * max_mf,
              'dbm_bias_update': n_iter * (L + 1),
              'dbm_assoc_update': n_iter * L, 'dbm_max_norm': n_iter * L,
              'dbm_msre': n_iter}
    train = tmpdir + '/dbm/logs/train/scalars.jsonl'
    msre = read_tag(train, 'mean_squared_recon_error')
    n_mf = read_tag(train, 'n_mf_updates')
    val = read_tag(tmpdir + '/dbm/logs/val/scalars.jsonl',
                   'mean_squared_recon_error')
    say('DBM.fit: 2 epochs, %d iterations in %.2f s; launches %s' % (
        dbm.iter_, t_fit, launches))
    say('  train msre per epoch %s; mean n_mf per epoch %s; val msre %s' % (
        [v for _, v in msre], [v for _, v in n_mf], [v for _, v in val]))
    if launches != expect or dbm.iter_ != n_iter:
        raise AssertionError('DBM launch counts %s, schedule implies %s' % (
            launches, expect))
    if len(msre) != 2 or not all(math.isfinite(v) for _, v in msre + val) \
            or not msre[1][1] < msre[0][1] or not val[1][1] < val[0][1]:
        raise AssertionError('msre not finite and falling: %s %s' % (msre,
                                                                     val))
    if not all(1 <= v <= max_mf for _, v in n_mf):
        raise AssertionError('mean n_mf out of range: %s' % n_mf)

    Gd = dbm.transform(X_val)
    if Gd.shape != (len(X_val), 1024) or not np.all(np.isfinite(Gd)) \
            or Gd.min() < 0 or Gd.max() > 1:
        raise AssertionError('transform: bad output %s' % (Gd.shape,))
    t0 = time.perf_counter()
    v = dbm.sample_v(n_gibbs_steps=100)
    torch.cuda.synchronize()
    t_sample = time.perf_counter() - t0
    n_sample = dbm_ops.dbm_sample.launches['dbm_gemm_act']
    if v.shape != (DBM_M, 784) or not np.all(np.isfinite(v)) \
            or n_sample != 100 * 3 + 2:
        raise AssertionError('sample_v: shape %s, %d launches' % (
            v.shape, n_sample))
    t0 = time.perf_counter()
    log_mean, (log_low, log_high), values = dbm.log_Z(
        n_betas=N_BETAS, n_runs=100, n_gibbs_steps=5)
    torch.cuda.synchronize()
    t_ais = time.perf_counter() - t0
    n_ais = dict(dbm_ops.ais.launches)
    say('log Z = %.2f [%.2f, %.2f] (AIS, %d betas, 100 runs, k=5) in %.2f s;'
        ' launches %s' % (log_mean, log_low, log_high, N_BETAS, t_ais, n_ais))
    if n_ais != {'dbm_gemm_act': N_BETAS * (3 * 5 + 2), 'ais_logw': N_BETAS}:
        raise AssertionError('AIS launch counts %s' % n_ais)
    # low = log(mean - std) of the importance weights exp(values) exists
    # only while their std is below their mean.  On this model the
    # log-weights are bimodal (a few runs in a hundred end ~13 nats above
    # the rest, in the kernel, the plain version and the JAX package's AIS
    # alike, at 1000 to 60 000 betas), so the std may exceed the mean, as
    # the JAX package's log_Z allows for peaked models.  low is checked where it exists, and its
    # absence only with that cause.
    w = np.exp(values - values.max())
    std_ge_mean = bool(np.std(w) >= np.mean(w))
    say('  log-weights: min %.2f, median %.2f, max %.2f; %d of %d runs '
        'within 1 nat of the max; std of the weights %s their mean' % (
            values.min(), np.median(values), values.max(),
            int((values > values.max() - 1.).sum()), len(values),
            '>=' if std_ge_mean else '<'))
    if values.shape != (100,) or not np.all(np.isfinite(values)) \
            or not log_mean <= log_high \
            or not (log_low <= log_mean
                    or (math.isnan(log_low) and std_ge_mean)):
        raise AssertionError('log Z: %s not within [%s, %s]' % (
            log_mean, log_low, log_high))
    elbo = dbm.log_proba(X_test, log_mean)
    say('sample_v(100) in %.3f s; held-out ELBO mean %.2f over %d rows' % (
        t_sample, float(elbo.mean()), len(elbo)))
    if elbo.shape != (len(X_test),) or not np.all(np.isfinite(elbo)):
        raise AssertionError('log_proba: not finite')

    dbm._save_model()
    d2 = DBM.load_model(tmpdir + '/dbm/', device='cuda')
    s0, s1 = dbm.get_params_arrays(), d2.get_params_arrays()
    if set(s0) != set(s1) or d2._state.W_0.device.type != 'cuda' or \
            any(not np.array_equal(s0[k], s1[k]) for k in s0):
        raise AssertionError('load_model(device="cuda") changed the state')
    if not np.array_equal(d2.transform(X_val), Gd):
        raise AssertionError('loaded DBM transforms differently')
    say('save / load_model(device="cuda"): %d state arrays identical, '
        'transform identical' % len(s0))
    return {'cd_epoch': cd_launches, 'dbm_epoch': launches,
            'dbm_sample': dict(dbm_ops.dbm_sample.launches),
            'ais': n_ais}, dbm


def ais_trained_vs_plain(torch, dbm):
    """The AIS kernel against its plain version on the DBM trained by the
    path, sampling on, over a short ladder (20 betas): there the 100 runs
    stay apart (on means from small random weights they all fall onto one
    trajectory).  Both draw the same Philox uniforms; a run whose uniform
    lies within rounding of its mean flips one state and then follows
    another chain, so a few runs may part: at least 90 of 100 must agree
    within the AIS tolerance, and the plain version's log-weights must
    spread over more than 1 nat.  Returns the max |d| of the runs that
    agree."""
    import numpy as np
    from boltzmann_machines_tpu_torch.ops import dbm_ops
    state = dbm._state.as_dict()
    acfg = dbm_ops.AISConfig(*DBM_SIZES, 20, 5, True, True, True)
    g = torch.Generator(device='cuda')
    g.manual_seed(9)
    x0 = (torch.rand((100, DBM_SIZES[1]), generator=g, device='cuda')
          < 0.5).float()
    got = dbm_ops.ais(acfg, state, 17, x0)
    want = dbm_ops.ais_reference(acfg, state, 17, x0)
    d = (got - want).abs()
    agree = d <= DBM_TOL['ais']
    w = want.cpu().numpy()
    spread = float(w.max() - w.min())
    n_distinct = len(np.unique(np.round(w, 3)))
    err = float(d[agree].max()) if bool(agree.any()) else math.inf
    say('ais sampling on, trained DBM, 100 runs x %d betas, k=5: %d of 100 '
        'runs within %g (max|log_w kernel-plain| among them %.3g); plain '
        'log_w in [%.1f, %.1f], %d distinct' % (
            acfg.n_betas, int(agree.sum()), DBM_TOL['ais'], err, w.min(),
            w.max(), n_distinct))
    if int(agree.sum()) < 90 or not bool(torch.isfinite(got).all()):
        raise AssertionError('AIS kernel and plain version disagree on the '
                             'trained DBM')
    if not spread > 1. or n_distinct < 50:
        raise AssertionError('AIS runs did not stay apart: spread %.3g, %d '
                             'distinct' % (spread, n_distinct))
    return err


def ais_vs_bruteforce(torch, tmpdir):
    """A 6-5-4 DBM pretrained and trained on the card: its kernel AIS log Z
    within 0.1 nats of the enumerated one."""
    import itertools
    import numpy as np
    from boltzmann_machines_tpu_torch import BernoulliRBM, DBM
    from boltzmann_machines_tpu_torch.ops import dbm_ops
    from boltzmann_machines_tpu_torch.utils import RNG, log_sum_exp
    X = (RNG(1337).rand(40, 6) < 0.4).astype('float32')
    kw = dict(max_epoch=2, batch_size=8, verbose=False, device='cuda')
    r1 = BernoulliRBM(n_visible=6, n_hidden=5, dbm_first=True, random_seed=1,
                      model_path=tmpdir + '/t1/', **kw).fit(X)
    r2 = BernoulliRBM(n_visible=5, n_hidden=4, dbm_last=True, random_seed=2,
                      model_path=tmpdir + '/t2/', **kw)
    r2.fit(r1.transform(X))
    dbm = DBM(rbms=[r1, r2], n_particles=16, n_gibbs_steps=2,
              max_mf_updates=20, learning_rate=0.01, momentum=0.5,
              max_epoch=3, batch_size=8, max_norm=4., random_seed=3,
              device='cuda', model_path=tmpdir + '/tdbm/').fit(X)
    s = dbm.get_params_arrays()
    W0, W1 = s['weights/W_0'], s['weights/W_1']
    Hs = np.array(list(itertools.product([0., 1.], repeat=5)))
    logp = Hs @ s['weights/hb_0'] + \
        np.log1p(np.exp(Hs @ W0.T + s['weights/vb'])).sum(1) + \
        np.log1p(np.exp(Hs @ W1 + s['weights/hb_1'])).sum(1)
    exact = log_sum_exp(logp)
    before = dbm_ops.ais.launches['ais_logw']
    log_mean, (low, high), _ = dbm.log_Z(n_betas=1000, n_runs=256,
                                         n_gibbs_steps=1)
    say('6-5-4 DBM trained on the card: AIS log Z %.4f [%.4f, %.4f], '
        'brute force %.4f' % (log_mean, low, high, exact))
    if dbm_ops.ais.launches['ais_logw'] - before != 1000 or \
            not abs(log_mean - exact) < 0.1:
        raise AssertionError('AIS on the card is off the exact log Z')
    return abs(log_mean - exact)


def dbm_timings(torch):
    """Per step / sweep / beta, kernels vs plain version in turns (plain,
    kernel, plain, kernel, kernel, plain; the first run of each is a
    warm-up, the best of the other two is kept)."""
    from boltzmann_machines_tpu_torch.ops import dbm_ops
    nb = 20
    X_all = make_data(nb * DBM_B, seed=5)
    X = torch.as_tensor(X_all.reshape(nb, DBM_B, DBM_SIZES[0]),
                        device='cuda')
    state = dbm_init(torch, X_all)
    x0 = (torch.rand((100, DBM_SIZES[1]), device='cuda') < 0.5).float()
    runs = {}
    for sample in (True, False):
        cfg = dbm_config(sample)
        runs[('dbm_epoch', sample)] = (nb, {
            'kernel': lambda cfg=cfg: dbm_ops.dbm_epoch(
                cfg, state, X, DBM_LR, DBM_MOM, 5, 0),
            'plain': lambda cfg=cfg: dbm_ops.dbm_epoch_reference(
                cfg, state, X, DBM_LR, DBM_MOM, 5, 0)})
        scfg = dbm_ops.DBMSampleConfig(DBM_SIZES, sample, (sample, sample))
        runs[('dbm_sample', sample)] = (50, {
            'kernel': lambda c=scfg: dbm_ops.dbm_sample(c, state, 50, 5),
            'plain': lambda c=scfg: dbm_ops.dbm_sample_reference(c, state,
                                                                 50, 5)})
        acfg = dbm_ops.AISConfig(*DBM_SIZES, 200, 5, sample, sample, sample)
        runs[('ais', sample)] = (200, {
            'kernel': lambda c=acfg: dbm_ops.ais(c, state, 5, x0),
            'plain': lambda c=acfg: dbm_ops.ais_reference(c, state, 5, x0)})
    out = {}
    for (name, sample), (n, fns) in runs.items():
        if name == 'ais' and sample:
            names = ('kernel', 'kernel', 'kernel')  # plain: sampling off
        else:
            names = ('plain', 'kernel', 'plain', 'kernel', 'kernel', 'plain')
        times = {}
        extra = ''
        for which in names:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fns[which]()
            torch.cuda.synchronize()
            times.setdefault(which, []).append(time.perf_counter() - t0)
            if name == 'dbm_epoch':
                extra = '; mean n_mf %.2f' % float(res[2].mean())
        for which, ts in times.items():
            t = min(ts[1:])
            out[(name, sample, which)] = 1e3 * t / n
            say('%s sampling %s %s: %.4f ms per %s (runs %s)%s' % (
                name, 'on' if sample else 'off', which, 1e3 * t / n,
                {'dbm_epoch': 'step', 'dbm_sample': 'sweep',
                 'ais': 'beta'}[name],
                ' '.join('%.4f' % x for x in ts), extra))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: no CUDA device; this check runs only '
                         'on a GPU\n')
        return 1
    import boltzmann_machines_tpu_torch  # noqa: F401  (fails outside the repo)
    environment(torch)
    build()
    worst = kernel_vs_plain(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        rbm_launches = main_path(torch, tmpdir)
    t = timings(torch)
    steps = t[(10, 'steps')]
    dbm_err = dbm_kernels_vs_plain(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        dbm_launches, dbm = dbm_mnist_path(torch, tmpdir)
        dbm_err['ais'] = max(dbm_err['ais'], ais_trained_vs_plain(torch, dbm))
        ais_vs_bruteforce(torch, tmpdir)
    td = dbm_timings(torch)
    cd_launches = {k: rbm_launches[k] + dbm_launches['cd_epoch'][k]
                   for k in rbm_launches}

    def entry(name, source, launches, err, ms, plain_ms, **extra):
        d = {'name': name, 'route': 'cuda', 'source': CSRC + source,
             'replaces': REPLACES[name], 'launches': sum(launches.values()),
             'launches_per_kernel': launches, 'max_abs_err': err,
             'ms': ms, 'plain_ms': plain_ms}
        d.update(extra)
        return d

    say(json.dumps({'kernels': [
        # per minibatch step of the RBM path (batch 10, sampled hiddens);
        # launches from the RBM path and the DBM path's pretraining
        entry('cd_epoch', 'cd_epoch.cu', cd_launches, worst,
              1e3 * t[(10, 'kernel', True)] / steps,
              1e3 * t[(10, 'plain', True)] / steps),
        # per minibatch step at B = M = 100, sampling on
        entry('dbm_epoch', 'dbm_ops.cu', dbm_launches['dbm_epoch'],
              dbm_err['dbm_epoch'], td[('dbm_epoch', True, 'kernel')],
              td[('dbm_epoch', True, 'plain')]),
        # per Gibbs sweep of 100 particles, sampling on
        entry('dbm_sample', 'dbm_ops.cu', dbm_launches['dbm_sample'],
              dbm_err['dbm_sample'], td[('dbm_sample', True, 'kernel')],
              td[('dbm_sample', True, 'plain')]),
        # per beta of 100 runs with k = 5; the plain version with sampling
        # off (its Philox emulation would dominate)
        entry('ais', 'dbm_ops.cu', dbm_launches['ais'], dbm_err['ais'],
              td[('ais', True, 'kernel')], td[('ais', False, 'plain')],
              plain_sampling='off'),
    ]}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
