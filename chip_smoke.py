"""Drive the PyTorch/CUDA port (boltzmann_machines_tpu_torch) once on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: the CUDA sources of the package, compiled with nvcc;
3. kernel vs plain: the CD epoch kernels against the plain PyTorch version
   (``cd_epoch_reference``) at the slice's shapes, 784 x 1024 at batch 10
   and 256, with sampling off and on;
4. the main path: ``BernoulliRBM(784, 1024).fit`` with the hyperparameters
   of examples/rbm_mnist.py on synthetic MNIST, through the kernels (their
   launch counts checked against the schedule), then transform, save and
   load_model on the card;
5. timings of a training epoch, kernels vs plain version.

Any failure raises (non-zero exit).  The last line of standard output is one
JSON object: {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.
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
SOURCE = 'boltzmann_machines_tpu_torch/csrc/cd_epoch.cu'
REPLACES = 'boltzmann_machines_tpu/ops/pallas_ops.py:1343'


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
    from boltzmann_machines_tpu_torch.ops._build import build as build_lib
    t0 = time.perf_counter()
    lib = build_lib('cd_epoch')
    say('build: %s in %.1f s' % (os.path.relpath(lib), time.perf_counter() - t0))
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


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: no CUDA device; this check runs only '
                         'on a GPU\n')
        return 1
    import numpy as np  # noqa: F401  (fails early outside the repo)
    environment(torch)
    build()
    worst = kernel_vs_plain(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        launches = main_path(torch, tmpdir)
    t = timings(torch)
    steps = t[(10, 'steps')]
    say(json.dumps({'kernels': [{
        'name': 'cd_epoch (cd_gemm_act, cd_bias_stats, cd_assoc_update, '
                'cd_metrics)',
        'route': 'cuda', 'source': SOURCE, 'replaces': REPLACES,
        'launches': sum(launches.values()),
        'launches_per_kernel': launches,
        'max_abs_err': worst,
        # per minibatch step on the main path (batch 10, sampled hiddens)
        'ms': 1e3 * t[(10, 'kernel', True)] / steps,
        'plain_ms': 1e3 * t[(10, 'plain', True)] / steps,
    }]}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
