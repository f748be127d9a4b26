"""Drive the PyTorch/CUDA port (boltzmann_machines_tpu_torch) once on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

(``--readings``, ``--assoc-readings``, ``--softmax-readings``,
``--sampler-readings`` and ``--pll-readings`` print, instead of the smoke,
what two checks' limits rest on, where the association kernel's time goes,
how cd_softmax_sample's time moves with the threads of its block, where a
standalone sampler's call and device time go, and the PLL's error against
its plain version in float32 and float64; see ``readings``,
``assoc_readings``, ``softmax_readings``, ``sampler_readings`` and
``pll_readings``.
``--kernel-times`` runs phase 18 alone; run from another checkout, it
times that checkout's kernels.)

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
   the epoch with mean-field that runs its whole budget (once more with a
   max-norm that scales half of W's columns down) and with mean-field that
   converges;
7. the DBM path of examples/dbm_mnist.py on the card: RBM #1 and RBM #2
   pretraining through the CD kernels, ``DBM.fit`` through the DBM epoch
   kernels, transform, ``sample_v`` and AIS ``log_Z`` through their
   kernels, ``log_proba``, save and load_model -- launch counts checked;
   then the AIS kernel against its plain version on the trained DBM,
   sampling on;
8. AIS on the card against a brute-force log Z of a 6-5-4 DBM;
9. DBM timings: epoch step, sampler sweep and AIS beta, kernels vs plain;
10. CIFAR kernels vs plain: the Gaussian-visible CD kernels at 3072 x 5000
    (examples/dbm_cifar_naive.py's G-RBM, dbm_first) and 3072 x 7800
    (examples/dbm_cifar.py's, a ragged H) and the multinomial-hidden ones at
    5000 x 1000, n = 1000 (the M-RBM, dbm_last, PLL on every checked
    iteration), batch 100, sampling off and on; the standalone samplers
    and the free-energy probe driven once each (normal_sample also at
    SAMPLER_EDGE_SHAPES) between a reset and a read of their launch
    counts, those outputs against their plain versions, and each timed
    per call beside its plain version and, where one PyTorch call
    computes the same function, that call;
11. the generative half of examples/dbm_cifar_naive.py on the card:
    ``GaussianRBM(3072, 5000).fit``, ``transform``,
    ``MultinomialRBM(5000, 1000, n_samples=1000).fit``, ``transform``, save
    and load_model, on synthetic CIFAR-shaped rows, launch counts checked;
12. CIFAR timings: G-RBM and M-RBM steps, kernels vs plain, the device
    time of each kernel (torch.profiler), their busy share of the step's
    unprofiled wall, and torch.matmul on the step's largest product as a
    yardstick;
13. stats kernels vs plain: the data-parallel epoch's per-shard CD stats
    kernels (``ops/cd_stats.py``) at the local batches of two ranks, 784 x
    1024 with 128 rows and 3072 x 7800 with 50 (Gaussian, dbm_first),
    shards 0 and 1, k = 0 and 1, sampling off (sums within STATS_TOL) and on
    (one pass's states draw by draw; shard 0's draws the CD epoch
    kernels'); ``bernoulli_sample`` driven once at (10, 1024),
    (100, 7800), SAMPLER_EDGE_SHAPES and a view 4 bytes past a 16-byte
    boundary, bit for bit against plain;
14. the data-parallel path on the card: the epoch driven directly on a
    one-rank NCCL group at 3072 x 7800 against the CD epoch kernels, and
    its step timed beside theirs; then the main path of this slice, a
    2-rank ``fit`` through ``set_mesh(parallel.make_mesh())`` (two
    processes on the one card over gloo, each ``python3 chip_smoke.py
    --dp-rank RANK WORLD TMPDIR``, waited for) of dbm_cifar.py's 3072 x 7800
    G-RBM and of a 784 x 1024 RBM at batch 256, launch counts checked on
    each rank, replicas bit for bit equal, rank 0 alone writing; the
    784 x 1024 fit against the single-process fit;
15. stats and sampler timings: per call, kernel vs plain, torch.matmul and
    torch.bernoulli as yardsticks, per-kernel device times; the standalone
    samplers' device times alone (CUDA graphs) beside torch.bernoulli's and
    torch.randn's;
16. the tensor-core tile of the chain's products (csrc/gemm_tc.cuh): each
    ``cd_gemm_act`` and ``dbm_gemm_act`` product of the paths, both
    directions, every epilogue the path uses there (the two-product and
    addend forms of the DBM's middle layer included), launched alone
    against its plain version and a second time with the same seed (bit for
    bit), then timed (a CUDA graph of launches between CUDA events) at the
    plan's split count and at one K slice, beside torch.matmul on the same
    product and the product's bounds in 3xTF32 and in f32, one line per
    product;
17. the association kernel (csrc/assoc_tc.cuh): each cd_assoc_update,
    cd_assoc_stats and dbm_assoc_update launch of the paths alone, through
    its C entry point, against its plain version's arithmetic (each element
    within the bound of tests/test_torch_cuda.py) and a second time on the
    same inputs (bit for bit), then timed by a CUDA graph beside the plain
    version, the former SIMT tile's recorded time and torch.matmul on the
    stacked K = 2B product;
18. every hand-written kernel but the products and the associations:
    cd_bias_stats (each RBM path), dbm_max_norm (both DBM layers),
    cd_stats_sums, cd_softmax_sample, cd_metrics, fe_probe (its two
    launches, at the M-RBM's and the G-RBM's shapes), dbm_bias_update (the
    step's one launch of vb, hb0 and hb1, and each vector alone), dbm_msre
    and ais_logw, each launched alone through its C entry point at its
    paths' shapes and timed by a CUDA graph beside its plain version, a
    library yardstick where one PyTorch call computes the function
    (torch.renorm, torch.sum over the batch, F.mse_loss; "none" and why
    where there is none) and its bound, with its launches per step and per
    1000 steps at the examples' cadences; each also against its plain
    version and a same-input rerun bit for bit; ais_logw also riding on an
    AIS beta's first dbm_gemm_act launch (the same bits as alone), that
    launch timed with and without it; the mean-field check, fused into
    each sweep's first dbm_gemm_act launch, against its plain rule (n_mf),
    timed as a one-layer loop against its launches alone, and the whole
    mean-field loop of a step (init and 50 sweeps); then the DBM step
    profiled, from a random state (all 50 sweeps run) and at mf_tol 1e-4
    (mean-field converges in a few): device time per kernel and busy
    share.

The DBM path (7) also runs its three training stages through the plain
versions and holds the kernels' validation error against that reference's.

Every entry of the kernels' JSON line has its time on the card (``ms``),
its plain version's (``plain_ms``), the least time the card could take for
the same work (``bound_ms``: the larger of the bytes it must move over
3.35 TB/s and its operations over the card's peaks for their type -- the
products, run at f32 accuracy on the tensor cores in 3xTF32, at 495 / 3 =
165 TFLOP/s, the other f32 operations at 67 TFLOP/s, and the standalone
samplers' Philox integer instructions on 64 INT32 lanes an SM at the SM
clock nvidia-smi reads -- from this run's shapes; ``bound_by`` says
which), and ``library_ms``, the time of one PyTorch call computing the
same function where there is one (else null).  The entries of the paths
whose products run on the tensor-core tile carry phase 16's numbers for
those products (``*_gemm_act_shapes``).

Any failure raises (non-zero exit).  The line before the last is the
kernels' JSON line; the last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import os
import re
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
    'cd_epoch_gaussian': 'boltzmann_machines_tpu/ops/pallas_ops.py:792 and '
                         ':1343 (Gaussian variant)',
    'cd_epoch_multinomial': 'boltzmann_machines_tpu/ops/pallas_ops.py:1343 '
                            '(multinomial variant)',
    'normal_sample': 'boltzmann_machines_tpu/ops/pallas_ops.py:97',
    'multinomial_sample': 'boltzmann_machines_tpu/ops/pallas_ops.py:115',
    'free_energy_probe': 'boltzmann_machines_tpu/ops/pallas_ops.py:241',
    'cd_stats': 'boltzmann_machines_tpu/ops/pallas_ops.py:1238 and :1033',
    'bernoulli_sample': 'boltzmann_machines_tpu/ops/pallas_ops.py:80',
}
# the card's published peaks (NVIDIA H100 SXM data sheet): f32 outside the
# tensor cores, TF32 on them (an f32-accurate product in 3xTF32 runs three
# tf32 products: 495 / 3 TFLOP/s), and device memory
PEAK_F32, PEAK_3XTF32, PEAK_BYTES = 67e12, 495e12 / 3, 3.35e12
# 32-bit integer instructions: 64 INT32 lanes an SM (the Hopper architecture
# white paper), times the SMs, times the SM clock nvidia-smi reads
INT32_LANES = 64
# integer SASS instructions of one Philox4x32-10 of counter (i, 0, 0, 0) in
# each standalone sampler kernel (csrc/cd_epoch.cu): the kernel's integer
# instructions less those of a copy whose Philox is the identity, over its
# four elements (`python3 chip_smoke.py --sampler-readings` reads them)
PHILOX_INT_OPS = {'bernoulli_sample': 36., 'normal_sample': 32.}


def int_peak():
    """Integer instructions a second: INT32_LANES x the SMs x the SM clock
    (``clocks.max.sm``), read once from the card."""
    if not hasattr(int_peak, 'rate'):
        import torch
        mhz = subprocess.run(
            ['nvidia-smi', '--query-gpu=clocks.max.sm',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, check=True, timeout=60).stdout.split()[0]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        int_peak.rate = INT32_LANES * sms * float(mhz) * 1e6
        say('integer peak: %d lanes x %d SMs x %s MHz = %.4g /s' % (
            INT32_LANES, sms, mhz, int_peak.rate))
    return int_peak.rate


def bound_parts(gemm_flops, flops, nbytes, int_ops=0.):
    """The least times, in ms, of `nbytes` bytes moved, of `gemm_flops`
    operations of products (matrix products at f32 accuracy, which the card
    runs on its tensor cores in 3xTF32) and `flops` other f32 operations,
    each kind over its peak and the two added, and of `int_ops` 32-bit
    integer instructions."""
    return {'bytes_ms': 1e3 * nbytes / PEAK_BYTES,
            'float_ms': 1e3 * (gemm_flops / PEAK_3XTF32 + flops / PEAK_F32),
            'int_ms': 1e3 * int_ops / int_peak() if int_ops else 0.}


def bound(*work):
    """(bound_ms, bound_by) of the work (bound_parts' arguments): the larger
    of the bytes' time and the operations', where the integers run on lanes
    of their own beside the floating-point work."""
    parts = bound_parts(*work)
    t_op = max(parts['float_ms'], parts['int_ms'])
    return (max(t_op, parts['bytes_ms']),
            'operations' if t_op >= parts['bytes_ms'] else 'bytes')


def cd_step_work(V, H, B, k=1, n_samples=0):
    """(product operations, other f32 operations, bytes) of one CD-k step:
    the 1 + 2k products and the two association products (2 B V H each);
    ~8 per weight for the momentum update and a softmax row pass (~5 per
    entry) per hidden pass of multinomial units; each input read once and
    each output written once: X, W and dW in, W and dW out, the biases.
    The Philox draws (integer work) and the binary-searched multinomial
    draws are not counted."""
    gemm_flops = 2. * B * V * H * (1 + 2 * k + 2)
    flops = 8. * V * H
    if n_samples:
        flops += 5. * B * H * (1 + k)
    nbytes = 4. * (B * V + 4 * V * H + 6 * (V + H))
    return gemm_flops, flops, nbytes


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
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    # TF32 off wherever the plain version runs on the card (true f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


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


def diffs(got, want, B, tols=TOL):
    """{name: (max |d|, max excess over the tolerance)}; an excess <= 0 is
    within tolerance."""
    out = {}
    pairs = [(k, got[0][k], want[0][k], k if k in tols else 'state')
             for k in got[0]]
    pairs += [(name, a, b, name) for name, a, b in zip(ROWS, got[1:], want[1:])]
    for name, a, b, tol in pairs:
        atol, rtol = tols[tol]
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
    # the PLL on: two cd_metrics launches a logged step
    expect = {'cd_gemm_act': 3 * n_iter, 'cd_softmax_sample': 0,
              'cd_bias_stats': n_iter, 'cd_assoc_update': n_iter,
              'cd_metrics': 2 * (n_iter // every)}
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
    # the main path's kernels one by one over the epoch timed above (B = 10,
    # hidden states sampled), their busy share over its timed wall, and
    # torch.matmul on one cd_gemm_act product (X.W) as a yardstick
    nb = out[(10, 'steps')]
    X = torch.as_tensor(X_all[:nb * 10].reshape(nb, 10, V), device='cuda')
    state = init_state(torch, X_all)
    cfg = config(False, True, 1000)
    out['kernel_us'], out['busy'] = profile_kernels(
        torch, lambda: cd_epoch(cfg, state, X, LR, MOMENTUM, 5, 0),
        wall=out[(10, 'kernel', True)])
    out['matmul_ms'] = event_ms(torch, lambda: X[0] @ state['W'], 50)
    say('B=10 per-kernel device us per launch %s; device busy %s; '
        'torch.matmul (10 x %d) @ (%d x %d): %.4f ms' % (
            out['kernel_us'], 'not measured' if out['busy'] is None
            else '%.1f%%' % (100. * out['busy']), V, V, H, out['matmul_ms']))
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


def dbm_config(sample, k=1, mf_tol=1e-7, max_norm=6.):
    from boltzmann_machines_tpu_torch.ops.dbm_ops import DBMEpochConfig
    return DBMEpochConfig(DBM_SIZES, k, 50, mf_tol, sample, (sample, sample),
                          1e-7, max_norm, SPARSITY_TARGET, SPARSITY_COST,
                          0.9)


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
    # max_norm 6 never bites on these weights (column norms ~0.7-0.9), so
    # once more with each W's columns scaled to norms from 0.5 to 1.5 and a
    # max_norm of 1: every step the max-norm kernel scales the columns above
    # it down, and leaves the others (W * norm / norm)
    capped = dict(state, W=tuple(
        W * (0.5 + torch.arange(W.shape[1], device='cuda') / W.shape[1])
        / torch.linalg.norm(W, dim=0) for W in state['W']))
    d, _ = compare_epoch(torch, dbm_config(False, max_norm=1.), capped, X,
                         False)
    err['dbm_epoch'] = max(err['dbm_epoch'], d['W'][0])
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


def train_dbm_mnist(torch, tmpdir, X_train, X_val, plain=False, seed=0):
    """examples/dbm_mnist.py stages 1-3 as the DBM path cuts them: RBM #1 and
    RBM #2 pretrained, then DBM.fit; through the kernels, or with `plain`
    through the plain versions (the reference) on the same data and
    seeds (the models' seeds shifted by `seed`).  Returns the models,
    timings and logged metrics."""
    import numpy as np
    from boltzmann_machines_tpu_torch import BernoulliRBM, DBM

    def plain_if_asked(model):
        if plain:
            model._kernel_eligible = lambda: False
        return model

    t0 = time.perf_counter()
    rbm1 = plain_if_asked(BernoulliRBM(
        n_visible=784, n_hidden=512, W_init=0.001, vb_init=0., hb_init=0.,
        n_gibbs_steps=1, learning_rate=0.05, momentum=[0.5] * 5 + [0.9],
        max_epoch=2, batch_size=48, l2=1e-3, sample_h_states=True,
        sample_v_states=True, sparsity_cost=0., dbm_first=True,
        metrics_config=dict(msre=True, pll=True,
                            train_metrics_every_iter=100),
        verbose=True, random_seed=1337 + seed, device='cuda',
        model_path=tmpdir + '/rbm1/'))
    rbm1.fit(X_train)
    Q = rbm1.transform(X_train).astype('float32')
    rbm2 = plain_if_asked(BernoulliRBM(
        n_visible=512, n_hidden=1024, W_init=0.005, vb_init=0., hb_init=0.,
        n_gibbs_steps=[1, 1, 2], learning_rate=[0.01, 0.01, 0.005],
        momentum=[0.5] * 5 + [0.9], max_epoch=2, batch_size=48, l2=2e-4,
        sample_h_states=True, sample_v_states=True, sparsity_cost=0.,
        dbm_last=True, metrics_config=dict(msre=True, pll=True,
                                           train_metrics_every_iter=100),
        verbose=True, random_seed=1111 + seed, device='cuda',
        model_path=tmpdir + '/rbm2/'))
    rbm2.fit(Q)
    G = rbm2.transform(Q).astype('float32')
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    dbm = plain_if_asked(DBM(
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
        random_seed=2222 + seed, verbose=True, display_filters=0,
        display_particles=0, device='cuda', model_path=tmpdir + '/dbm/'))
    t0 = time.perf_counter()
    dbm.fit(X_train, X_val)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    train = tmpdir + '/dbm/logs/train/scalars.jsonl'
    return dict(
        rbms=(rbm1, rbm2), dbm=dbm, t_pre=t_pre, t_fit=t_fit,
        msre=read_tag(train, 'mean_squared_recon_error'),
        n_mf=read_tag(train, 'n_mf_updates'),
        val=read_tag(tmpdir + '/dbm/logs/val/scalars.jsonl',
                     'mean_squared_recon_error'))


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
    from boltzmann_machines_tpu_torch import DBM
    from boltzmann_machines_tpu_torch.ops import dbm_ops
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        cd_epoch, reset_launches)
    X = make_data(11000, seed=42)
    X_train, X_val = X[:10000], X[-1000:]
    X_test = make_data(1000, seed=7)
    n_rbm_iter = 2 * math.ceil(len(X_train) / 48)
    reset_launches()
    dbm_ops.reset_launches()
    run = train_dbm_mnist(torch, tmpdir, X_train, X_val)
    cd_launches = dict(cd_epoch.launches)
    launches = dict(dbm_ops.dbm_epoch.launches)
    dbm, msre, n_mf, val = run['dbm'], run['msre'], run['n_mf'], run['val']
    # k = 1 then k = 2: 1 + 2k GEMM launches per step; the PLL on: two
    # cd_metrics launches a logged step
    expect = {'cd_gemm_act': n_rbm_iter // 2 * (3 + 3 + 3 + 5),
              'cd_softmax_sample': 0, 'cd_bias_stats': 2 * n_rbm_iter,
              'cd_assoc_update': 2 * n_rbm_iter,
              'cd_metrics': 2 * 2 * (n_rbm_iter // 100)}
    say('pretraining: RBM #1 and RBM #2, %d iterations each, in %.2f s; '
        'launches %s' % (n_rbm_iter, run['t_pre'], cd_launches))
    if cd_launches != expect:
        raise AssertionError('CD launch counts %s, schedule implies %s' % (
            cd_launches, expect))
    n_iter = 2 * math.ceil(len(X_train) / DBM_B)
    L, max_mf = 2, 50
    # 113 launches a step: 107 products (the mean-field check fused into
    # each sweep's first), one bias update for vb, hb0 and hb1, two
    # associations, two max-norms, one msre
    expect = {'dbm_gemm_act': n_iter * (1 + L + L * max_mf + (L + 1) + 1),
              'dbm_bias_update': n_iter,
              'dbm_assoc_update': n_iter * L, 'dbm_max_norm': n_iter * L,
              'dbm_msre': n_iter}
    if sum(expect.values()) != 113 * n_iter:
        raise AssertionError('the DBM schedule is not 113 launches a step')
    say('DBM.fit: 2 epochs, %d iterations in %.2f s; launches %s' % (
        dbm.iter_, run['t_fit'], launches))
    say('  train msre per epoch %s; mean n_mf per epoch %s; val msre %s' % (
        [v for _, v in msre], [v for _, v in n_mf], [v for _, v in val]))
    if launches != expect or dbm.iter_ != n_iter:
        raise AssertionError('DBM launch counts %s, schedule implies %s' % (
            launches, expect))
    # The same three stages through the plain versions (the reference), on
    # the same data and seeds.  Both runs sample their chains, so they part
    # at the first draw that rounding moves; the reference too need not
    # lower the validation error in the second epoch (it did not, on the
    # card).  So: the train msre falls in both, and the kernels' final
    # validation error is within 25% of the reference's.  The readings
    # (`--readings`, on an H100) put that limit between the sound runs and
    # a planted fault: kernels over plain at three seeds 0.87-1.17, one
    # seed's plain run over another's 0.84-1.20, a tile that loses a
    # split-K slice 2.99-3.85.  (A 1xTF32 tile reads 0.95-1.15: this check
    # cannot see it; the kernel-vs-plain comparisons do.)
    with tempfile.TemporaryDirectory() as ref_dir:
        ref = train_dbm_mnist(torch, ref_dir, X_train, X_val, plain=True)
    say('  reference (plain versions): train msre per epoch %s; val msre %s; '
        'pretraining %.2f s, DBM.fit %.2f s' % (
            [v for _, v in ref['msre']], [v for _, v in ref['val']],
            ref['t_pre'], ref['t_fit']))
    del ref['dbm'], ref['rbms']
    if len(msre) != 2 or len(val) != 2 or len(ref['msre']) != 2 or \
            len(ref['val']) != 2 or \
            not all(math.isfinite(v) for _, v in msre + val + ref['val']) \
            or not msre[1][1] < msre[0][1] \
            or not ref['msre'][1][1] < ref['msre'][0][1] \
            or not val[1][1] <= 1.25 * ref['val'][1][1]:
        raise AssertionError('msre not finite and falling, or validation '
                             'error off the reference\'s: %s %s; reference '
                             '%s %s' % (msre, val, ref['msre'], ref['val']))
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
    # per beta 3 per Gibbs step and 2 for log p~; each beta's log-weight
    # update rides on the next beta's first launch, the last one alone
    if n_ais != {'dbm_gemm_act': N_BETAS * (3 * 5 + 2), 'ais_logw': 1}:
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
    before = dict(dbm_ops.ais.launches)
    log_mean, (low, high), _ = dbm.log_Z(n_betas=1000, n_runs=256,
                                         n_gibbs_steps=1)
    say('6-5-4 DBM trained on the card: AIS log Z %.4f [%.4f, %.4f], '
        'brute force %.4f' % (log_mean, low, high, exact))
    # one log_Z call: 3 + 2 launches a beta, one ais_logw
    if {k: dbm_ops.ais.launches[k] - before[k] for k in before} != {
            'dbm_gemm_act': 1000 * (3 + 2), 'ais_logw': 1} or \
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
    # torch.matmul on one dbm_gemm_act product (X.W0, 100 x 784 x 512) as
    # a yardstick
    out['matmul_ms'] = event_ms(torch, lambda: X[0] @ state['W'][0], 50)
    say('torch.matmul (%d x %d) @ (%d x %d): %.4f ms' % (
        DBM_B, DBM_SIZES[0], DBM_SIZES[0], DBM_SIZES[1], out['matmul_ms']))
    return out

# ---------------------------------------------------------------------- #
# the dbm_cifar_naive RBM stages: examples/dbm_cifar_naive.py:103-163     #
# ---------------------------------------------------------------------- #
GRBM = (3072, 5000)
GRBM_WIDE = (3072, 7800)      # examples/dbm_cifar.py:266, N_SMALL_HIDDEN * 26
MRBM = (5000, 1000)
CIFAR_B, N_SAMPLES = 100, 1000
# the standalone samplers' ragged shapes: one element (the scalar path
# alone), and tails of 3 after the 16-byte path
SAMPLER_EDGE_SHAPES = ((1, 1), (3, 5), (7, 1001))
GRBM_LR, MRBM_LR = 5e-4, 1e-4   # the example's learning rates
GRBM_L2, MRBM_L2 = 0.01, 0.05

# Tolerances at the CIFAR shapes, kernel vs plain version on the same
# inputs (true f32 on both sides, sums in another order):
#   state, q_means: as at 784 x 1024 (a few steps of lr <= 5e-4);
#   msre: atol 1e-6 + rtol 1e-5 (the Gaussian msre is ~1, a mean of 3e5
#         squares);
#   l2:   rtol 1e-5;
#   pll:  atol 1 + rtol 1e-3: V (3072 or 5000) x the difference of two
#         batch-mean free energies of magnitude up to ~1e3 (f32 ulp 6e-5
#         there), each a sum of V + H terms per row taken in another order.
# Sampling on, the draws agree bit for bit except where a uniform lies
# within rounding of its threshold or CDF entry.  The means differ by ~1e-6
# relative (K = 3072 or 5000 summed in another order), so a Bernoulli state
# flips with odds ~1e-7 per draw, while a multinomial draw moves to the next
# bucket with odds ~5e-5 (the sum of the H = 1000 CDF differences): a few
# of the 1e5 draws of each M-RBM pass.  The Box-Muller normals differ by an
# ulp or two.  So `compare_passes` holds the sampled states of one pass on
# the same inputs: Bernoulli states differ in <= 1e-5 of draws, multinomial
# counts in <= 1e-3 of draws with every row summing to n, Gaussian states
# within 1e-5 (1 + |v|).  Epoch steps, each from the kernel's state, are
# exact (within CIFAR_TOL) or hold moved draws, and then must stay within
# SAMPLED_TOL: the parameters as CIFAR_TOL (lr <= 5e-4 scales a moved draw
# far below it), while a moved draw changes one row's chain means by a few
# per cent, so msre by <= 1e-2 relative and q_means (sums over 100 rows) by
# <= 1e-2 relative; the PLL as CIFAR_TOL.  A probe step (lr 1, momentum 0,
# no metrics) from the same state shows the moved draws: dvb = mean(X -
# v_states) moves by <= max|W| sigma / B per flipped or moved draw, and
# must stay within 20 of them.
CIFAR_TOL = {'state': (1e-5, 1e-5), 'q_means': (1e-5, 1e-4),
             'msre': (1e-6, 1e-5), 'l2': (0., 1e-5), 'pll': (1., 1e-3)}
SAMPLED_TOL = dict(CIFAR_TOL, q_means=(1e-5, 1e-2), msre=(1e-6, 1e-2))


def make_cifar(n, seed=42, n_templates=10):
    """n synthetic CIFAR-shaped rows (32 x 32 x 3 values in [0, 1]): a few
    smooth colour templates plus pixel noise, made with numpy from `seed`
    (CIFAR-10 itself is not in the repository)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:32, 0:32] / 32.
    T = []
    for _ in range(n_templates):
        f = rng.uniform(0.5, 3., size=(3, 2))
        ph = rng.uniform(0., 2. * np.pi, size=3)
        T.append(np.stack([0.5 + 0.4 * np.sin(
            2. * np.pi * (f[c, 0] * xx + f[c, 1] * yy) + ph[c])
            for c in range(3)], axis=-1).reshape(-1))
    X = np.asarray(T)[rng.randint(0, n_templates, n)] \
        + 0.1 * rng.randn(n, 3072)
    return np.clip(X, 0., 1.).astype(np.float32)


def standardize(X_train, *others):
    """examples/dbm_cifar_naive.py:301-306, without the SVD smoothing."""
    mean = X_train.mean(axis=0)
    std = X_train.std(axis=0) + 1e-8
    return [((X - mean) / std).astype('float32') for X in (X_train,) + others]


def grbm_cfg(V, H, sample, metrics_every, compute_pll=True):
    """The G-RBM stage: Gaussian visible units, sigma 1, dbm_first."""
    import numpy as np
    from boltzmann_machines_tpu_torch.ops.cd_epoch import CDEpochConfig
    return CDEpochConfig(V, H, 1, sample, sample, 2., 1., GRBM_L2, 0.1, 0.,
                         0.9, metrics_every, compute_pll, 'gaussian',
                         np.ones(V, np.float32))


def mrbm_cfg(sample, metrics_every):
    """The M-RBM stage: n_samples 1000, hidden states sampled, dbm_last."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import CDEpochConfig
    return CDEpochConfig(*MRBM, 1, False, sample, 1., 2., MRBM_L2, 0.1, 0.,
                         0.9, metrics_every, True, 'bernoulli', None,
                         'multinomial', N_SAMPLES)


def cifar_state(torch, V, H, w_init, seed=1337):
    g = torch.Generator(device='cuda')
    g.manual_seed(seed)
    f32 = dict(dtype=torch.float32, device='cuda')
    return {'W': w_init * torch.randn((V, H), generator=g, **f32),
            'vb': torch.zeros(V, **f32), 'hb': torch.zeros(H, **f32),
            'dW': torch.zeros((V, H), **f32), 'dvb': torch.zeros(V, **f32),
            'dhb': torch.zeros(H, **f32), 'q_means': torch.zeros(H, **f32)}


def cifar_inputs(torch, nb, kind, seed=3):
    """(nb, 100, V) batches: standardized synthetic CIFAR rows for the
    G-RBMs, G-RBM-feature-like values in [0, 1) for the M-RBM."""
    import numpy as np
    if kind == 'mrbm':
        X = np.random.RandomState(seed).rand(nb * CIFAR_B, MRBM[0])
    else:
        X, = standardize(make_cifar(nb * CIFAR_B, seed=seed))
    return torch.as_tensor(X.reshape(nb, CIFAR_B, -1), dtype=torch.float32,
                           device='cuda')


def compare_cifar(torch, label, cfg, state, X, lr):
    """Kernel vs plain over the batches of X, sampling off; raises beyond
    CIFAR_TOL.  Returns the max |W kernel - plain|."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        cd_epoch, cd_epoch_reference)
    got = cd_epoch(cfg, state, X, lr, MOMENTUM, 7, 0)
    want = cd_epoch_reference(cfg, state, X, lr, MOMENTUM, 7, 0)
    torch.cuda.synchronize()
    d = diffs(got, want, CIFAR_B, CIFAR_TOL)
    say('%s sampling off, %d steps, max|kernel-plain|: %s' % (
        label, len(X), ' '.join('%s=%.3g' % (k, v[0]) for k, v in d.items())))
    say('  rows kernel: msre %s pll %s' % (
        ['%.5f' % v for v in got[1].tolist()],
        ['%.3f' % v for v in got[2].tolist()]))
    bad = [k for k, v in d.items() if v[1] > 0]
    if bad:
        raise AssertionError('%s: kernel and plain version disagree on %s: '
                             '%s' % (label, bad, d))
    if not (float(got[1].min()) > 0 and float(got[3].min()) > 0
            and bool(torch.isfinite(got[2]).all())
            and float(got[2].max()) <= 0 and float(got[2].min()) < 0):
        raise AssertionError('%s: metric rows not written' % label)
    return d['W'][0]


def compare_cifar_sampled(torch, label, cfg, state, X, lr):
    """Sampling on, each step from the kernel's state (see CIFAR_TOL).
    Returns the share of exact probe steps."""
    import numpy as np
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        cd_epoch, cd_epoch_reference)
    probe = cfg._replace(metrics_every=10 ** 6)
    s, n_exact, exact, max_d, max_dvb, moved = state, 0, 0, 0., 0., []
    sigma = 1. if cfg.sigma is None else float(np.max(cfg.sigma))
    for i in range(len(X)):
        Xi = X[i:i + 1]
        got = cd_epoch(cfg, s, Xi, lr, MOMENTUM, 11, i)
        want = cd_epoch_reference(cfg, s, Xi, lr, MOMENTUM, 11, i)
        d = diffs(got, want, CIFAR_B, CIFAR_TOL)
        n_exact += all(v[1] <= 0 for v in d.values())
        wide = diffs(got, want, CIFAR_B, SAMPLED_TOL)
        if any(v[1] > 0 for v in wide.values()):
            raise AssertionError('%s sampled step %d beyond moved draws: %s' % (
                label, i, wide))
        max_d = max(max_d, d['W'][0])
        pg = cd_epoch(probe, s, Xi, 1., 0., 13, i)
        pw = cd_epoch_reference(probe, s, Xi, 1., 0., 13, i)
        dp = diffs(pg, pw, CIFAR_B, CIFAR_TOL)
        per_draw = float(s['W'].abs().max()) * sigma / CIFAR_B
        exact += all(v[1] <= 0 for v in dp.values())
        moved.append(dp['dvb'][0] / per_draw)
        if dp['dvb'][0] > 20 * per_draw:
            raise AssertionError('%s probe step %d differs beyond 20 moved '
                                 'draws: %s' % (label, i, dp))
        max_dvb = max(max_dvb, dp['dvb'][0])
        s = got[0]
    say('%s sampling on, %d steps from the kernel\'s state at lr %g: %d '
        'exact, the rest within the moved-draw tolerance (max|W '
        'kernel-plain|=%.3g); probe steps (lr 1): %d exact, max|dvb '
        'kernel-plain|=%.3g = %.2f max|W| sigma / B' % (
            label, len(X), lr, n_exact, max_d, exact, max_dvb, max(moved)))
    return exact / len(X)


def compare_passes(torch, label, cfg, layer, A, W, bias, n_batches,
                   shard=0):
    """The sampled states of one Gibbs pass of the epoch's kernels against
    the plain version's on the same inputs (see CIFAR_TOL), under the
    data-parallel counter word `shard`.  Returns the share of differing
    draws (Bernoulli, multinomial) or the max |d| of the Gaussian
    states."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        _gibbs_pass, _gibbs_pass_reference)
    d_means, n_diff, n_draws, d_states = 0., 0, 0, 0.
    for i in range(n_batches):
        mk, sk = _gibbs_pass(cfg, layer, A[i], W, bias, 21, i + 1, 3,
                             shard=shard)
        mp, sp = _gibbs_pass_reference(cfg, layer, A[i], W, bias, 21, i + 1,
                                       3, shard=shard)
        torch.cuda.synchronize()
        d_means = max(d_means, float(((mk - mp).abs()
                                      / mp.abs().clamp(min=1.)).max()))
        if layer == 'v' and cfg.visible == 'gaussian':
            d_states = max(d_states, float(((sk - sp).abs()
                                            / (1. + sp.abs())).max()))
        elif cfg.hidden == 'multinomial' and layer == 'h':
            if not bool((sk.sum(1) == cfg.n_samples).all()):
                raise AssertionError('%s: counts do not sum to n' % label)
            n_diff += int((sk - sp).abs().sum()) // 2
            n_draws += sk.shape[0] * cfg.n_samples
        else:
            n_diff += int((sk != sp).sum())
            n_draws += sk.numel()
    if n_draws:
        share = n_diff / n_draws
        limit = 1e-3 if cfg.hidden == 'multinomial' else 1e-5
        say('%s %s pass, %d batches: %d of %d draws differ (%.2g; limit %g), '
            'means max rel |d| %.3g' % (label, layer, n_batches, n_diff,
                                        n_draws, share, limit, d_means))
        if share > limit:
            raise AssertionError('%s: sampled states differ' % label)
        return share
    say('%s %s pass (Gaussian), %d batches: states max |d| / (1 + |v|) %.3g '
        '(limit 1e-5), means %.3g' % (label, layer, n_batches, d_states,
                                      d_means))
    if d_states > 1e-5:
        raise AssertionError('%s: Gaussian states differ' % label)
    return d_states


def cifar_kernels_vs_plain(torch):
    """The Gaussian and multinomial CD kernels against the plain version at
    the CIFAR shapes.  Returns {entry: max |W kernel - plain|} and the
    shares of exact probe steps and of differing draws."""
    err, share = {}, {}
    X = cifar_inputs(torch, 20, 'grbm', seed=3)
    state = cifar_state(torch, *GRBM, 0.0008)
    err['cd_epoch_gaussian'] = compare_cifar(
        torch, 'G-RBM 3072x5000', grbm_cfg(*GRBM, False, 1), state, X[:5],
        GRBM_LR)
    cfg = grbm_cfg(*GRBM, True, 1)
    share['grbm'] = compare_cifar_sampled(torch, 'G-RBM 3072x5000', cfg,
                                          state, X, GRBM_LR)
    share['grbm_h_draws'] = compare_passes(
        torch, 'G-RBM', cfg, 'h', X, state['W'], state['hb'] + 0.1, 5)
    H0 = (torch.rand((5, CIFAR_B, GRBM[1]), device='cuda') < 0.5).float()
    share['grbm_v_states'] = compare_passes(
        torch, 'G-RBM', cfg, 'v', H0, state['W'] * 10., state['vb'] + 0.1, 5)
    wide = cifar_state(torch, *GRBM_WIDE, 0.0008, seed=7)
    err['cd_epoch_gaussian'] = max(err['cd_epoch_gaussian'], compare_cifar(
        torch, 'G-RBM 3072x7800', grbm_cfg(*GRBM_WIDE, False, 1), wide,
        X[:3], GRBM_LR))
    del wide
    Xm = cifar_inputs(torch, 20, 'mrbm', seed=4)
    state = cifar_state(torch, *MRBM, 0.01)
    err['cd_epoch_multinomial'] = compare_cifar(
        torch, 'M-RBM 5000x1000 n=1000', mrbm_cfg(False, 1), state, Xm[:5],
        MRBM_LR)
    cfg = mrbm_cfg(True, 1)
    share['mrbm'] = compare_cifar_sampled(torch, 'M-RBM 5000x1000 n=1000',
                                          cfg, state, Xm, MRBM_LR)
    share['mrbm_h_draws'] = compare_passes(
        torch, 'M-RBM', cfg, 'h', Xm, state['W'], state['hb'], 10)
    return err, share


def event_ms(torch, fn, n):
    """Device milliseconds per call of `fn`, by CUDA events around n calls
    after a warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def samplers_vs_plain(torch):
    """The standalone launchers normal_sample, multinomial_sample and the
    free-energy probe at the shapes of the path.  Each is driven once (the
    probe once per flavour) with the launch counts set to 0 just before and
    read just after; those outputs are held against the plain versions;
    then each is timed per call (CUDA events): kernel, plain, and the one
    PyTorch call that computes the same function where there is one."""
    from boltzmann_machines_tpu_torch.ops import samplers
    out = {}
    # the G-RBM's visible draw: (100, 3072) normals
    shape = (CIFAR_B, GRBM[0])
    # the M-RBM's hidden draw: n = 1000 over 1000 buckets, on softmax means
    g = torch.Generator(device='cuda')
    g.manual_seed(3)
    pre = 2. * torch.randn((CIFAR_B, MRBM[1]), generator=g, device='cuda')
    means = N_SAMPLES * torch.softmax(pre, dim=1)
    # the free energy of the M-RBM's PLL (multinomial, 5000 x 1000) and of
    # the G-RBM (Gaussian, 3072 x 5000), batch 100
    probes = []
    for label, (V, H), visible, hidden, X in (
            ('M-RBM', MRBM, 'bernoulli', 'multinomial',
             cifar_inputs(torch, 1, 'mrbm')[0]),
            ('G-RBM', GRBM, 'gaussian', 'bernoulli',
             cifar_inputs(torch, 1, 'grbm')[0])):
        st = cifar_state(torch, V, H, 0.01)
        probe = samplers.make_free_energy_probe(V, H, CIFAR_B, visible,
                                                hidden, N_SAMPLES)
        args = (X, st['W'], st['vb'] + 0.1, st['hb'] - 0.1,
                1. if visible == 'gaussian' else None, 9)
        probes.append((label, V, H, probe, args))

    torch.cuda.synchronize()
    samplers.reset_launches()
    got_normal = {s: samplers.normal_sample(5, s, 'cuda')
                  for s in (shape,) + SAMPLER_EDGE_SHAPES}
    got_counts = samplers.multinomial_sample(6, means, N_SAMPLES)
    got_fe = [probe(*args) for _, _, _, probe, args in probes]
    torch.cuda.synchronize()
    launches = {'normal_sample': samplers.normal_sample.launches[
                    'normal_sample'],
                'multinomial_sample': samplers.multinomial_sample.launches[
                    'multinomial_sample'],
                'free_energy_probe': samplers.make_free_energy_probe.launches[
                    'fe_probe']}
    say('standalone launchers driven once each: %s' % json.dumps(launches))
    # the probe: two launches a call
    if launches != {'normal_sample': len(got_normal), 'multinomial_sample': 1,
                    'free_energy_probe': 2 * len(probes)}:
        raise AssertionError('launch counts of the standalone launchers: %s'
                             % launches)

    # each shape within 4e-6 of plain (the 1-element one on the scalar path
    # alone, the others on the 16-byte path and its tail)
    for s, got in got_normal.items():
        want = samplers.normal_sample_reference(5, s, 'cuda')
        d = (got - want).abs()
        ulps = float((d / torch.finfo(torch.float32).eps
                      / want.abs().clamp(min=1.)).max())
        say('normal_sample %s: max|kernel-plain|=%.3g (%.1f ulp); mean %.4f, '
            'var %.4f' % (s, float(d.max()), ulps, float(got.mean()),
                          float(got.var()) if got.numel() > 1 else 0.))
        if not float(d.max()) <= 4e-6 * max(1., float(want.abs().max())):
            raise AssertionError('normal_sample kernel and plain disagree at '
                                 '%s' % (s,))
    got = got_normal[shape]
    n = got.numel()
    # ~30 f32 operations per normal (log, sqrt, cos and their scaling), and
    # one Philox an element on the integer lanes
    out['normal_sample'] = dict(
        err=float((got - samplers.normal_sample_reference(
            5, shape, 'cuda')).abs().max()),
        work=(0., 30. * n, 4. * n, PHILOX_INT_OPS['normal_sample'] * n),
        ms=event_ms(torch, lambda: samplers.normal_sample(5, shape, 'cuda'),
                    50),
        plain_ms=event_ms(torch, lambda: samplers.normal_sample_reference(
            5, shape, 'cuda'), 5),
        # a yardstick: other numbers from another generator, same shape
        library_ms=event_ms(torch, lambda: torch.randn(
            shape, generator=g, device='cuda'), 50),
        # device times alone (a CUDA graph of calls: no host launch time)
        device_ms=graph_ms(torch, lambda: samplers.normal_sample(
            5, shape, 'cuda')),
        library_device_ms=graph_ms(torch, lambda: torch.randn(
            shape, device='cuda')))
    out['normal_sample']['bound_parts'] = bound_parts(
        *out['normal_sample']['work'])

    got, probs = got_counts, means / N_SAMPLES
    want = samplers.multinomial_sample_reference(6, means, N_SAMPLES)
    rows_equal = int((got == want).all(dim=1).sum())
    say('multinomial_sample (%d, %d) n=%d: %d of %d rows of counts equal, '
        'max|kernel-plain|=%g; row sums %s' % (
            CIFAR_B, MRBM[1], N_SAMPLES, rows_equal, CIFAR_B,
            float((got - want).abs().max()),
            sorted(set(got.sum(1).tolist()))))
    if rows_equal != CIFAR_B or not bool((got.sum(1) == N_SAMPLES).all()):
        raise AssertionError('multinomial_sample kernel and plain disagree')
    out['multinomial_sample'] = dict(
        err=float((got - want).abs().max()),
        work=(0., 5. * means.numel() + 10. * CIFAR_B * N_SAMPLES,
              8. * means.numel()),
        ms=event_ms(torch, lambda: samplers.multinomial_sample(
            6, means, N_SAMPLES), 50),
        plain_ms=event_ms(torch, lambda: samplers.multinomial_sample_reference(
            6, means, N_SAMPLES), 5),
        # a yardstick: the same distribution from torch's own sampler
        library_ms=event_ms(torch, lambda: torch.distributions.Multinomial(
            N_SAMPLES, probs=probs, validate_args=False).sample(), 50))

    err = 0.
    for (label, V, H, probe, args), (fe, hh) in zip(probes, got_fe):
        fe_p, hh_p = probe.reference(*args)
        d = abs(float(fe) - float(fe_p))
        say('free_energy_probe %s %dx%d: fe %.4f vs plain %.4f (|d| %.3g); '
            'count vectors %s' % (label, V, H, float(fe), float(fe_p), d,
                                  'equal' if torch.equal(hh, hh_p.reshape(-1))
                                  else 'DIFFER'))
        if not d <= 1e-5 * max(1., abs(float(fe_p))) \
                or not torch.equal(hh, hh_p.reshape(-1)):
            raise AssertionError('free-energy probe kernel and plain '
                                 'disagree (%s)' % label)
        err = max(err, d)
        if label == 'M-RBM':
            # the draw, u = W.hh and x.u per row, and the visible terms:
            # no product (phase 18's count)
            out['free_energy_probe'] = dict(
                work=(0., 2. * V * H + 4. * CIFAR_B * V,
                      4. * (CIFAR_B * V + V * H + 2 * V + 2 * H)),
                ms=event_ms(torch, lambda: probe(*args), 20),
                plain_ms=event_ms(torch, lambda: probe.reference(*args), 5))
    out['free_energy_probe']['err'] = err
    for name, r in out.items():
        r['launches'] = launches[name]
        say('%s: %.4f ms per call, plain %.4f ms, library %s ms%s' % (
            name, r['ms'], r['plain_ms'], r.get('library_ms'),
            '; device time alone %.4f ms, torch.randn %.4f ms' % (
                r['device_ms'], r['library_device_ms'])
            if 'device_ms' in r else ''))
    return out


def cifar_naive_path(torch, tmpdir):
    """examples/dbm_cifar_naive.py stages 1 and 2 at their published widths
    through the public API on the card, on 3000 + 500 synthetic CIFAR rows
    (standardized; the SVD smoothing skipped).  Depth cuts: 2 epochs per
    stage (120 and 180 in the example); metrics every iteration (1000 and
    400 in the example) and validation and FEG every epoch on 5 batches
    (every 2 epochs on 50), so that they log within the run; no image
    summaries (not ported).  Returns the launch counts of each stage."""
    import numpy as np
    from boltzmann_machines_tpu_torch import GaussianRBM, MultinomialRBM
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        cd_epoch, reset_launches)
    X = make_cifar(3500, seed=42)
    X_train, X_val = standardize(X[:3000], X[3000:])
    n_iter = 2 * math.ceil(len(X_train) / CIFAR_B)
    metrics = dict(train_metrics_every_iter=1, val_metrics_every_epoch=1,
                   feg_every_epoch=1, n_batches_for_feg=5)
    grbm = GaussianRBM(
        n_visible=GRBM[0], n_hidden=GRBM[1], sigma=1., W_init=0.0008, vb_init=0.,
        hb_init=0., n_gibbs_steps=1, learning_rate=GRBM_LR,
        momentum=np.geomspace(0.5, 0.9, 8), max_epoch=2, batch_size=CIFAR_B,
        l2=GRBM_L2, sample_v_states=True, sample_h_states=True,
        sparsity_cost=0., dbm_first=True,
        metrics_config=dict(msre=True, feg=True, **metrics), verbose=True,
        display_filters=0, display_hidden_activations=0, v_shape=(32, 32, 3),
        dtype='float32', random_seed=1337, device='cuda',
        model_path=tmpdir + '/grbm/')
    reset_launches()
    t0 = time.perf_counter()
    grbm.fit(X_train, X_val)
    torch.cuda.synchronize()
    t_g = time.perf_counter() - t0
    g_launches = dict(cd_epoch.launches)
    # the PLL off: one cd_metrics launch a logged step
    expect = {'cd_gemm_act': 3 * n_iter, 'cd_softmax_sample': 0,
              'cd_bias_stats': n_iter, 'cd_assoc_update': n_iter,
              'cd_metrics': n_iter}
    say('G-RBM fit: 2 epochs, %d iterations in %.2f s; launches %s' % (
        grbm.iter_, t_g, g_launches))
    if g_launches != expect or grbm.iter_ != n_iter:
        raise AssertionError('G-RBM launch counts %s, schedule implies %s' % (
            g_launches, expect))
    check_msre(tmpdir + '/grbm/', 'G-RBM')
    Q_train = grbm.transform(X_train)
    Q_val = grbm.transform(X_val)
    if Q_train.shape != (len(X_train), GRBM[1]) \
            or not np.all(np.isfinite(Q_train)) or Q_train.min() < 0 \
            or Q_train.max() > 1:
        raise AssertionError('G-RBM transform: bad output')

    mrbm = MultinomialRBM(
        n_visible=MRBM[0], n_hidden=MRBM[1], n_samples=N_SAMPLES, W_init=0.01,
        hb_init=0., vb_init=0., n_gibbs_steps=1, learning_rate=MRBM_LR,
        momentum=np.geomspace(0.5, 0.9, 8), max_epoch=2, batch_size=CIFAR_B,
        l2=MRBM_L2, sample_h_states=True, sample_v_states=False,
        sparsity_cost=0., dbm_last=True,
        metrics_config=dict(msre=True, pll=True, feg=True, **metrics),
        verbose=True, display_hidden_activations=0, random_seed=1337,
        dtype='float32', device='cuda', model_path=tmpdir + '/mrbm/')
    reset_launches()
    t0 = time.perf_counter()
    mrbm.fit(Q_train, Q_val)
    torch.cuda.synchronize()
    t_m = time.perf_counter() - t0
    m_launches = dict(cd_epoch.launches)
    # the PLL on: two cd_metrics launches a logged step
    expect = {'cd_gemm_act': 3 * n_iter, 'cd_softmax_sample': 2 * n_iter,
              'cd_bias_stats': n_iter, 'cd_assoc_update': n_iter,
              'cd_metrics': 2 * n_iter}
    say('M-RBM fit: 2 epochs, %d iterations in %.2f s; launches %s' % (
        mrbm.iter_, t_m, m_launches))
    if m_launches != expect or mrbm.iter_ != n_iter:
        raise AssertionError('M-RBM launch counts %s, schedule implies %s' % (
            m_launches, expect))
    check_msre(tmpdir + '/mrbm/', 'M-RBM')
    pll = [v for _, v in read_tag(tmpdir + '/mrbm/logs/train/scalars.jsonl',
                                  'pseudo_loglikelihood')]
    feg = read_tag(tmpdir + '/mrbm/logs/val/scalars.jsonl', 'free_energy_gap')
    say('  M-RBM train pll per epoch %s; val feg %s' % (pll, feg))
    if len(pll) != 2 or not all(math.isfinite(v) and v <= 0 for v in pll) \
            or len(feg) != 2 or not all(math.isfinite(v) for _, v in feg):
        raise AssertionError('M-RBM pll / feg not finite')
    G = mrbm.transform(Q_val)
    dev = float(np.abs(G.sum(1) - 1.).max())
    say('M-RBM transform %s: rows sum to 1 within %.2g' % (G.shape, dev))
    if G.shape != (len(X_val), MRBM[1]) or not dev <= 1e-5 or G.min() < 0:
        raise AssertionError('M-RBM transform: rows do not sum to 1')

    for cls, model, name, X_chk in ((GaussianRBM, grbm, 'grbm', X_val),
                                    (MultinomialRBM, mrbm, 'mrbm', Q_val)):
        r1 = cls.load_model(tmpdir + '/' + name + '/', device='cuda')
        r2 = cls.load_model(tmpdir + '/' + name + '/', device='cuda')
        s0, s1 = model.get_params_arrays(), r1.get_params_arrays()
        if set(s0) != set(s1) or any(not np.array_equal(s0[k], s1[k])
                                     for k in s0) \
                or r1._state.W.device.type != 'cuda':
            raise AssertionError('%s: load_model changed the state' % name)
        if not np.array_equal(r1.transform(X_chk), r2.transform(X_chk)):
            raise AssertionError('%s: loaded models transform differently'
                                 % name)
    say('save / load_model(device="cuda"): both models, 7 state arrays '
        'identical, transform reproducible')
    return g_launches, m_launches


def check_msre(model_dir, label):
    msre = [v for _, v in read_tag(model_dir + 'logs/train/scalars.jsonl',
                                   'mean_squared_reconstruction_error')]
    say('  %s train msre per epoch %s' % (label, msre))
    if len(msre) != 2 or not all(map(math.isfinite, msre)) \
            or not msre[1] < msre[0]:
        raise AssertionError('%s msre not finite and falling: %s' % (label,
                                                                     msre))


# the device kernel of each launch name (a pattern of the profiler's name,
# demangled or not), where it is not <name>_kernel: the association entry
# points run the one kernel of csrc/assoc_tc.cuh, cd_bias_stats and
# cd_stats_sums one kernel body, told apart by its kSums argument, and
# cd_metrics three kernels (its first launch, then the pass over W)
KERNEL_SYMBOLS = {'cd_metrics': r'cd_metrics_(?:fe_|draw_)?kernel',
                  'cd_assoc_update': r'assoc_kernel',
                  'cd_assoc_stats': r'assoc_kernel',
                  'dbm_assoc_update': r'assoc_kernel',
                  'cd_bias_stats':
                      r'cd_bias_stats_kernel(?:<\d, (?:false|0)>|ILi\dELb0E)',
                  'cd_stats_sums':
                      r'cd_bias_stats_kernel(?:<\d, (?:true|1)>|ILi\dELb1E)'}


def profile_kernels(torch, fn, names=None, wall=None):
    """Device microseconds per launch of each kernel of `names` (default:
    the CD epoch's) over one call of `fn` (torch.profiler), and the device
    busy share of the call: those kernels' device time over the wall time
    in seconds of the same call run without the profiler (the profiler's
    own host work would lengthen a profiled wall): `wall`, where a timing
    phase measured it, else the best of three runs here.  None where the
    profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile
    from boltzmann_machines_tpu_torch.ops.cd_epoch import KERNELS
    names = KERNELS if names is None else names
    if wall is None:
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = min(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per, busy = {}, 0.
    for ev in prof.key_averages():
        t = getattr(ev, 'device_time_total', None)
        if t is None:
            t = getattr(ev, 'cuda_time_total', 0.)
        for name in names:
            if re.search(KERNEL_SYMBOLS.get(name, name + '_kernel'),
                         ev.key):
                us, n = per.get(name, (0., 0))
                per[name] = (us + t, n + ev.count)
                busy += t
    if not busy:
        return None, None
    return ({k: round(us / n, 1) for k, (us, n) in per.items()},
            busy * 1e-6 / wall)


def cifar_timings(torch):
    """ms per step of each stage, kernels vs plain version in turns (plain,
    kernel, plain, kernel, kernel, plain; the first run of each a warm-up),
    sampling as on the path and off, metrics off the cadence; then one
    profiled kernel run per stage, and torch.matmul on the step's X.W
    product (B x V x H) as a yardstick."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        cd_epoch, cd_epoch_reference)
    nb = 10
    fns = {'kernel': cd_epoch, 'plain': cd_epoch_reference}
    out = {}
    for name, (V, H), lr, w_init, make_cfg in (
            ('grbm', GRBM, GRBM_LR, 0.0008,
             lambda smp: grbm_cfg(*GRBM, smp, 10 ** 6, False)),
            ('mrbm', MRBM, MRBM_LR, 0.01,
             lambda smp: mrbm_cfg(smp, 10 ** 6))):
        X = cifar_inputs(torch, nb, name, seed=5)
        state = cifar_state(torch, V, H, w_init)
        for sample in (True, False):
            cfg = make_cfg(sample)
            times = {'kernel': [], 'plain': []}
            for which in ('plain', 'kernel', 'plain', 'kernel', 'kernel',
                          'plain'):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[which](cfg, state, X, lr, MOMENTUM, 5, 0)
                torch.cuda.synchronize()
                times[which].append(time.perf_counter() - t0)
            for which, ts in times.items():
                out[(name, sample, which)] = 1e3 * min(ts[1:]) / nb
                say('%s %dx%d B=%d sampling %s %s: %.4f ms/step (runs %s)' % (
                    name, V, H, CIFAR_B, 'on' if sample else 'off', which,
                    out[(name, sample, which)],
                    ' '.join('%.4f' % x for x in ts)))
        cfg = make_cfg(True)
        per, busy = profile_kernels(torch, lambda: cd_epoch(
            cfg, state, X, lr, MOMENTUM, 5, 0))
        out[(name, 'kernel_us')], out[(name, 'busy')] = per, busy
        say('%s per-kernel device us per launch %s; device busy %s' % (
            name, per, 'not measured' if busy is None else '%.1f%%' % (
                100. * busy)))
        W = state['W']
        out[(name, 'matmul_ms')] = event_ms(torch, lambda: X[0] @ W, 20)
        say('%s torch.matmul (%d x %d) @ (%d x %d): %.4f ms' % (
            name, CIFAR_B, V, V, H, out[(name, 'matmul_ms')]))
    return out


# ---------------------------------------------------------------------- #
# the data-parallel slice: the RBM epoch on torch.distributed             #
# ---------------------------------------------------------------------- #
# the local batches of two ranks: rbm_mnist's batch 256 at 784 x 1024, and
# dbm_cifar's G-RBM batch 100 at 3072 x 7800 (Gaussian, sigma 1, dbm_first)
DP_WORLD = 2
DP_SHAPES = (('784x1024', (V, H), 256 // DP_WORLD, 'bernoulli', 1.),
             ('3072x7800', GRBM_WIDE, CIFAR_B // DP_WORLD, 'gaussian', 2.))
# Stats kernels vs plain on the same inputs, sampling off: every sum runs
# over the local batch of B rows, each term within a few ulps on either
# side, so |d| <= 1e-5 B + 1e-5 |ref|; v_means as the epoch's state
# (1e-5 + 1e-5 |ref|).
STATS_TOL = {'sums': (1e-5, 1e-5), 'v_means': (1e-5, 1e-5)}


def stats_work(V, H, B, k=1):
    """(product operations, other f32 operations, bytes) of one stats
    call: the 1 + 2k chain products and the two association products (2 B V
    H each); X, W and the biases read once, the association, the three sums
    and v_means written once.  Philox (integer work) is not counted."""
    gemm_flops = 2. * B * V * H * (1 + 2 * k + 2)
    nbytes = 4. * (2 * B * V + 2 * V * H + 2 * V + 3 * H)
    return gemm_flops, 0., nbytes


def dp_inputs(torch, label, B, n, seed):
    """(n, B, V) local batches of one shape of DP_SHAPES."""
    if label == '784x1024':
        X = make_data(n * B, seed=seed).reshape(n, B, V)
        return torch.as_tensor(X, device='cuda')
    return cifar_inputs(torch, n, 'grbm', seed=seed)[:, :B].contiguous()


def stats_vs_plain(torch):
    """The stats kernels (#7, with #6 folded in) against their plain version
    at DP_SHAPES, shards 0 and 1, k = 0 and 1.  Sampling off: every sum
    within STATS_TOL (at k = 0 the association and the bias sums exactly
    0).  Sampling on: one pass's states draw by draw under each shard
    (compare_passes), and at shard 0 one step's sums equal the CD epoch
    kernels' at the same (seed, it) bit for bit: the epoch at lr 1,
    momentum 0, no L2 or sparsity leaves dW = assoc / B, dvb = dvb_sum / B,
    q = h_sum.  Returns {shape: max |assoc kernel - plain|}."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        CDEpochConfig, cd_epoch)
    from boltzmann_machines_tpu_torch.ops.cd_stats import (
        cd_stats_reference, make_cd_stats_kernel)
    err = {}
    for label, (Vs, Hs), B, visible, up in DP_SHAPES:
        sigma = 1. if visible == 'gaussian' else None
        X = dp_inputs(torch, label, B, 5, seed=13)
        # the W_init of each path: rbm_mnist's 0.01, the G-RBM's 0.0008
        state = cifar_state(torch, Vs, Hs, 0.01 if Vs == V else 0.0008,
                            seed=17)
        state['vb'] += 0.1
        state['hb'] -= 0.1
        worst, exceed = 0., []
        for k in (0, 1):
            fn = make_cd_stats_kernel(Vs, Hs, B, k, False, False, up, 1.,
                                      visible=visible, sigma=sigma)
            for shard in (0, 1):
                got, aux = fn(state, X[shard], 7, 3, shard)
                want, aux_p = cd_stats_reference(fn.config, state, X[shard],
                                                 7, 3, shard)
                torch.cuda.synchronize()
                pairs = [(key, got[key], want[key], 'sums') for key in want]
                pairs.append(('v_means', aux['v_means'], aux_p['v_means'],
                              'v_means'))
                for key, a, b, tol in pairs:
                    atol, rtol = STATS_TOL[tol]
                    d = (a - b).abs()
                    if tol == 'sums':
                        atol *= B
                    if float((d - atol - rtol * b.abs()).max()) > 0:
                        exceed.append((k, shard, key, float(d.max())))
                    if key == 'assoc':
                        worst = max(worst, float(d.max()))
                if k == 0 and any(bool(got[key].any()) for key in
                                  ('assoc', 'dvb_sum', 'dhb_sum')):
                    exceed.append((k, shard, 'k = 0 sums not zero'))
        say('stats %s, local batch %d, sampling off, k 0 and 1, shards 0 and '
            '1: max|assoc kernel-plain|=%.3g' % (label, B, worst))
        if exceed:
            raise AssertionError('stats kernels and plain version disagree '
                                 '(%s): %s' % (label, exceed))
        err[label] = worst

        fn = make_cd_stats_kernel(Vs, Hs, B, 1, True, True, up, 1.,
                                  visible=visible, sigma=sigma)
        H0 = (torch.rand((3, B, Hs), device='cuda') < 0.5).float()
        for shard in (0, 1):
            compare_passes(torch, 'stats %s shard %d' % (label, shard),
                           fn.config, 'h', X, state['W'], state['hb'], 3,
                           shard)
            compare_passes(torch, 'stats %s shard %d' % (label, shard),
                           fn.config, 'v', H0, state['W'] * 10.,
                           state['vb'], 3, shard)
        s0, _ = fn(state, X[0], 11, 5, 0)
        ecfg = CDEpochConfig(Vs, Hs, 1, True, True, up, 1., 0., 0.1, 0., 0.,
                             10 ** 6, False, visible, sigma)
        zero = {key: torch.zeros_like(v) for key, v in state.items()}
        ep = cd_epoch(ecfg, dict(zero, W=state['W'], vb=state['vb'],
                                 hb=state['hb']), X[:1], 1., 0., 11, 4)[0]
        s1, _ = fn(state, X[0], 11, 5, 1)
        n = torch.tensor(float(B), device='cuda')
        same = (torch.equal(ep['dW'], s0['assoc'] / n)
                and torch.equal(ep['dvb'], s0['dvb_sum'] / n)
                and torch.equal(ep['q_means'], s0['h_sum']))
        differ = not torch.equal(s1['h_sum'], s0['h_sum'])
        say('stats %s sampling on: shard 0 sums %s the CD epoch kernels\' at '
            'the same (seed, it); shard 1 %s' % (
                label, 'equal' if same else 'DIFFER from',
                'draws other states' if differ else 'draws THE SAME'))
        if not (same and differ):
            raise AssertionError('stats %s: shard 0 draws are not the epoch '
                                 'kernels\' or shard 1 repeats them' % label)
    return err


def bernoulli_vs_plain(torch):
    """``bernoulli_sample`` driven once at (10, 1024) (rbm_mnist's hidden
    draw), (100, 7800) (dbm_cifar's G-RBM's), the ragged
    SAMPLER_EDGE_SHAPES and on a contiguous view 4 bytes past a 16-byte
    boundary (the scalar path) between a reset and a read of its launch
    count, each output bit for bit against the plain version (an int seed
    and a two-word key); then timed per call at (100, 7800) beside the
    plain version and torch.bernoulli."""
    from boltzmann_machines_tpu_torch.ops import samplers
    g = torch.Generator(device='cuda')
    g.manual_seed(5)
    wide = (CIFAR_B, GRBM_WIDE[1])
    cases = [('%s' % (s,), 12345 if s == (10, H) else (7, 99),
              torch.rand(s, generator=g, device='cuda'))
             for s in ((10, H), wide) + SAMPLER_EDGE_SHAPES]
    flat = torch.rand(7 * 1001 + 1, generator=g, device='cuda')
    cases.append(('(7, 1001) at a 4-byte offset', 99,
                  flat[1:].view(7, 1001)))
    torch.cuda.synchronize()
    samplers.reset_launches()
    got = [samplers.bernoulli_sample(seed, p) for _, seed, p in cases]
    torch.cuda.synchronize()
    launches = samplers.bernoulli_sample.launches['bernoulli_sample']
    for (label, seed, p), s in zip(cases, got):
        want = samplers.bernoulli_sample_reference(seed, p)
        n_diff = int((s != want).sum())
        say('bernoulli_sample %s seed %s: %d of %d states differ from plain; '
            'mean %.4f (p %.4f)' % (label, seed, n_diff, p.numel(),
                                    float(s.mean()), float(p.mean())))
        if n_diff:
            raise AssertionError('bernoulli_sample kernel and plain differ')
    if launches != len(cases):
        raise AssertionError('bernoulli_sample launches %d' % launches)
    p, small = cases[1][2], cases[0][2]
    n = p.numel()
    out = dict(
        launches=launches, err=0.,
        work=(0., 1. * n, 8. * n, PHILOX_INT_OPS['bernoulli_sample'] * n),
        ms=event_ms(torch, lambda: samplers.bernoulli_sample(7, p), 50),
        plain_ms=event_ms(torch, lambda: samplers.bernoulli_sample_reference(
            7, p), 5),
        # one PyTorch call computing the same function (other numbers)
        library_ms=event_ms(torch, lambda: torch.bernoulli(p, generator=g),
                            50),
        small_ms=event_ms(torch, lambda: samplers.bernoulli_sample(
            7, small), 50),
        # device times alone (a CUDA graph of calls: no host launch time)
        device_ms=graph_ms(torch, lambda: samplers.bernoulli_sample(7, p)),
        library_device_ms=graph_ms(torch, lambda: torch.bernoulli(p)))
    out['bound_parts'] = bound_parts(*out['work'])
    say('bernoulli_sample %s: %.4f ms per call, plain %.4f ms, '
        'torch.bernoulli %.4f ms; (10, %d) %.4f ms; device time alone %.4f '
        'ms, torch.bernoulli %.4f ms' % (
            wide, out['ms'], out['plain_ms'], out['library_ms'], H,
            out['small_ms'], out['device_ms'], out['library_device_ms']))
    return out


def stats_timings(torch):
    """ms per stats call at DP_SHAPES with sampling as on each path
    (rbm_mnist: hidden states; dbm_cifar's G-RBM: both), kernel and plain
    version by CUDA events, with sampling off beside them, torch.matmul on
    the call's X.W product as a yardstick, and the kernels' device times
    (torch.profiler)."""
    from boltzmann_machines_tpu_torch.ops.cd_stats import (
        KERNELS, cd_stats_reference, make_cd_stats_kernel)
    out = {}
    for label, (Vs, Hs), B, visible, up in DP_SHAPES:
        sigma = 1. if visible == 'gaussian' else None
        X = dp_inputs(torch, label, B, 1, seed=19)[0]
        state = cifar_state(torch, Vs, Hs, 0.01, seed=23)
        r = {}
        for sample in (True, False):
            fn = make_cd_stats_kernel(Vs, Hs, B, 1,
                                      sample and visible == 'gaussian',
                                      sample, up, 1., visible=visible,
                                      sigma=sigma)
            tag = '' if sample else '_sampling_off'
            r['ms' + tag] = event_ms(
                torch, lambda: fn(state, X, 5, 1, 1), 20)
            r['plain_ms' + tag] = event_ms(torch, lambda: cd_stats_reference(
                fn.config, state, X, 5, 1, 1), 5)
            if sample:
                r['kernel_us'], r['busy'] = profile_kernels(
                    torch, lambda: [fn(state, X, 5, i, 1) for i in range(10)],
                    KERNELS)
        r['library_ms'] = event_ms(torch, lambda: X @ state['W'], 20)
        say('stats %s local batch %d: kernel %.4f ms (sampling off %.4f), '
            'plain %.4f ms (off %.4f), torch.matmul X.W %.4f ms; per-kernel '
            'us %s, device busy %s' % (
                label, B, r['ms'], r['ms_sampling_off'], r['plain_ms'],
                r['plain_ms_sampling_off'], r['library_ms'], r['kernel_us'],
                'not measured' if r['busy'] is None
                else '%.1f%%' % (100. * r['busy'])))
        out[label] = r
    return out


def grbm_wide(sample, every, **kw):
    """dbm_cifar.py's stage-2 G-RBM (3072 x 7800, sigma 1, k 1, dbm_first,
    lr 5e-4, batch 100) on the card, as keyword arguments."""
    import numpy as np
    cfg = dict(n_visible=GRBM_WIDE[0], n_hidden=GRBM_WIDE[1], sigma=1.,
               W_init=0.0008, vb_init=0., hb_init=0., n_gibbs_steps=1,
               learning_rate=GRBM_LR,
               momentum=[float(m) for m in np.geomspace(0.5, 0.9, 8)],
               batch_size=CIFAR_B, l2=GRBM_L2, sample_v_states=sample,
               sample_h_states=sample, sparsity_cost=0., dbm_first=True,
               metrics_config=dict(msre=True, pll=True,
                                   train_metrics_every_iter=every),
               random_seed=1337, device='cuda')
    cfg.update(kw)
    return cfg


def dp_world1(torch, tmpdir):
    """(a) The data-parallel epoch driven directly (``_train_epoch_shardmap``)
    on a one-rank NCCL group at 3072 x 7800, batch 100: with sampling off
    and PLL every step, 5 steps against the single-device CD epoch kernels
    on the same state and batches (CIFAR_TOL; the PLL flips are the same
    Philox draws); then ms per step of the two, in turns, sampling on (the
    path) and off, metrics off the cadence, and the stats kernels' device
    times over a data-parallel epoch."""
    import torch.distributed as dist
    from boltzmann_machines_tpu_torch import GaussianRBM, parallel
    from boltzmann_machines_tpu_torch.ops.cd_stats import KERNELS
    info = parallel.initialize('file://' + tmpdir + '/store_w1', 1, 0)
    out = {}
    try:
        say('one-rank NCCL group: %s' % json.dumps(info))
        rbm = GaussianRBM(**grbm_wide(False, 1, model_path=tmpdir + '/w1/'))
        rbm.set_mesh(parallel.make_mesh())
        rbm._ensure_state()
        X = cifar_inputs(torch, 5, 'grbm', seed=3)
        start = {key: v.clone() for key, v in rbm._state.as_dict().items()}
        want = rbm._cd_epoch_program(1)(start, X, GRBM_LR, MOMENTUM, 9, 0)
        rows = rbm._train_epoch_shardmap(X, None, GRBM_LR, MOMENTUM, 1, 9)
        torch.cuda.synchronize()
        got = (rbm._state.as_dict(),) + tuple(rows[0])
        d = diffs(got, want, CIFAR_B, CIFAR_TOL)
        say('world-1 data-parallel epoch vs CD epoch kernels, 3072x7800, 5 '
            'steps, sampling off: max|d| %s' % ' '.join(
                '%s=%.3g' % (key, v[0]) for key, v in d.items()))
        bad = [key for key, v in d.items() if v[1] > 0]
        if bad:
            raise AssertionError('world-1 epoch and CD epoch kernels '
                                 'disagree on %s: %s' % (bad, d))
        out['err'] = d['W'][0]

        nb = 10
        Xt = cifar_inputs(torch, nb, 'grbm', seed=5)
        for sample in (True, False):
            rbm.set_params(sample_v_states=sample, sample_h_states=sample,
                           metrics_config=dict(rbm.metrics_config, pll=False,
                                               train_metrics_every_iter=10 ** 6))
            epoch = rbm._cd_epoch_program(1)
            fns = {'epoch': lambda: epoch(rbm._state.as_dict(), Xt, GRBM_LR,
                                          MOMENTUM, 5, 0),
                   'data_parallel': lambda: rbm._train_epoch_shardmap(
                       Xt, None, GRBM_LR, MOMENTUM, 1, 5)}
            times = {'epoch': [], 'data_parallel': []}
            for which in ('epoch', 'data_parallel', 'epoch', 'data_parallel',
                          'data_parallel', 'epoch'):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[which]()
                torch.cuda.synchronize()
                times[which].append(time.perf_counter() - t0)
            for which, ts in times.items():
                out[(which, sample)] = 1e3 * min(ts[1:]) / nb
                say('world-1 %s step 3072x7800 B=%d sampling %s: %.4f ms/step '
                    '(runs %s)' % (which, CIFAR_B, 'on' if sample else 'off',
                                   out[(which, sample)],
                                   ' '.join('%.4f' % x for x in ts)))
            if sample:
                out['kernel_us'], out['busy'] = profile_kernels(
                    torch, fns['data_parallel'], KERNELS)
                say('world-1 data-parallel epoch per-kernel device us %s; '
                    'device busy %s' % (out['kernel_us'], 'not measured'
                                        if out['busy'] is None else '%.1f%%'
                                        % (100. * out['busy'])))
    finally:
        dist.destroy_process_group()
    return out


def dp_rank(rank, world, tmpdir):
    """One rank of the 2-rank fits, in a process of its own (``python3
    chip_smoke.py --dp-rank RANK WORLD TMPDIR``, started by ``dp_fit``): joins the gloo group, fits each job of jobs.json on the
    mesh with the launch counts set to 0 just before and read just after,
    and writes its state arrays and counts."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from boltzmann_machines_tpu_torch import (BernoulliRBM, GaussianRBM,
                                              parallel)
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        cd_epoch, reset_launches as reset_epoch_launches)
    from boltzmann_machines_tpu_torch.ops.cd_stats import (
        cd_stats, reset_launches as reset_stats_launches)
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize('file://' + tmpdir + '/store_dp', world, rank,
                        backend='gloo')
    try:
        with open(tmpdir + '/jobs.json') as f:
            jobs = json.load(f)
        out = {}
        for job in jobs:
            data = np.load('%s/%s.npz' % (tmpdir, job['name']))
            cls = {'GaussianRBM': GaussianRBM,
                   'BernoulliRBM': BernoulliRBM}[job['cls']]
            rbm = cls(model_path='%s/%s_rank%d/' % (tmpdir, job['name'], rank),
                      **job['cfg'])
            rbm.set_mesh(parallel.make_mesh())
            torch.cuda.synchronize()
            reset_epoch_launches()
            reset_stats_launches()
            t0 = time.perf_counter()
            rbm.fit(data['X'], data['X_val'])
            torch.cuda.synchronize()
            out[job['name']] = dict(
                seconds=time.perf_counter() - t0, iter_=rbm.iter_,
                stats=dict(cd_stats.launches), epoch=dict(cd_epoch.launches))
            np.savez('%s/%s_out%d.npz' % (tmpdir, job['name'], rank),
                     **rbm.get_params_arrays())
        with open('%s/rank%d.json' % (tmpdir, rank), 'w') as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def dp_fit(torch, tmpdir):
    """(b) The data-parallel fit through the public API: two ranks, each a
    process of its own on the one card, over gloo (NCCL refuses two ranks
    on one GPU; gloo's all_reduce takes CUDA tensors), every rank calling
    ``set_mesh(make_mesh())`` and ``fit`` with the whole data.

    G-RBM 3072 x 7800 with dbm_cifar.py's stage-2 hyperparameters (both
    states sampled), 2 epochs over 3050 + 500 synthetic CIFAR rows (30 full
    batches and a remainder of 50 per epoch; 80 epochs and the real
    features in the example), metrics every step: launch counts exact on
    each rank (3 + 2k stats launches per full step, the remainder through
    the CD epoch kernels), the ranks' states bit for bit equal, msre
    falling, nothing written by rank 1, and rank 0's checkpoint loaded with
    ``load_model(device='cuda')`` and transforming.  Then the same fit at
    784 x 1024, batch 256, sampling off (rbm_mnist's hyperparameters),
    against the single-process CD epoch kernels' fit on the same data:
    state within TOL, msre stream within 1e-6 + 1e-5 |ref|.  Returns the
    ranks' counts and timings."""
    import numpy as np
    from boltzmann_machines_tpu_torch import BernoulliRBM, GaussianRBM
    X = make_cifar(3550, seed=42)
    X_train, X_val = standardize(X[:3050], X[3050:])
    np.savez(tmpdir + '/grbm.npz', X=X_train, X_val=X_val)
    Xm = make_data(2560 + 100 + 500, seed=29)
    np.savez(tmpdir + '/mnist.npz', X=Xm[:2660], X_val=Xm[2660:])
    mnist_cfg = dict(
        n_visible=V, n_hidden=H, W_init=0.01, vb_init=0., hb_init=0.,
        n_gibbs_steps=1, learning_rate=LR, momentum=[0.5, 0.9],
        max_epoch=2, batch_size=256, l2=1e-5, sample_v_states=False,
        sample_h_states=False, sparsity_target=0.1, sparsity_cost=1e-5,
        sparsity_damping=0.9, metrics_config=dict(
            msre=True, train_metrics_every_iter=2), random_seed=1337,
        verbose=False)
    jobs = [dict(name='grbm', cls='GaussianRBM',
                 cfg=grbm_wide(True, 1, max_epoch=2, verbose=True)),
            dict(name='mnist', cls='BernoulliRBM',
                 cfg=dict(mnist_cfg, device='cuda'))]
    with open(tmpdir + '/jobs.json', 'w') as f:
        json.dump(jobs, f)
    t0 = time.perf_counter()
    # plain child processes of this script, each waited for (and killed if
    # the fit fails or overruns), so that no process outlives the smoke:
    # multiprocessing's spawn would also start a resource tracker that ends
    # only after this process has
    procs = []
    try:
        for rank in range(DP_WORLD):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), '--dp-rank',
                 str(rank), str(DP_WORLD), tmpdir]))
        deadline = time.time() + 600
        while any(p.poll() is None for p in procs):
            if time.time() > deadline:
                raise AssertionError('the 2-rank fit did not end in 600 s')
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
        rcs = [p.poll() for p in procs]
        if rcs != [0] * DP_WORLD:
            raise AssertionError('the 2-rank fit failed: rank exit codes %s'
                                 % rcs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    say('2-rank fits (gloo, one card): %.1f s with process start-up' % (
        time.perf_counter() - t0))
    ranks = []
    for r in range(DP_WORLD):
        with open('%s/rank%d.json' % (tmpdir, r)) as f:
            ranks.append(json.load(f))
    out = {'ranks': ranks}

    # G-RBM: launch counts, replicas, msre, files, load_model
    n_full, n_iter = 3050 // CIFAR_B, 2 * (3050 // CIFAR_B + 1)
    expect_stats = {'cd_gemm_act': 3 * 2 * n_full, 'cd_stats_sums': 2 * n_full,
                    'cd_assoc_stats': 2 * n_full}
    # the remainder batch of each epoch through the CD epoch kernels, PLL on
    expect_epoch = {'cd_gemm_act': 3 * 2, 'cd_softmax_sample': 0,
                    'cd_bias_stats': 2, 'cd_assoc_update': 2,
                    'cd_metrics': 2 * 2}
    for r, rk in enumerate(ranks):
        g = rk['grbm']
        say('G-RBM 3072x7800 rank %d: %d iterations in %.2f s; stats '
            'launches %s; epoch-kernel launches %s' % (
                r, g['iter_'], g['seconds'], g['stats'], g['epoch']))
        if g['stats'] != expect_stats or g['epoch'] != expect_epoch \
                or g['iter_'] != n_iter:
            raise AssertionError('rank %d launch counts %s / %s, schedule '
                                 'implies %s / %s' % (
                                     r, g['stats'], g['epoch'], expect_stats,
                                     expect_epoch))
    a, b = (np.load('%s/grbm_out%d.npz' % (tmpdir, r)) for r in (0, 1))
    same = all(np.array_equal(a[key], b[key]) for key in a.files)
    say('G-RBM ranks 0 and 1: %d state arrays %s' % (
        len(a.files), 'bit for bit equal' if same else 'DIFFER'))
    if not same:
        raise AssertionError('the ranks\' states differ')
    check_msre(tmpdir + '/grbm_rank0/', 'G-RBM 2-rank')
    for name in ('grbm', 'mnist'):
        if os.path.exists('%s/%s_rank1/' % (tmpdir, name)):
            raise AssertionError('rank 1 wrote files (%s)' % name)
    loaded = GaussianRBM.load_model(tmpdir + '/grbm_rank0/', device='cuda')
    s = loaded.get_params_arrays()
    Q = loaded.transform(X_val)
    if any(not np.array_equal(s[key], a[key]) for key in a.files) \
            or loaded._state.W.device.type != 'cuda' \
            or Q.shape != (len(X_val), GRBM_WIDE[1]) \
            or not np.all(np.isfinite(Q)) or Q.min() < 0 or Q.max() > 1:
        raise AssertionError('rank 0\'s checkpoint does not load or '
                             'transform')
    say('rank 0 only wrote files; load_model(device="cuda") gives its state; '
        'transform %s in [%.3f, %.3f]' % (Q.shape, Q.min(), Q.max()))

    # 784 x 1024, sampling off: 2 ranks vs the single-process epoch kernels
    ref = BernoulliRBM(device='cuda', model_path=tmpdir + '/mnist_ref/',
                       **mnist_cfg)
    ref.fit(Xm[:2660], Xm[2660:])
    m0 = np.load('%s/mnist_out0.npz' % tmpdir)
    excess, worst = {}, {}
    for key, v in ref.get_params_arrays().items():
        atol, rtol = TOL['q_means' if key.endswith('q_means') else 'state']
        if key.endswith('q_means'):
            atol *= 256
        d = np.abs(m0[key] - v)
        worst[key] = float(d.max())
        excess[key] = float((d - atol - rtol * np.abs(v)).max())
    msre_dp = read_tag(tmpdir + '/mnist_rank0/logs/train/scalars.jsonl',
                       'mean_squared_reconstruction_error')
    msre_ref = read_tag(tmpdir + '/mnist_ref/logs/train/scalars.jsonl',
                        'mean_squared_reconstruction_error')
    d_msre = max(abs(x[1] - y[1]) - 1e-6 - 1e-5 * abs(y[1])
                 for x, y in zip(msre_dp, msre_ref))
    say('784x1024 B=256 sampling off, 2 ranks vs single-process epoch '
        'kernels: max|d| %s; msre %s vs %s' % (
            ' '.join('%s=%.3g' % (key.split('/')[-1], v)
                     for key, v in worst.items()),
            [v for _, v in msre_dp], [v for _, v in msre_ref]))
    if any(e > 0 for e in excess.values()) or d_msre > 0 \
            or len(msre_dp) != len(msre_ref) or not msre_dp:
        raise AssertionError('2-rank 784x1024 fit and the single-process '
                             'fit disagree: %s' % excess)
    out['mnist_err'] = worst['weights/W']
    return out


# ---------------------------------------------------------------------- #
# the chain's products on the tensor-core tile, one launch per shape      #
# ---------------------------------------------------------------------- #
# cd_gemm_act at every product of the paths, both directions: (path, rows,
# V, H, pass, epilogue, multiplier, shard, PR 4's us per launch of the SIMT
# tile at that product, PERF.md sections 5-6, H100 80GB HBM3, 700 W)
CD_GEMM_SHAPES = (
    ('rbm_mnist', 10, 784, 1024, 'h', 'sigmoid', 1., 0, 79.7),
    ('rbm_mnist', 10, 784, 1024, 'v', 'sigmoid', 1., 0, 79.7),
    ('stats_784', 128, 784, 1024, 'h', 'sigmoid', 1., 1, 83.7),
    ('stats_784', 128, 784, 1024, 'v', 'sigmoid', 1., 1, 83.7),
    ('grbm', 100, 3072, 5000, 'h', 'sigmoid', 2., 0, 452.1),
    ('grbm', 100, 3072, 5000, 'v', 'gaussian', 1., 0, 452.1),
    ('mrbm', 100, 5000, 1000, 'h', 'pre', 1., 0, 383.0),
    ('mrbm', 100, 5000, 1000, 'v', 'sigmoid', 2., 0, 383.0),
    ('stats_7800', 50, 3072, 7800, 'h', 'sigmoid', 2., 1, 551.5),
    ('stats_7800', 50, 3072, 7800, 'v', 'gaussian', 1., 1, 551.5),
)
# dbm_gemm_act at the dbm_mnist DBM step, sample_v sweep and AIS beta
# (784-512-1024, 100 rows): (label, products as (W index, transposed),
# output width, epilogue, addend C, beta, PR 4's us per launch)
DBM_GEMM_SHAPES = (
    ('dbm_x_w0', ((0, False),), 512, 'identity', False, 1., 99.3),
    ('dbm_mf_h0', ((1, True),), 512, 'sigmoid_delta', True, 1., 99.3),
    ('dbm_mf_h1', ((1, False),), 1024, 'sigmoid_delta', False, 1., 99.3),
    ('dbm_gibbs_h0', ((0, False), (1, True)), 512, 'sample', False, 1.,
     99.3),
    ('dbm_gibbs_h1', ((1, False),), 1024, 'sample', False, 1., 99.3),
    ('dbm_gibbs_v', ((0, True),), 784, 'sample', False, 1., 99.3),
    ('ais_v', ((0, True),), 784, 'sample', False, 0.37, 113.),
    ('ais_h2', ((1, False),), 1024, 'sample', False, 0.37, 113.),
    ('ais_h1', ((0, False), (1, True)), 512, 'sample', False, 0.37, 113.),
    ('ais_lp_v', ((0, True),), 784, 'softplus_rows', False, 0.37, 113.),
    ('ais_lp_h2', ((1, False),), 1024, 'softplus_rows', False, 0.37, 113.),
)


def graph_ms(torch, fn, n=20, reps=5):
    """Device milliseconds per call of `fn`: a CUDA graph of n calls,
    replayed `reps` times between CUDA events, so host launch time is left
    out.  The first call runs on the capture stream, before the capture, so
    that the split-K workspace of that stream exists by then."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def gemm_bounds(M, K, N, extra_bytes):
    """The product's bounds: its operations on the tensor cores in 3xTF32
    (165 TFLOP/s) and on the SIMT cores in f32 (67), each against the bytes
    (A and W read once, the outputs written once) over 3.35 TB/s."""
    flops = 2. * M * K * N
    nbytes = 4. * (M * K + K * N) + extra_bytes
    t_b = 1e3 * nbytes / PEAK_BYTES
    out = {}
    for name, peak in (('3xtf32', PEAK_3XTF32), ('f32', PEAK_F32)):
        t_op = 1e3 * flops / peak
        out[name] = (max(t_op, t_b), 'operations' if t_op >= t_b else 'bytes')
    return out


def gemm_line(label, res):
    b3, bf = res['bound_3xtf32'], res['bound_f32']
    say('%s: max|kernel-plain| %.3g, draws differing %d, same-seed rerun '
        'bit-identical; %.4f ms per launch (SIMT tile, recorded: %.4f; one '
        'K slice %.4f), '
        'torch.matmul %.4f ms; bound %.4f ms in 3xTF32 at 165 TFLOP/s (%s), '
        '%.4f ms in f32 at 67 (%s), bytes term %.4f ms; splits %d, n_tile '
        '%d' % (label, res['err'], res['draws_differing'], res['ms'],
                res['pr4_ms'], res['one_slice_ms'], res['matmul_ms'], b3[0],
                b3[1], bf[0], bf[1], res['bytes_ms'], res['splits'],
                res['n_tile']))


def cd_gemm_shapes(torch):
    """cd_gemm_act alone at each product of CD_GEMM_SHAPES: against its
    plain version (means |d| <= 1e-5 + 1e-5 |ref|, Bernoulli states in <=
    1e-5 of draws plus one, Gaussian states |d| <= 1e-5 (1 + |v|), the
    tolerances of the pass comparisons), a second same-seed launch bit for
    bit, then timed beside torch.matmul on the same product."""
    from boltzmann_machines_tpu_torch.ops import gemm
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        ACT_GAUSSIAN, ACT_PRE, ACT_SIGMOID, _launch_gemm_act, library)
    from boltzmann_machines_tpu_torch.ops.philox import bernoulli, normal
    lib = library()
    g = torch.Generator(device='cuda')
    g.manual_seed(17)
    acts = {'sigmoid': ACT_SIGMOID, 'gaussian': ACT_GAUSSIAN, 'pre': ACT_PRE}
    out, counts = {}, {'cd_gemm_act': 0}
    for path, B, V, H, layer, epi, mult, shard, pr4 in CD_GEMM_SHAPES:
        f32 = dict(dtype=torch.float32, device='cuda')
        W = 0.05 * torch.randn((V, H), generator=g, **f32)
        K, N = (V, H) if layer == 'h' else (H, V)
        A = torch.randn((B, K), generator=g, **f32) if epi == 'gaussian' \
            and layer == 'h' else \
            (torch.rand((B, K), generator=g, **f32) < 0.3).float()
        bias = 0.1 * torch.randn(N, generator=g, **f32)
        sigma = torch.linspace(0.5, 2., N, **f32) if epi == 'gaussian' \
            else None
        act = acts[epi]
        sample = epi != 'pre'
        seed, it, sid = 29, 3, 1

        def run(means, states, splits=None):
            # the current stream: a graph capture's while timing
            stream = torch.cuda.current_stream().cuda_stream
            _launch_gemm_act(lib, stream, A, W, layer == 'v', bias, sigma,
                             mult, act, means, states, seed, it, sid, shard,
                             launches=counts, splits=splits)

        res = [(torch.empty((B, N), **f32),
                torch.empty((B, N), **f32) if sample else None)
               for _ in range(2)]
        for r in res:
            run(*r)
        acc = A @ W.T if layer == 'v' else A @ W
        if epi == 'gaussian':
            mu = mult * (acc * sigma + bias)
            st = mu + normal(seed, it, sid, mu.shape, 'cuda', shard) * sigma
        elif epi == 'pre':
            mu, st = mult * (acc + bias), None
        else:
            mu = torch.sigmoid(mult * (acc + bias))
            st = bernoulli(mu, seed, it, sid, shard)
        torch.cuda.synchronize()
        (m1, s1), (m2, s2) = res
        d = (m1 - mu).abs()
        err = float(d.max())
        ok = bool((d <= 1e-5 + 1e-5 * mu.abs()).all())
        moved = 0
        if epi == 'gaussian':
            ok = ok and float(((s1 - st).abs() / (1 + st.abs())).max()) \
                <= 1e-5
        elif sample:
            moved = int((s1 != st).sum())
            ok = ok and moved <= 1e-5 * st.numel() + 1
        same = torch.equal(m1, m2) and (not sample or torch.equal(s1, s2))
        label = 'cd_gemm_act %s %s pass (%d x %d -> %d, %s)' % (
            path, layer, B, K, N, epi)
        if not ok or not same:
            raise AssertionError('%s: kernel and plain version disagree (max '
                                 '|d| %.3g, %d draws, rerun identical %s)' % (
                                     label, err, moved, same))
        plan = gemm.gemm_plan(B, N, K, gemm.num_sms(A.device))
        bounds = gemm_bounds(B, K, N, 4. * (N * (2 if sigma is not None
                                                 else 1) +
                                            B * N * (2 if sample else 1)))
        r = dict(err=err, draws_differing=moved, pr4_ms=pr4 / 1e3,
                 ms=graph_ms(torch, lambda: run(*res[0])),
                 one_slice_ms=graph_ms(torch, lambda: run(*res[0], 1)),
                 matmul_ms=graph_ms(torch, (lambda: A @ W.T) if layer == 'v'
                                    else (lambda: A @ W)),
                 bound_3xtf32=bounds['3xtf32'], bound_f32=bounds['f32'],
                 bytes_ms=1e3 * (4. * (B * K + K * N)) / PEAK_BYTES,
                 splits=plan.splits, n_tile=plan.n_tile)
        gemm_line(label, r)
        out['%s_%s' % (path, layer)] = r
    return out


def dbm_gemm_shapes(torch):
    """dbm_gemm_act alone at each product of DBM_GEMM_SHAPES, as
    cd_gemm_shapes: means and the mean-field change |d| <= 1e-5 + 1e-5
    |ref|, states in <= 1e-5 of draws plus one, the softplus row sums within
    1e-4 + 1e-5 |ref| (sums of up to 1024 terms)."""
    import ctypes
    import torch.nn.functional as F
    from boltzmann_machines_tpu_torch.ops import dbm_ops, gemm
    from boltzmann_machines_tpu_torch.ops.philox import bernoulli
    lib = dbm_ops._library()
    g = torch.Generator(device='cuda')
    g.manual_seed(23)
    f32 = dict(dtype=torch.float32, device='cuda')
    V, H1, H2 = DBM_SIZES
    M = DBM_B
    Ws = (0.1 * torch.randn((V, H1), generator=g, **f32),
          0.1 * torch.randn((H1, H2), generator=g, **f32))
    acts = {'identity': dbm_ops.ACT_IDENTITY, 'sample': dbm_ops.ACT_SIGMOID,
            'sigmoid_delta': dbm_ops.ACT_SIGMOID_DELTA,
            'softplus_rows': dbm_ops.ACT_SOFTPLUS_ROWS}
    out = {}
    for label, prods, N, epi, with_c, beta, pr4 in DBM_GEMM_SHAPES:
        A = []
        for w, transposed in prods:
            K = Ws[w].shape[1] if transposed else Ws[w].shape[0]
            A.append(((torch.rand((M, K), generator=g, **f32) < 0.5).float(),
                      Ws[w], transposed))
        c = torch.randn((M, N), generator=g, **f32) if with_c else None
        bias = 0.1 * torch.randn(N, generator=g, **f32)
        old = torch.rand((M, N), generator=g, **f32)
        nblk = lib.bm_dbm_gemm_col_blocks(N)
        outs = [old.clone() if epi != 'softplus_rows'
                else torch.empty(2 * M * nblk, **f32) for _ in range(2)]
        ctrls = [torch.zeros(1, dtype=torch.int32, device='cuda')
                 for _ in range(2)]
        def make_args(o, ctrl, splits=None):
            a = dbm_ops._gemm_args(
                old, A, c=c, bias=bias, act=acts[epi], alpha=beta,
                gamma=beta, stream=torch.cuda.current_stream().cuda_stream,
                splits=splits)
            a.out = o.data_ptr()
            a.delta_bits = ctrl.data_ptr()
            a.sample, a.seed, a.it, a.stream_id = int(epi == 'sample'), 31, \
                4, 2
            a.alpha2 = 1.
            return a

        args = [make_args(o, ctrl) for o, ctrl in zip(outs, ctrls)]
        one_slice_args = make_args(outs[1], ctrls[1], 1)

        def run(a):
            stream = torch.cuda.current_stream().cuda_stream
            dbm_ops._check(lib.bm_dbm_gemm_act(ctypes.byref(a), stream),
                           'dbm_gemm_act')

        for a in args:
            run(a)
        acc = sum(lhs @ (W.T if t else W) for lhs, W, t in A)
        if c is not None:
            acc = acc + c
        moved = 0
        torch.cuda.synchronize()
        if epi == 'softplus_rows':
            got = outs[0].view(2, M, nblk).sum(2)
            want = torch.stack([F.softplus(b * (acc + bias)).sum(1)
                                for b in (beta, 1.)])
            d = (got - want).abs()
            ok = bool((d <= 1e-4 + 1e-5 * want.abs()).all())
        else:
            pre = beta * acc + beta * bias
            want = pre if epi == 'identity' else torch.sigmoid(pre)
            got = outs[0]
            if epi == 'sample':
                st = bernoulli(want, 31, 4, 2)
                moved = int((got != st).sum())
                d = torch.zeros(1, **f32)
                ok = moved <= 1e-5 * st.numel() + 1
            else:
                d = (got - want).abs()
                ok = bool((d <= 1e-5 + 1e-5 * want.abs()).all())
            if epi == 'sigmoid_delta':
                delta = float((want - old).abs().max())
                got_delta = float(ctrls[0].view(torch.float32))
                ok = ok and abs(got_delta - delta) <= 1e-5 + 1e-5 * delta
        err = float(d.max())
        same = torch.equal(outs[0], outs[1]) and torch.equal(ctrls[0],
                                                             ctrls[1])
        K = sum(lhs.shape[1] for lhs, _, _ in A)
        name = 'dbm_gemm_act %s (%d x %s -> %d, %s)' % (
            label, M, '+'.join(str(lhs.shape[1]) for lhs, _, _ in A), N, epi)
        if not ok or not same:
            raise AssertionError('%s: kernel and plain version disagree (max '
                                 '|d| %.3g, %d draws, rerun identical %s)' % (
                                     name, err, moved, same))
        plan = gemm.gemm_plan(M, N, [lhs.shape[1] for lhs, _, _ in A],
                              gemm.num_sms(old.device))
        if len(A) == 2:
            lhs = torch.cat([A[0][0], A[1][0]], 1)
            rhs = torch.cat([W.T if t else W for _, W, t in A], 0)
        else:
            lhs, rhs = A[0][0], (A[0][1].T if A[0][2] else A[0][1])
        extra = 4. * (N + M * N * (2 if with_c or epi == 'sigmoid_delta'
                                   else 1))
        bounds = gemm_bounds(M, K, N, extra)
        r = dict(err=err, draws_differing=moved, pr4_ms=pr4 / 1e3,
                 ms=graph_ms(torch, lambda: run(args[0])),
                 one_slice_ms=graph_ms(torch, lambda: run(one_slice_args)),
                 matmul_ms=graph_ms(torch, lambda: lhs @ rhs),
                 bound_3xtf32=bounds['3xtf32'], bound_f32=bounds['f32'],
                 bytes_ms=1e3 * 4. * (M * K + K * N) / PEAK_BYTES,
                 splits=plan.splits, n_tile=plan.n_tile)
        gemm_line(name, r)
        out[label] = r
    return out


def gemm_shapes(torch):
    """The phase of the tensor-core tile: every product of the paths, each
    kernel alone against its plain version and timed."""
    return dict(cd_gemm_shapes(torch), **dbm_gemm_shapes(torch))


# ---------------------------------------------------------------------- #
# the association kernel (csrc/assoc_tc.cuh), one launch per shape        #
# ---------------------------------------------------------------------- #
# Each association launch of the paths: (label, entry point, rows B (DBM:
# N = M), V, H, visible activations Gaussian, the former SIMT tile's us per
# launch as PERF.md section 6 records it (H100 80GB HBM3, 700 W; None: not
# timed alone))
ASSOC_SHAPES = (
    ('rbm_mnist', 'cd_assoc_update', 10, 784, 1024, False, 15.3),
    ('grbm', 'cd_assoc_update', 100, 3072, 5000, True, 520.4),
    ('mrbm', 'cd_assoc_update', 100, 5000, 1000, False, 198.3),
    ('stats_7800', 'cd_assoc_stats', 50, 3072, 7800, True, 331.4),
    ('stats_784', 'cd_assoc_stats', 128, 784, 1024, False, 40.5),
    ('dbm_w0', 'dbm_assoc_update', 100, 784, 512, False, None),
    ('dbm_w1', 'dbm_assoc_update', 100, 512, 1024, False, None),
)


def assoc_work(kind, B, V, H):
    """(product operations, other f32 operations, bytes) of one association
    launch: the two products over B rows (2 B V H each); the update ~8 f32
    operations per weight; the activations read once, W and dW read and
    written once (the stats: the association written once)."""
    ops = 4. * B * V * H
    acts = 4. * 2 * B * (V + H)
    if kind == 'cd_assoc_stats':
        return ops, 0., acts + 4. * V * H
    return ops, 8. * V * H, acts + 16. * V * H + 4. * H


def assoc_shapes(torch):
    """Each association launch of ASSOC_SHAPES alone, through its C entry
    point: against its plain version's arithmetic on the same inputs, each
    element within the bound of tests/test_torch_cuda.py (2^-22 (2 |A|^T|B|
    + |A^T B|) on the association, carried through the update), a second
    launch on the same inputs bit for bit; then timed (graph_ms) beside the
    plain version and, as yardstick, torch.matmul on the pre-stacked K = 2B
    product [X; v]^T [h0; -h]."""
    from boltzmann_machines_tpu_torch.ops import dbm_ops, gemm
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        check_launch, library, ptr)
    lib, dlib = library(), dbm_ops._library()
    g = torch.Generator(device='cuda')
    g.manual_seed(41)
    f32 = dict(dtype=torch.float32, device='cuda')
    u = 2. ** -22
    lr, mom, l2 = 1e-3, 0.9, 1e-4

    def stream():  # the current one: a graph capture's while timing
        return torch.cuda.current_stream().cuda_stream

    out = {}
    for label, kind, B, V, H, gaussian, pr5 in ASSOC_SHAPES:
        def side(K):
            A = torch.randn((K, V), generator=g, **f32) if gaussian else \
                (torch.rand((K, V), generator=g, **f32) < 0.3).float()
            return A, torch.rand((K, H), generator=g, **f32)
        (X, h0), (v, h) = side(B), side(B)
        W0 = 0.01 * torch.randn((V, H), generator=g, **f32)
        dW0 = 1e-3 * torch.randn((V, H), generator=g, **f32)
        pen = 1e-4 * torch.randn(H, generator=g, **f32)
        W, dW = W0.clone(), dW0.clone()

        if kind == 'cd_assoc_update':
            def run():
                check_launch(lib.bm_cd_assoc_update(
                    ptr(X), ptr(h0), ptr(v), ptr(h), ptr(pen), B, V, H,
                    ptr(W), ptr(dW), lr, mom, l2, stream()), kind)

            def plain():
                assoc = X.T @ h0 - v.T @ h
                d = lr * (mom * dW0 + (assoc / B - l2 * W0) - pen)
                return W0 + d, d
            scales = (1. / B, 1. / B)
        elif kind == 'dbm_assoc_update':
            def run():
                dbm_ops._check(dlib.bm_dbm_assoc_update(
                    ptr(X), ptr(h0), ptr(v), ptr(h), ptr(pen), B, B, V, H,
                    ptr(W), ptr(dW), lr, mom, l2, stream()), kind)

            def plain():
                assoc = (X.T @ h0) / B - (v.T @ h) / B
                d = lr * (mom * dW0 + (assoc - l2 * W0 - pen))
                return W0 + d, d
            scales = (1. / B, 1. / B)
        else:
            def run():
                check_launch(lib.bm_cd_assoc_stats(
                    ptr(X), ptr(h0), ptr(v), ptr(h), B, V, H, ptr(W),
                    stream()), kind)

            def plain():
                return (X.T @ h0 - v.T @ h,)
            scales = (1., 1.)

        run()
        got = (W.clone(), dW.clone())
        W.copy_(W0)
        dW.copy_(dW0)
        run()
        same = torch.equal(got[0], W) and torch.equal(got[1], dW)
        want = plain()
        assoc = X.T @ h0 - v.T @ h
        E = u * (gemm.ERR_SUM * (scales[0] * (X.abs().T @ h0.abs()) +
                                 scales[1] * (v.abs().T @ h.abs()))
                 + (scales[0] * assoc).abs())
        if kind == 'cd_assoc_stats':
            errs = [(got[0] - want[0]).abs()]
            ok = bool((errs[0] <= E).all())
        else:
            terms = (mom * dW0).abs() + (scales[0] * assoc).abs() + \
                (l2 * W0).abs() + pen.abs()
            tol_dw = lr * (E + 2. ** -20 * terms) + u * want[1].abs()
            errs = [(got[0] - want[0]).abs(), (got[1] - want[1]).abs()]
            ok = bool((errs[1] <= tol_dw).all()) and bool(
                (errs[0] <= tol_dw + u * want[0].abs()).all())
        torch.cuda.synchronize()
        err = max(float(e.max()) for e in errs)
        name = '%s %s (%d rows, %d x %d)' % (kind, label, B, V, H)
        if not ok or not same:
            raise AssertionError('%s: kernel and plain version disagree (max '
                                 '|d| %.3g, rerun identical %s)' % (
                                     name, err, same))
        stacked = (torch.cat([X, v]).contiguous(),
                   torch.cat([h0, -h]).contiguous())
        # the width the kernel picks (its own rule), and ops/gemm.py's plan
        plan = gemm.assoc_plan(V, H, gemm.num_sms(X.device))
        n_tile = lib.bm_assoc_n_tile(V, H, gemm.num_sms(X.device))
        if n_tile != plan.n_tile:
            raise AssertionError('%s: the kernel takes %d columns per block, '
                                 'assoc_plan %d' % (name, n_tile, plan.n_tile))
        bound_ms, bound_by = bound(*assoc_work(kind, B, V, H))
        r = dict(err=err, ms=graph_ms(torch, run),
                 plain_ms=graph_ms(torch, plain),
                 matmul_ms=graph_ms(torch, lambda: stacked[0].T @ stacked[1]),
                 bound_ms=bound_ms, bound_by=bound_by, n_tile=n_tile,
                 blocks=plan.blocks)
        say('%s: max|kernel-plain| %.3g within the bound, same-input rerun '
            'bit-identical; %.4f ms per launch (SIMT tile, recorded: %s), '
            'plain %.4f ms, torch.matmul of the stacked K = %d product %.4f '
            'ms; bound %.4f ms (%s); n_tile %d, %d blocks' % (
                name, err, r['ms'], 'not timed' if pr5 is None
                else '%.4f' % (pr5 / 1e3), r['plain_ms'], 2 * B,
                r['matmul_ms'], bound_ms, bound_by, n_tile, plan.blocks))
        out[label] = r
    return out


def dbm_step_work(V, H1, H2, B, M, n_mf, k=1):
    """(product operations, other f32 operations, bytes) of one DBM epoch
    step (ops/dbm_ops.py): X.W0, the init of h2, n_mf mean-field sweeps (two
    products each), k Gibbs sweeps of the particles, the association
    products of both layers on data and particles, the reconstruction for
    msre; ~11 per weight for the update and max-norm; X, W, dW, particles
    in and out once."""
    a, b = V * H1, H1 * H2
    gemm_flops = (2. * B * a + 2. * B * b + n_mf * 4. * B * b
                  + k * 4. * M * (a + b) + 2. * (B + M) * (a + b)
                  + 2. * B * a)
    nbytes = 4. * (B * V + 4 * (a + b) + 2 * M * (V + H1 + H2))
    return gemm_flops, 11. * (a + b), nbytes


def dbm_sweep_work(V, H1, H2, M):
    a, b = V * H1, H1 * H2
    return 4. * M * (a + b), 0., 4. * ((a + b) + 2 * M * (V + H1 + H2))


def ais_beta_work(V, H1, H2, R, k):
    """k transitions of three products each plus the two log p~ products
    (R runs), W read once, the runs' states in and out."""
    a, b = V * H1, H1 * H2
    return (4. * k + 2.) * R * (a + b), 0., 4. * ((a + b) + 2 * R * H1)



# ---------------------------------------------------------------------- #
# phase 18: the column-walk kernels and every hand-written kernel not    #
# yet redesigned, each launched alone through its C entry point          #
# ---------------------------------------------------------------------- #
# Launches per 1000 steps on each kernel's path, at the examples' published
# cadences: metrics every 1000 iterations (examples/rbm_mnist.py:99 and
# dbm_cifar_naive.py:121, the G-RBM), every 500 (dbm_mnist.py:89 and :129,
# the two RBMs) and every 400 (dbm_cifar_naive.py:153, the M-RBM); a DBM
# step runs one bias update (vb, hb0 and hb1 in one launch), two max-norms
# and one msre, and max_mf_updates = 50 mean-field checks, each fused into
# its sweep's first dbm_gemm_act launch (enqueued whether or not mean-field
# converged); an AIS run one ais_logw (each beta's update rides on the next
# beta's first dbm_gemm_act launch; dbm_mnist.py's runs have 20 000
# betas), a data-parallel stats call one cd_stats_sums; the free-energy
# probe is on no path.
#
# cd_bias_stats at each RBM path: (label, rows, V, H, Gaussian visible,
# n_samples of multinomial hidden units, sparsity cost, launches per 1000
# steps of cd_metrics there)
BIAS_SHAPES = (
    ('rbm_mnist', 10, 784, 1024, False, 0, 1e-5, 1),
    ('dbm_rbm1', 48, 784, 512, False, 0, 1e-5, 2),
    ('dbm_rbm2', 48, 512, 1024, False, 0, 1e-5, 2),
    ('grbm', 100, 3072, 5000, True, 0, 0., 1),
    ('mrbm', 100, 5000, 1000, False, N_SAMPLES, 0., 2.5),
)
# dbm_max_norm at the DBM's two weight matrices, max_norm of
# examples/dbm_mnist.py:247
NORM_SHAPES = (('dbm_w0', 784, 512), ('dbm_w1', 512, 1024))
DBM_MAX_NORM = 6.
# The two redesigned kernels against their plain versions, with the
# tolerances of phases 3, 10 and 13: the updated biases, their accumulators
# and the penalty as `state`; q as `q_means` (a batch sum: atol x rows);
# msre_col, a column sum over the batch, and the max-norm's W (each column
# scaled by a factor from a sum of n_in squares) as the stats' `sums`.
KT_TOL = {'state': TOL['state'], 'q': TOL['q_means'],
          'sums': STATS_TOL['sums']}
# cd_softmax_sample's means against n softmax(pre) in torch: the row's max,
# exponentials and sum in another order, each mean within a few ulps of n
# (1000) times its probability
SOFTMAX_TOL = (1e-5, 1e-5)
# phase 18's kernels that no single PyTorch call computes, and why
NO_LIBRARY = {
    'cd_softmax_sample': 'softmax and Multinomial counts are two calls; '
                         'distributions.Multinomial(...).sample() alone is '
                         'timed in phase 10',
    'cd_metrics': 'L2, msre and the PLL\'s flipped free energies',
    'fe_probe': 'a free energy is a product, a softplus sum and a dot',
    'dbm_mf_check': 'a counter and flag update on three words, fused into '
                    'the first dbm_gemm_act launch of each mean-field sweep',
    'ais_logw': 'a dot and two partial sums per run',
}


def excess(got, want, tol, scale=1.):
    """max(|got - want| - atol scale - rtol |want|): <= 0 is within."""
    atol, rtol = tol
    return float(((got - want).abs() - atol * scale
                  - rtol * want.abs()).max())


def bias_work(B, V, H):
    """(0, other f32 operations, bytes) of one cd_bias_stats launch: the
    five (B, .) inputs read once, vb, dvb, hb, dhb, q read and written once,
    pen and msre_col written; ~4 operations per input element."""
    return (0., 4. * B * (V + H),
            4. * (3 * B * V + 2 * B * H + 5 * V + 7 * H))


def kernel_times(torch):
    """Phase 18.  Each of cd_bias_stats, cd_stats_sums, cd_softmax_sample,
    cd_metrics, fe_probe, dbm_bias_update, dbm_max_norm, dbm_msre and
    ais_logw at its paths' shapes, launched alone through its C entry point
    and timed by graph_ms beside its plain version (torch ops, also in a
    CUDA graph), a library yardstick where one PyTorch call computes
    (nearly) the same function -- torch.renorm for the max-norm, torch.sum
    over dim 0 of one (rows, V + H) tensor for the column sums, F.mse_loss
    for the msre -- and its bound.  Each is also held against its plain
    version (KT_TOL, STATS_TOL, SOFTMAX_TOL, TOL and CIFAR_TOL, DBM_TOL,
    phase 10's probe tolerance) and a second launch on the same inputs bit
    for bit; cd_softmax_sample is also timed in parts, and each cd_metrics
    launch alone; ais_logw also riding on the next beta's first launch (the
    same bits as alone), that launch timed with and without it.  The
    mean-field check: n_mf against its plain rule, and its cost per sweep
    (a one-layer loop of two sweeps less the two launches alone); and the
    whole mean-field loop.  Returns {(kernel, label): numbers}."""
    import torch.nn.functional as F
    from boltzmann_machines_tpu_torch.ops import dbm_ops
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        CDEpochConfig, bias_stats_reference, check_launch, library,
        pll_flip_index, pll_from_flip, pll_h_hats, ptr)
    from boltzmann_machines_tpu_torch.ops.philox import multinomial_counts
    lib, dlib = library(), dbm_ops._library()
    g = torch.Generator(device='cuda')
    g.manual_seed(18)
    f32 = dict(dtype=torch.float32, device='cuda')

    def rand(*shape):
        return torch.rand(shape, generator=g, **f32)

    def randn(*shape):
        return torch.randn(shape, generator=g, **f32)

    def stream():  # the current one: a graph capture's while timing
        return torch.cuda.current_stream().cuda_stream

    out = {}

    def record(kernel, label, run, plain, work, library_ms=None, per_step=1,
               per_1000=1000, err=None):
        """Times one kernel; per_step and per_1000 are the launches at the
        examples' published cadences, written down, not counted here: they
        are printed and never returned.  library_ms is None where no single
        PyTorch call computes the kernel's function (NO_LIBRARY says why)."""
        bound_ms, bound_by = bound(*work)
        r = dict(ms=graph_ms(torch, run), plain_ms=graph_ms(torch, plain),
                 library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                 err=err)
        say('%s %s: %.4f ms per launch, plain %.4f ms, library %s; bound '
            '%.5f ms (%s); at the examples\' cadences %s launches per step, '
            '%s per 1000 steps%s' % (
                kernel, label, r['ms'], r['plain_ms'],
                'none (%s)' % NO_LIBRARY[kernel] if library_ms is None
                else '%.4f ms' % library_ms,
                bound_ms, bound_by, per_step, per_1000,
                '' if err is None else '; max|kernel-plain| %.3g, '
                'same-input rerun bit-identical' % err))
        out[(kernel, label)] = r

    def colsum_ms(rows, width):
        T = rand(rows, width)
        return graph_ms(torch, lambda: torch.sum(T, 0))

    lr, mom, damp, target = 0.05, 0.9, 0.9, 0.1
    for label, B, V, H, gaussian, n, cost, _ in BIAS_SHAPES:
        def vis(means=False):
            if gaussian:
                return randn(B, V)
            return rand(B, V) if means else (rand(B, V) < 0.3).float()

        def hid():
            return n * torch.softmax(2. * randn(B, H), 1) if n else rand(B, H)
        X, vs, vm, h0, hm = vis(), vis(), vis(True), hid(), hid()
        p0 = {'vb': 0.1 * randn(V), 'dvb': 0.01 * randn(V),
              'hb': 0.1 * randn(H), 'dhb': 0.01 * randn(H),
              'q': 0.3 * B * rand(H) * (n if n else 1) / (H if n else 1),
              'pen': torch.full((H,), float('nan'), **f32),
              'msre_col': torch.full((V,), float('nan'), **f32)}

        def launch(p):
            check_launch(lib.bm_cd_bias_stats(
                ptr(X), ptr(vs), ptr(vm), ptr(h0), ptr(hm), B, V, H,
                ptr(p['vb']), ptr(p['dvb']), ptr(p['hb']), ptr(p['dhb']),
                ptr(p['q']), ptr(p['pen']), ptr(p['msre_col']), lr, mom, damp,
                1. - damp, cost, target, stream()), 'cd_bias_stats')
            return p
        got = launch({k: v.clone() for k, v in p0.items()})
        again = launch({k: v.clone() for k, v in p0.items()})
        want = bias_stats_reference(X, vs, h0, hm, p0, lr, mom, damp, cost,
                                    target, v_means=vm)
        torch.cuda.synchronize()
        tols = {'q': (KT_TOL['q'], B), 'msre_col': (KT_TOL['sums'], 1.)}
        bad = {k: e for k, e in (
            (k, excess(got[k], want[k], *tols.get(k, (KT_TOL['state'], 1.))))
            for k in want) if not e <= 0.}
        same = all(torch.equal(got[k], again[k]) for k in got)
        err = max(float((got[k] - want[k]).abs().max()) for k in want)
        if bad or not same:
            raise AssertionError('cd_bias_stats %s: kernel and plain version '
                                 'disagree (excess %s, rerun identical %s)' % (
                                     label, bad, same))
        p = {k: v.clone() for k, v in p0.items()}
        record('cd_bias_stats', label, lambda: launch(p),
               lambda: bias_stats_reference(X, vs, h0, hm, p0, lr, mom, damp,
                                            cost, target, v_means=vm),
               bias_work(B, V, H), colsum_ms(B, V + H), err=err)

    for label, n_in, n_out in NORM_SHAPES:
        # columns with norms from 0.5 to 1.5 max_norm: half are scaled down
        scale = DBM_MAX_NORM * (0.5 + torch.arange(n_out, **f32) / n_out)
        W0 = randn(n_in, n_out) * scale / math.sqrt(n_in)

        def launch(W):
            dbm_ops._check(dlib.bm_dbm_max_norm(
                ptr(W), n_in, n_out, DBM_MAX_NORM, stream()), 'dbm_max_norm')
            return W
        got, again = launch(W0.clone()), launch(W0.clone())
        want = dbm_ops.apply_max_norm(W0, DBM_MAX_NORM)
        torch.cuda.synchronize()
        norms = torch.linalg.norm(W0, dim=0)
        e = excess(got, want, KT_TOL['sums'])
        same = torch.equal(got, again)
        if not (e <= 0. and same) or not 0 < int(
                (norms > DBM_MAX_NORM).sum()) < n_out:
            raise AssertionError('dbm_max_norm %s: kernel and plain version '
                                 'disagree (excess %.3g, rerun identical %s)'
                                 % (label, e, same))
        W = W0.clone()
        mx = torch.tensor(DBM_MAX_NORM, **f32)

        def plain(W=W0, mx=mx):  # apply_max_norm's body, mx made outside
            norm = torch.linalg.norm(W, dim=0)
            return W * torch.minimum(norm, mx) / torch.clamp(norm, min=1e-8)
        record('dbm_max_norm', label, lambda: launch(W), plain,
               (0., 3. * n_in * n_out, 8. * n_in * n_out),
               graph_ms(torch, lambda: torch.renorm(W0, 2, 1, DBM_MAX_NORM)),
               per_step=1, err=float((got - want).abs().max()))

    # the data-parallel stats call's column sums (one per call), held
    # against the plain sums (STATS_TOL, atol x rows) and a rerun
    for label, B, V, H in (('stats_784', 128, 784, 1024),
                           ('stats_7800', 50, 3072, 7800)):
        X, vs, h0, hm = randn(B, V), randn(B, V), rand(B, H), rand(B, H)

        def run(sums):
            check_launch(lib.bm_cd_stats_sums(
                ptr(X), ptr(vs), ptr(h0), ptr(hm), B, V, H, ptr(sums),
                ptr(sums, V), ptr(sums, V + H), stream()), 'cd_stats_sums')
            return sums

        def plain():
            return torch.cat([torch.sum(X - vs, 0), torch.sum(h0 - hm, 0),
                              torch.sum(hm, 0)])
        got = run(torch.full((V + 2 * H,), float('nan'), **f32))
        again = run(torch.full((V + 2 * H,), float('nan'), **f32))
        want = plain()
        torch.cuda.synchronize()
        e = excess(got, want, STATS_TOL['sums'], B)
        same = torch.equal(got, again)
        if not (e <= 0. and same):
            raise AssertionError('cd_stats_sums %s: kernel and plain version '
                                 'disagree (excess %.3g, rerun identical %s)'
                                 % (label, e, same))
        sums = torch.empty(V + 2 * H, **f32)
        record('cd_stats_sums', label, lambda: run(sums), plain,
               (0., 3. * B * (V + H), 4. * (2 * B * V + 2 * B * H + V + 2 * H)),
               colsum_ms(B, V + H), err=float((got - want).abs().max()))

    # the M-RBM's hidden pass: n softmax(pre) and Multinomial(n) counts,
    # held against the plain softmax (SOFTMAX_TOL), multinomial_counts on
    # the kernel's own means (equal), rows summing to n, and a rerun; then
    # timed whole and in parts: the means alone (no states), the means and
    # the CDF with one draw (n = 1), the draws on given means (from_pre 0)
    B, H, n = CIFAR_B, MRBM[1], N_SAMPLES
    pre = 2. * randn(B, H)
    means, states = torch.empty(B, H, **f32), torch.empty(B, H, **f32)

    given = float(n) * torch.softmax(pre, dim=1)  # the given-means input

    def softmax_run(means=means, states=states, from_pre=1, n=n):
        check_launch(lib.bm_cd_softmax_sample(
            ptr(pre if from_pre else given), from_pre, B, H, n, ptr(means),
            ptr(states), 9, 3, 2, stream()), 'cd_softmax_sample')
        return means, states

    def plain():
        mu = float(n) * torch.softmax(pre, dim=1)
        return mu, multinomial_counts(mu, n, 9, 3, 2)
    got = softmax_run(torch.empty(B, H, **f32), torch.empty(B, H, **f32))
    again = softmax_run(torch.empty(B, H, **f32), torch.empty(B, H, **f32))
    want_mu = plain()[0]
    counts = multinomial_counts(got[0], n, 9, 3, 2)
    torch.cuda.synchronize()
    e = excess(got[0], want_mu, SOFTMAX_TOL)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if not (e <= 0. and same and torch.equal(got[1], counts)
            and bool((got[1].sum(1) == n).all())):
        raise AssertionError(
            'cd_softmax_sample: kernel and plain version disagree (means '
            'excess %.3g, counts equal %s, rerun identical %s)' % (
                e, torch.equal(got[1], counts), same))
    record('cd_softmax_sample', 'mrbm', softmax_run, plain,
           (0., 5. * B * H, 4. * 3 * B * H), per_step=2, per_1000=2000,
           err=float((got[0] - want_mu).abs().max()))
    parts = {
        'means_only_ms': lambda: check_launch(lib.bm_cd_softmax_sample(
            ptr(pre), 1, B, H, n, ptr(means), None, 9, 3, 2, stream()),
            'cd_softmax_sample'),
        'cdf_one_draw_ms': lambda: softmax_run(n=1),
        'given_means_ms': lambda: softmax_run(from_pre=0)}
    softmax_run()
    parts = {k: graph_ms(torch, fn) for k, fn in parts.items()}
    out[('cd_softmax_sample', 'mrbm')].update(parts)
    say('cd_softmax_sample mrbm parts: %s' % ' '.join(
        '%s %.4f' % kv for kv in parts.items()))

    # the metrics of one logged step, PLL on, at each CIFAR and MNIST shape:
    # the step's launches (cd_metrics_fe or cd_metrics_draw, then the pass
    # over W), held against the plain metric rows (TOL, CIFAR_TOL) and a
    # rerun, timed whole and each launch alone
    import importlib
    # the module (the package's `cd_epoch` is the function of that name)
    cd_mod = importlib.import_module(
        'boltzmann_machines_tpu_torch.ops.cd_epoch')
    l2 = 1e-4
    for label, B, V, H, gaussian, n, _, per_1000 in BIAS_SHAPES:
        if label.startswith('dbm_rbm'):
            continue
        X = randn(B, V) if gaussian else (rand(B, V) < 0.3).float()
        vm = rand(B, V)
        W, vb, hb = 0.01 * randn(V, H), 0.1 * randn(V), 0.1 * randn(H)
        sigma = torch.ones(V, **f32) if gaussian else None
        msre_col = torch.sum(torch.square(X - vm), 0)
        cfg = CDEpochConfig(V, H, 1, False, False, 1., 1., l2, 0.1, 0., 0.9,
                            1, True, 'gaussian' if gaussian else 'bernoulli',
                            None, 'multinomial' if n else 'bernoulli',
                            n or None)
        ws = cd_mod.metrics_workspace(V, H, B, torch.device('cuda'))

        def run(rows):
            cd_mod._launch_metrics(
                lib, stream(), cfg, X, W, vb, hb, sigma, msre_col, 7, 1000,
                ws, [ptr(rows, j) for j in range(3)],
                launches={'cd_metrics': 0})
            return rows

        def plain():
            flip = pll_flip_index(7, 1000, B, V, X.device)
            return (torch.mean(torch.square(X - vm)),
                    pll_from_flip(X, flip, W, vb, hb, cfg.visible,
                                  cfg.hidden, sigma,
                                  pll_h_hats(cfg, 7, 1000, X.device)),
                    l2 * 0.5 * torch.sum(W * W))
        got = run(torch.full((3,), float('nan'), **f32))
        again = run(torch.full((3,), float('nan'), **f32))
        want = plain()
        torch.cuda.synchronize()
        tols = CIFAR_TOL if label in ('grbm', 'mrbm') else TOL
        bad = {k: e for k, e in (
            (k, excess(got[j], want[j], tols[k]))
            for j, k in enumerate(ROWS)) if not e <= 0.}
        same = torch.equal(got, again)
        if bad or not same:
            raise AssertionError('cd_metrics %s: kernel and plain version '
                                 'disagree (rows %s against %s, excess %s, '
                                 'rerun identical %s)' % (
                                     label, got.tolist(),
                                     [float(w) for w in want], bad, same))
        rows = torch.empty(3, **f32)
        # one product x.W (the flipped row's is x.W plus one row of W) and
        # W^2 with Bernoulli hidden units; with multinomial ones no product:
        # W^2, u = W.hh and u_f = W.hh_f, then x.u per row
        work = ((0., 6. * V * H + 8. * B * V) if n else
                (2. * B * V * H, 2. * V * H + 12. * B * H + 6. * B * V)) + (
            4. * (B * V + V * H + 3 * V + H),)
        record('cd_metrics', label, lambda: run(rows), plain, work,
               per_step=per_1000 / 1000., per_1000=per_1000,
               err=max(float(abs(g - w)) for g, w in zip(got, want)))
        # each launch alone: the first (the product with its epilogue, or
        # the two count vectors), then the pass over W
        plan = cd_mod.launch_plan(B, H, V, X.device, stream())[0]

        def first():
            if n:
                check_launch(lib.bm_cd_metrics_draw(
                    H, n, 7, 1000, ptr(ws['hh']), stream()), 'cd_metrics')
                return
            # the split-K workspace of the stream in use (a capture's)
            _, tws, cnt = cd_mod.launch_plan(B, H, V, X.device, stream())
            check_launch(lib.bm_cd_metrics_fe(
                ptr(X), ptr(W), ptr(hb), B, V, H, 7, 1000, plan.n_tile,
                plan.splits, ptr(tws), ptr(cnt), ptr(ws['rows']),
                stream()), 'cd_metrics')

        def w_pass():
            check_launch(lib.bm_cd_metrics(
                ptr(X), ptr(W), ptr(vb), ptr(sigma), ptr(msre_col), B, V,
                H, ws['w_rows'], l2, 1, n, ptr(ws['hh']), ptr(ws['rows']),
                0 if n else plan.model_tiles, 7, 1000,
                ptr(ws['partials']), ptr(ws['counter']), ptr(rows, 0),
                ptr(rows, 1), ptr(rows, 2), stream()), 'cd_metrics')
        parts = {'first_launch_ms': graph_ms(torch, first),
                 'w_pass_ms': graph_ms(torch, w_pass),
                 'w_rows': ws['w_rows'],
                 'w_blocks': -(-V // ws['w_rows'])}
        out[('cd_metrics', label)].update(parts)
        say('cd_metrics %s launches alone: %s %.4f ms, pass over W '
            '(%d rows of W a block, %d blocks) %.4f ms' % (
                label, 'draws' if n else 'product', parts[
                    'first_launch_ms'], parts['w_rows'],
                parts['w_blocks'], parts['w_pass_ms']))

    # the free-energy probe at the M-RBM's shape (multinomial hidden units)
    # and the G-RBM's (Gaussian visible, Bernoulli hidden), B 100: its two
    # launches through bm_fe_probe, held against the plain version (the
    # count vectors equal, fe within 1e-5 max(1, |fe|) as in phase 10) and
    # a rerun bit for bit, then timed
    from boltzmann_machines_tpu_torch.ops.samplers import (
        launch_probe, make_free_energy_probe)
    for label, (V, H), gaussian, n in (('mrbm', MRBM, False, N_SAMPLES),
                                       ('grbm', GRBM, True, 0)):
        B = CIFAR_B
        X = randn(B, V) if gaussian else rand(B, V)
        W, vb, hb = 0.01 * randn(V, H), 0.1 * randn(V), 0.1 * randn(H)
        sigma = torch.full((V,), 1.5, **f32) if gaussian else None
        probe = make_free_energy_probe(
            V, H, B, 'gaussian' if gaussian else 'bernoulli',
            'multinomial' if n else 'bernoulli', n or None)
        ws = cd_mod.metrics_workspace(V, H, B, torch.device('cuda'))

        def run(fe=torch.empty((), **f32), h_hat=torch.empty(H, **f32)):
            launch_probe(X, W, vb, hb, sigma, n, 9, ws, fe, h_hat, stream())
            return fe, h_hat

        def plain(zeros=torch.zeros(H, **f32)):
            if n:
                return probe.reference(X, W, vb, hb, None, 9)
            # the reference's body on sigma on the card (a CUDA graph holds
            # no copy from the host)
            return cd_mod.free_energy_sum(X, X @ W, vb, hb, 'gaussian',
                                          'bernoulli', sigma) / B, zeros
        got = run(torch.empty((), **f32), torch.full((H,), 7., **f32))
        again = run(torch.empty((), **f32), torch.full((H,), 7., **f32))
        want = plain()
        torch.cuda.synchronize()
        err = abs(float(got[0]) - float(want[0]))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not (err <= 1e-5 * max(1., abs(float(want[0]))) and same
                and torch.equal(got[1], want[1].reshape(-1))):
            raise AssertionError('fe_probe %s: kernel and plain version '
                                 'disagree (%s against %s, rerun identical '
                                 '%s)' % (label, float(got[0]),
                                          float(want[0]), same))
        # multinomial hidden units: the draw, u = W.hh and x.u per row, no
        # product; Bernoulli ones: the product X.W and a softplus an entry;
        # both: the visible terms
        work = ((0., 2. * V * H + 4. * B * V) if n else
                (2. * B * V * H, 6. * B * H + 4. * B * V)) + (
            4. * (B * V + V * H + 2 * V + 2 * H),)
        record('fe_probe', label, run, plain, work, per_step=0, per_1000=0,
               err=err)

    # the DBM step's bias updates: vb (data X, no sparsity), hb0, hb1; each
    # vector alone and, as the step launches them, all three in one launch
    N = M = DBM_B
    vecs = []
    for l, n_units in enumerate(DBM_SIZES):
        v = {'D': (rand(N, n_units) < 0.3).float() if l == 0
             else rand(N, n_units), 'P': (rand(M, n_units) < 0.3).float(),
             'b': 0.1 * randn(n_units), 'db': 0.01 * randn(n_units),
             'q': None, 'mu': None, 'pen': None, 'cost': 0., 'target': 0.}
        if l:
            v.update(q=0.2 * N * rand(n_units), mu=0.2 * N * rand(n_units),
                     pen=torch.empty(n_units, **f32),
                     cost=SPARSITY_COST[l - 1], target=SPARSITY_TARGET[l - 1])
        vecs.append(v)
    params = ('b', 'db', 'q', 'mu', 'pen')

    def bias_launch(vs):
        """One launch of the vectors `vs` in place."""
        arr = (dbm_ops.BiasVec * len(vs))(*[dbm_ops.BiasVec(
            *(ptr(v[k]) for k in ('D', 'P', 'b', 'db', 'q', 'mu', 'pen')),
            v['b'].numel(), v['cost'], v['target']) for v in vs])
        dbm_ops._check(dlib.bm_dbm_bias_update(
            arr, len(vs), N, M, DBM_LR, DBM_MOM, 0.9, 0.1, stream()),
            'dbm_bias_update')

    def bias_plain(v):
        sd, sp = v['D'].sum(0), v['P'].sum(0)
        grad = sd / N - sp / M
        out = {}
        if v['q'] is not None:
            out['q'] = 0.9 * v['q'] + 0.1 * sp
            out['mu'] = 0.9 * v['mu'] + 0.1 * sd
            out['pen'] = v['cost'] * (out['q'] - v['target']) + \
                v['cost'] * (out['mu'] - v['target'])
            grad = grad - out['pen']
        out['db'] = DBM_LR * (DBM_MOM * v['db'] + grad)
        out['b'] = v['b'] + out['db']
        return out

    def copies():
        return [dict(v, **{k: v[k].clone() for k in params
                           if v[k] is not None}) for v in vecs]
    got, again = copies(), copies()
    bias_launch(got)
    bias_launch(again)
    torch.cuda.synchronize()
    errs = []
    for l, (v, g_, a_) in enumerate(zip(vecs, got, again)):
        want = bias_plain(v)
        bad = {k: e for k, e in (
            (k, excess(g_[k], want[k], *((KT_TOL['q'], N + M) if k in
                                          ('q', 'mu') else
                                          (KT_TOL['state'], 1.))))
            for k in want) if not e <= 0.}
        same = all(torch.equal(g_[k], a_[k]) for k in want)
        if bad or not same:
            raise AssertionError('dbm_bias_update vector %d: kernel and '
                                 'plain version disagree (excess %s, rerun '
                                 'identical %s)' % (l, bad, same))
        errs.append(max(float((g_[k] - want[k]).abs().max()) for k in want))
    work = [(0., 4. * (N + M) * v['b'].numel(),
             4. * ((N + M) * v['b'].numel() + 9 * v['b'].numel()))
            for v in vecs]
    timed = copies()
    for l, v in enumerate(timed):
        label = 'dbm_vb' if l == 0 else 'dbm_hb%d' % (l - 1)
        record('dbm_bias_update', label, lambda v=v: bias_launch([v]),
               lambda v=v: bias_plain(v), work[l],
               colsum_ms(N + M, v['b'].numel()), per_step=0, per_1000=0,
               err=errs[l])
    T = rand(N + M, sum(DBM_SIZES))
    record('dbm_bias_update', 'dbm_step', lambda: bias_launch(timed),
           lambda: [bias_plain(v) for v in vecs],
           tuple(sum(w[i] for w in work) for i in range(3)),
           graph_ms(torch, lambda: torch.sum(T, 0)), per_step=1,
           per_1000=1000, err=max(errs))

    # the DBM step's msre, held against the plain one (DBM_TOL) and a
    # rerun, with the count copied
    V = DBM_SIZES[0]
    X, vm = (rand(DBM_B, V) < 0.3).float(), rand(DBM_B, V)
    ctrl = torch.tensor([0, 0, 17], dtype=torch.int32, device='cuda')
    part = torch.empty(dbm_ops.MSRE_BLOCKS, **f32)
    count = torch.zeros(1, dtype=torch.int32, device='cuda')

    def run(msre):
        dbm_ops._check(dlib.bm_dbm_msre(
            ptr(X), ptr(vm), DBM_B * V, ptr(ctrl), ptr(part),
            dbm_ops.MSRE_BLOCKS, ptr(count), ptr(msre, 0), ptr(msre, 1),
            stream()), 'dbm_msre')
        return msre

    def plain():
        return torch.mean(torch.square(X - vm)), ctrl[2].float()
    got = run(torch.full((2,), float('nan'), **f32))
    again = run(torch.full((2,), float('nan'), **f32))
    want = plain()
    torch.cuda.synchronize()
    err = abs(float(got[0]) - float(want[0]))
    same = torch.equal(got, again)
    if not (err <= DBM_TOL['msre'] and same and float(got[1]) == 17.
            and int(count[0]) == 0):
        raise AssertionError('dbm_msre: kernel and plain version disagree '
                             '(%s against %s, rerun %s, counter %d)' % (
                                 got.tolist(), float(want[0]), again.tolist(),
                                 int(count[0])))
    msre = torch.empty(2, **f32)
    record('dbm_msre', 'dbm', lambda: run(msre), plain,
           (0., 3. * DBM_B * V, 8. * DBM_B * V),
           graph_ms(torch, lambda: F.mse_loss(vm, X)), err=err)

    # the mean-field loop at the step's shapes, from the random state of
    # dbm_init's scale: one layer of it, the sweep's last (h1 =
    # sigmoid(mu0.W1 + hb1), its change folded into ctrl), launched twice
    # alone, and as two sweeps of a one-layer loop through the loop's entry,
    # which adds the check at the start of a sweep's first launch: the
    # check's cost per sweep is half the difference.  Then the whole loop,
    # init and 50 sweeps.  ctrl holds the loop's five words.
    V, H1, H2 = DBM_SIZES
    X = (rand(DBM_B, V) < 0.3).float()
    Ws = (0.03 * randn(V, H1), 0.03 * randn(H1, H2))
    hbs = (torch.full((H1,), -0.5, **f32), torch.full((H2,), -0.5, **f32))
    T0, mu = torch.empty(DBM_B, H1, **f32), [rand(DBM_B, H1),
                                             rand(DBM_B, H2)]
    ctrl = torch.zeros(5, dtype=torch.int32, device='cuda')
    s_ = torch.cuda.current_stream().cuda_stream

    def sweep_args(l, stream):
        A = [(mu[0], Ws[1], False)] if l else [(mu[1], Ws[1], True)]
        a = dbm_ops._gemm_args(mu[l], A, c=None if l else T0, bias=hbs[l],
                               act=dbm_ops.ACT_SIGMOID_DELTA, stream=stream)
        a.delta_bits, a.done = ctrl.data_ptr(), ctrl.data_ptr() + 4
        return a
    import ctypes
    last = sweep_args(1, s_)

    def layers_alone():
        for _ in range(2):
            dbm_ops._check(dlib.bm_dbm_gemm_act(ctypes.byref(last),
                                                stream()), 'dbm_gemm_act')

    def one_layer_loop(sweeps=2, tol=-1.):  # a budget of `sweeps`
        dbm_ops._check(dlib.bm_dbm_mf_loop(
            ctypes.byref(last), 1, sweeps, ptr(ctrl), tol, sweeps, stream()),
            'dbm_mf_loop')

    def check_plain(c=ctrl):  # n_mf += 1; done = !(delta > tol) || n >= max
        n_mf = c[2] + 1
        return n_mf, (n_mf >= 2).int(), torch.zeros_like(n_mf)
    # n_mf against the plain rule: a budget of 3 sweeps at tol -1 runs all
    # three; at tol 1 (every change of a mean is below it) the loop stops
    # after one
    counts = []
    for tol in (-1., 1.):
        ctrl.zero_()
        one_layer_loop(3, tol)
        torch.cuda.synchronize()
        counts.append(int(ctrl[2]))
    if counts != [3, 1]:
        raise AssertionError('mean-field check: n_mf %s, its rule gives '
                             '[3, 1]' % counts)
    ctrl.zero_()
    r = dict(layers_ms=graph_ms(torch, layers_alone),
             loop_ms=graph_ms(torch, one_layer_loop))
    ctrl.zero_()
    r['ms'] = (r['loop_ms'] - r['layers_ms']) / 2.
    bound_ms, bound_by = bound(0., 3., 24.)
    plain_ms = graph_ms(torch, check_plain)
    r.update(plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
             bound_by=bound_by, err=0.,
             fused_into='the first dbm_gemm_act launch of each mean-field '
                        'sweep')
    out[('dbm_mf_check', 'fused')] = r
    say('dbm_mf_check: two launches of the sweep\'s last layer (100x1024, '
        'K 512) %.4f ms alone, %.4f ms as a two-sweep loop; the check %.4f '
        'ms per sweep (no launch of its own), plain %.4f ms; bound %.5f ms '
        '(%s); n_mf against its plain rule: equal' % (
            r['layers_ms'], r['loop_ms'], r['ms'], plain_ms, bound_ms,
            bound_by))

    # the whole mean-field loop of one step: the init launches (T0 = X.W0,
    # mu0, mu1) and 50 sweeps, all run (tol -1)
    loop = (dbm_ops.GemmArgs * 2)()
    init = [dbm_ops._gemm_args(T0, [(X, Ws[0], False)],
                               act=dbm_ops.ACT_IDENTITY, stream=s_),
            dbm_ops._gemm_args(mu[0], c=T0, bias=hbs[0], alpha=2.,
                               stream=s_),
            dbm_ops._gemm_args(mu[1], [(mu[0], Ws[1], False)], bias=hbs[1],
                               stream=s_)]

    def mf_loop():
        for a in init:
            dbm_ops._check(dlib.bm_dbm_gemm_act(ctypes.byref(a), stream()),
                           'dbm_gemm_act')
        dbm_ops._check(dlib.bm_dbm_mf_reset(ptr(ctrl), stream()),
                       'dbm_mf_reset')
        dbm_ops._check(dlib.bm_dbm_mf_loop(loop, 2, 50, ptr(ctrl), -1., 50,
                                           stream()), 'dbm_mf_loop')
    for l in range(2):
        loop[l] = sweep_args(l, s_)
    mf_loop()
    torch.cuda.synchronize()
    if int(ctrl[2]) != 50:
        raise AssertionError('the mean-field loop ran %d sweeps of 50'
                             % int(ctrl[2]))
    gemm = 2. * DBM_B * (V * H1 + H1 * H2) + 50 * 4. * DBM_B * H1 * H2
    mf_bound = bound(gemm, 0., 4. * (DBM_B * V + V * H1 + H1 * H2
                                     + 2 * DBM_B * (H1 + H2)))
    out[('dbm_mf_loop', 'mf_50')] = dict(
        ms=graph_ms(torch, mf_loop, n=4), bound_ms=mf_bound[0],
        bound_by=mf_bound[1])
    say('dbm mean-field loop, init and 50 sweeps (103 launches): %.4f ms; '
        'bound %.5f ms (%s)' % (out[('dbm_mf_loop', 'mf_50')]['ms'],
                                mf_bound[0], mf_bound[1]))

    # one AIS beta's log-weight update, 100 runs: launched alone (an AIS
    # run's last beta) and riding on the next beta's first launch (v =
    # sigmoid(beta (x.W0^T + vb)), 100 x 784, K 512), each held against the
    # plain update and the other bit for bit; the first launch timed with
    # and without it
    R, (V, H1, H2) = 100, DBM_SIZES
    nblk_v = dlib.bm_dbm_gemm_col_blocks(V)
    nblk_h2 = dlib.bm_dbm_gemm_col_blocks(H2)
    x, hb0 = (rand(R, H1) < 0.5).float(), 0.1 * randn(H1)
    part_v, part_h2 = randn(2 * R * nblk_v), randn(2 * R * nblk_h2)
    log_w0 = randn(R)
    W0, vb, v = 0.03 * randn(V, H1), 0.1 * randn(V), torch.empty(R, V, **f32)

    def update(log_w):
        return dbm_ops.AisLogw(ptr(x), ptr(hb0), ptr(part_v), ptr(part_h2),
                               ptr(log_w), R, H1, nblk_v, nblk_h2, 0.37, 0.38)

    def run(log_w):
        u = update(log_w)
        dbm_ops._check(dlib.bm_ais_logw(
            u.x, u.hb0, R, H1, u.part_v, nblk_v, u.part_h2, nblk_h2, 0.37,
            0.38, u.log_w, stream()), 'ais_logw')
        return log_w

    def first_launch(pending=None):
        a = dbm_ops._gemm_args(v, [(x, W0, True)], bias=vb, stream=stream())
        a.alpha = a.gamma = 0.4
        dbm_ops._check(dlib.bm_ais_gemm_act(ctypes.byref(a), pending,
                                            stream()), 'dbm_gemm_act')

    def plain(log_w=log_w0):
        xh = x @ hb0
        pv, ph = part_v.view(2, R, nblk_v), part_h2.view(2, R, nblk_h2)
        lp_lo = 0.37 * xh + pv[0].sum(1) + ph[0].sum(1)
        lp_hi = 0.38 * xh + pv[1].sum(1) + ph[1].sum(1)
        return log_w - lp_lo + lp_hi
    alone, again, fused = (run(log_w0.clone()), run(log_w0.clone()),
                           log_w0.clone())
    first_launch(update(fused))
    want = plain()
    torch.cuda.synchronize()
    err = float((alone - want).abs().max())
    if not (err <= 1e-4 * float(want.abs().max()) and
            torch.equal(alone, again) and torch.equal(alone, fused)):
        raise AssertionError('ais_logw: kernel and plain version disagree '
                             '(max |d| %.3g), or the fused update differs '
                             'from the launch alone' % err)
    log_w = log_w0.clone()
    record('ais_logw', 'ais', lambda: run(log_w), plain,
           (0., 2. * R * H1 + 2. * R * (nblk_v + nblk_h2),
            4. * (R * H1 + H1 + 2 * R * (nblk_v + nblk_h2) + 2 * R)),
           per_step=1. / N_BETAS, per_1000=1000. / N_BETAS, err=err)
    pend = update(log_w)
    r = out[('ais_logw', 'ais')]
    r.update(first_launch_ms=graph_ms(torch, first_launch),
             first_launch_fused_ms=graph_ms(torch, lambda: first_launch(pend)))
    say('ais_logw fused: the beta\'s first launch %.4f ms alone, %.4f ms with '
        'the beta before\'s update (+%.4f ms); the fused update equals the '
        'launch alone bit for bit' % (
            r['first_launch_ms'], r['first_launch_fused_ms'],
            r['first_launch_fused_ms'] - r['first_launch_ms']))
    return out


def dbm_step_profile(torch):
    """Phase 18's profile of the DBM step (784-512-1024, B = M = 100,
    sampling on) in two cases: from a random state at the examples'
    mf_tol 1e-7, where all 50 mean-field sweeps run, and at mf_tol 1e-4,
    where mean-field converges in a few sweeps and the rest of the 50
    enqueued sweeps return at once.  For each: each kernel's device us per
    launch and per step (torch.profiler), their busy share over the
    unprofiled wall of the same epoch, the launches per step and the mean
    n_mf."""
    from boltzmann_machines_tpu_torch.ops import dbm_ops
    nb = 20
    X_all = make_data(nb * DBM_B, seed=5)
    X = torch.as_tensor(X_all.reshape(nb, DBM_B, DBM_SIZES[0]),
                        device='cuda')
    state = dbm_init(torch, X_all)
    out = {}
    for case, tol in (('random', 1e-7), ('converged', 1e-4)):
        cfg = dbm_config(True, mf_tol=tol)

        def epoch():
            return dbm_ops.dbm_epoch(cfg, state, X, DBM_LR, DBM_MOM, 5, 0)
        epoch()
        dbm_ops.reset_launches()
        n_mf = float(epoch()[2].mean())
        torch.cuda.synchronize()
        per_step = {k: v / nb for k, v in dbm_ops.dbm_epoch.launches.items()}
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        per, busy = profile_kernels(torch, epoch, dbm_ops.EPOCH_KERNELS,
                                    min(walls))
        r = {'mf_tol': tol, 'mean_n_mf': n_mf,
             'wall_ms': 1e3 * min(walls) / nb, 'busy': busy,
             'kernel_us': per, 'launches_per_step': per_step}
        if per is not None:
            r['step_us'] = {k: round(per[k] * per_step[k], 1) for k in per}
        say('dbm step 784-512-1024 B=M=100, sampling on, mf_tol %g (%s '
            'state): mean n_mf %.2f; %.4f ms per step (unprofiled, best of '
            '%s); per-kernel device us per launch %s; per step %s; launches '
            'per step %s (%g in all); device busy %s' % (
                tol, case, n_mf, r['wall_ms'],
                ' '.join('%.4f' % (1e3 * w / nb) for w in walls), per,
                r.get('step_us'), per_step, sum(per_step.values()),
                'not measured' if busy is None else '%.1f%%' % (100. * busy)))
        out[case] = r
    return out


# ---------------------------------------------------------------------- #
# readings (python3 chip_smoke.py --readings): what two checks' limits   #
# rest on -- not run by the smoke                                         #
# ---------------------------------------------------------------------- #
# Variants of the tensor-core tile with a planted fault, each made by a
# text edit of a copy of csrc/ in a temporary directory: (old text, new
# text) pairs on csrc/gemm_tc.cuh, or (file, old text, new text).
TILE_VARIANTS = {
    # every wgmma of a slice into the block's one accumulator, as the
    # tile's first design did (the tensor cores truncate their sums)
    'single_accumulator': (
        ('wgmma_tf32<NT>(c, ', 'wgmma_tf32<NT>(d, '),
        ('d[i] = __fmaf_rn(c[i], scale, d[i]);', ''),
        ('fence_reg(c[i]);', 'fence_reg(d[i]);')),
    # plain TF32: the lo.hi and hi.lo products dropped
    '1xtf32': (
        ('        wgmma_tf32<NT>(c, f[1][kk], dh + 2 * kk);\n'
         '        wgmma_tf32<NT>(c, f[0][kk], dl + 2 * kk);\n', ''),),
    # split-K's last block sums slices 0..S-2 and loses the last one
    'lost_slice': (
        ('for (int s = 1; s < t.splits; ++s) {',
         'for (int s = 1; s < t.splits - 1; ++s) {'),),
    # the association kernel without its contraction (the accumulators
    # zero), or returning before its epilogue: where its time goes
    'assoc_no_mainloop': (
        ('assoc_tc.cuh', 'tile_accumulate<NT, true>(p.t, assoc_smem, d);',
         'for (int i = 0; i < NT / 2; ++i) d[i] = 0.f;'),),
    'assoc_no_epilogue': (
        ('assoc_tc.cuh', '  if (prefetch) mbar_wait(ebar, 0);\n',
         '  if (prefetch) mbar_wait(ebar, 0);\n  if (p.mode >= 0) return;\n'),),
    # cd_softmax_sample with 1024 or 256 threads a row instead of 512; and,
    # for its time alone (the results are wrong), the CDF's quotients as
    # products by 1/n, the CDF without its scan, the draws skipped
    'rows_1024': (('cd_epoch.cu', 'constexpr int kRowThreads = 512;',
                   'constexpr int kRowThreads = 1024;'),),
    'rows_256': (('cd_epoch.cu', 'constexpr int kRowThreads = 512;',
                  'constexpr int kRowThreads = 256;'),),
    'cdf_reciprocal': (('cd_epoch.cu', 'q[k] = (double)buf[lo + k] / dn;',
                        'q[k] = (double)buf[lo + k] * (1.0 / dn);'),),
    'cdf_no_scan': (('cd_epoch.cu', 'block_exclusive_scan(s, tot);',
                     '(__syncthreads(), s);'),),
    'no_draws': (('cd_epoch.cu',
                  'for (int j = threadIdx.x; j < n; j += 2 * T) {',
                  'for (int j = threadIdx.x; j < 0 * n; j += 2 * T) {'),),
    # the standalone samplers with the Philox of their counters replaced by
    # the counter and key (wrong draws): what the Philox costs them in
    # integer instructions and in time
    'no_philox': (('philox.cuh',
                   'const uint4 r = philox4x32_10(make_uint4(idx[j], 0u, 0u, '
                   '0u), k);',
                   'const uint4 r = make_uint4(idx[j] ^ k.x, idx[j] ^ k.y, '
                   '0u, 0u);'),),
    # the standalone samplers with 256 or 64 threads a block instead of 128
    'sample_threads_256': (('cd_epoch.cu',
                            'constexpr int kSampleThreads = 128;',
                            'constexpr int kSampleThreads = 256;'),),
    'sample_threads_64': (('cd_epoch.cu',
                           'constexpr int kSampleThreads = 128;',
                           'constexpr int kSampleThreads = 64;'),),
}


def use_tile(tmpdir, variant=None):
    """Build and load the kernels from csrc/ (`variant` None) or from a copy
    of it under `tmpdir` with TILE_VARIANTS[variant] applied; the
    libraries loaded before are dropped."""
    import shutil
    from boltzmann_machines_tpu_torch.ops import _build
    from boltzmann_machines_tpu_torch.ops.cd_epoch import _BOUND as cd_bound
    from boltzmann_machines_tpu_torch.ops.dbm_ops import _BOUND as dbm_bound
    if not hasattr(use_tile, 'home'):
        use_tile.home = (_build.CSRC_DIR, _build.BUILD_DIR)
    csrc, build_dir = use_tile.home
    if variant is not None:
        src, csrc = csrc, os.path.join(tmpdir, variant, 'csrc')
        build_dir = os.path.join(tmpdir, variant, '_build')
        if not os.path.isdir(csrc):
            shutil.copytree(src, csrc)
            for edit in TILE_VARIANTS[variant]:
                name, old, new = (('gemm_tc.cuh',) + edit)[-3:]
                path = os.path.join(csrc, name)
                with open(path) as f:
                    text = f.read()
                if old not in text:
                    raise AssertionError('%s: %r not in %s' % (variant, old,
                                                               name))
                with open(path, 'w') as f:
                    f.write(text.replace(old, new))
    _build.CSRC_DIR, _build.BUILD_DIR = csrc, build_dir
    _build._LOADED.clear()
    cd_bound.clear()
    dbm_bound.clear()
    t0 = time.perf_counter()
    _build.build_all(['cd_epoch', 'dbm_ops'])
    say('tile %s: built in %.1f s' % (variant or 'as committed',
                                      time.perf_counter() - t0))


# (B, V, H) of tests/test_torch_cuda.py's tile tests: the ragged shapes and
# the paths' products
READ_GEMM_SHAPES = ((8, 24, 16), (3, 37, 70), (1, 130, 65), (67, 50, 129),
                    (10, 784, 1024), (128, 784, 1024), (100, 3072, 5000),
                    (100, 5000, 1000), (50, 3072, 7800))


def gemm_error_readings(torch, label):
    """cd_gemm_act against its plain version on the card tests' operands
    (numpy RandomState(0): A ~ N(0, 1), W ~ 0.05 N(0, 1)), the
    pre-activation epilogue with mult 1 and a zero bias, so that the means
    are the product itself; at the plan's split count and at one slice.
    Per shape and direction, the largest |kernel - plain| over 2^-22 times
    each of two scales of an element's terms: |A|.|W| (l1) and
    sqrt(A^2.W^2) (l2), after 2^-22 |A.W| (the rounding of the sum
    itself).  Returns {(B, V, H, transposed): (l1, l2, max |d|)}."""
    import numpy as np
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        ACT_PRE, _launch_gemm_act, library)
    lib = library()
    u = 2. ** -22
    out = {}
    for B, V, H in READ_GEMM_SHAPES:
        for transposed in (False, True):
            rng = np.random.RandomState(0)
            K, N = (H, V) if transposed else (V, H)
            W = torch.as_tensor(rng.randn(V, H) * 0.05,
                                dtype=torch.float32, device='cuda')
            A = torch.as_tensor(rng.randn(B, K), dtype=torch.float32,
                                device='cuda')
            zero = torch.zeros(N, device='cuda')
            Wk = W.T if transposed else W
            want = A @ Wk
            l1 = A.abs() @ Wk.abs()
            l2 = (A * A @ (Wk * Wk)).sqrt()
            got = {}
            for splits in (None, 1):
                means = torch.empty((B, N), device='cuda')
                _launch_gemm_act(lib, torch.cuda.current_stream().cuda_stream,
                                 A, W, transposed, zero, None, 1., ACT_PRE,
                                 means, None, 1, 1, 1, launches={
                                     'cd_gemm_act': 0}, splits=splits)
                got[splits] = means
            torch.cuda.synchronize()
            d = torch.stack([(g - want).abs() for g in got.values()]).amax(0)
            excess = (d - u * want.abs()).clamp(min=0.)
            r = tuple(float((excess / (u * n)).max()) for n in (l1, l2))
            out[(B, V, H, transposed)] = r + (float(d.max()),)
            say('  %s %dx%d%s -> %d: max|d| %.3g; over 2^-22 |A|.|W|: %.4g; '
                'over 2^-22 sqrt(A^2.W^2): %.4g' % (
                    label, B, K, ' (W^T)' if transposed else '', N,
                    float(d.max()), r[0], r[1]))
    return out


def dbm_msre_readings(torch, tmpdir, seeds=(0, 1, 2)):
    """The DBM path's final validation msre (phase 7's three stages) on the
    same data at three seeds: through the plain versions, through the
    kernels, and through the kernels with the 1xtf32 and lost_slice tiles.
    Prints each and the ratios the phase-7 check reads: kernels over plain
    at the same seed, and one seed's plain run over another's."""
    X = make_data(11000, seed=42)
    X_train, X_val = X[:10000], X[-1000:]
    val = {}

    def run(name, seed, plain=False):
        with tempfile.TemporaryDirectory() as d:
            r = train_dbm_mnist(torch, d, X_train, X_val, plain=plain,
                                seed=seed)
        val[(name, seed)] = r['val'][-1][1]
        say('  %s seed %d: val msre %s, train msre %s (DBM.fit %.1f s)' % (
            name, seed, [v for _, v in r['val']],
            [v for _, v in r['msre']], r['t_fit']))

    for seed in seeds:
        run('plain', seed, plain=True)
        run('kernels', seed)
    for variant in ('1xtf32', 'lost_slice'):
        use_tile(tmpdir, variant)
        for seed in seeds:
            run(variant, seed)
    use_tile(tmpdir)
    for name in ('kernels', '1xtf32', 'lost_slice'):
        say('  %s / plain, same seed: %s' % (name, [
            round(val[(name, s)] / val[('plain', s)], 4) for s in seeds]))
    say('  plain / plain, other seeds: %s' % [
        round(val[('plain', a)] / val[('plain', b)], 4)
        for a in seeds for b in seeds if a != b])
    return val


def assoc_readings():
    """Where the association kernel's time goes: cd_assoc_update at the
    paths' three update shapes (ASSOC_SHAPES), timed by graph_ms, as
    committed, without its contraction and without its epilogue."""
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke --assoc-readings: no CUDA device\n')
        return 1
    environment(torch)
    import importlib
    ce = importlib.import_module('boltzmann_machines_tpu_torch.ops.cd_epoch')
    g = torch.Generator(device='cuda')
    g.manual_seed(43)
    shapes = [(label, B, V, H) for label, kind, B, V, H, _, _ in ASSOC_SHAPES
              if kind == 'cd_assoc_update']
    with tempfile.TemporaryDirectory() as tmpdir:
        for variant in (None, 'assoc_no_mainloop', 'assoc_no_epilogue'):
            use_tile(tmpdir, variant)
            lib = ce.library()
            for label, B, V, H in shapes:
                X, v = (torch.randn((B, V), generator=g, device='cuda')
                        for _ in range(2))
                h0, h = (torch.rand((B, H), generator=g, device='cuda')
                         for _ in range(2))
                W = 0.01 * torch.randn((V, H), generator=g, device='cuda')
                dW, pen = torch.zeros_like(W), torch.zeros(H, device='cuda')

                def run():
                    ce.check_launch(lib.bm_cd_assoc_update(
                        ce.ptr(X), ce.ptr(h0), ce.ptr(v), ce.ptr(h),
                        ce.ptr(pen), B, V, H, ce.ptr(W), ce.ptr(dW), 1e-4,
                        0.5, 1e-4, torch.cuda.current_stream().cuda_stream),
                        'cd_assoc_update')
                say('  %s cd_assoc_update %s (%d rows, %d x %d): %s us' % (
                    variant or 'committed', label, B, V, H, ' '.join(
                        '%.1f' % (1e3 * graph_ms(torch, run))
                        for _ in range(3))))
        use_tile(tmpdir)
    return 0


def pll_readings():
    """What the PLL's error against the plain version at the G-RBM shapes
    is made of: at 3072 x 5000 and 3072 x 7800, B 100 (Gaussian visible
    units, sigma 1, Bernoulli hidden ones, as phase 10), over three seeds --
    each its own weights, two kernel CD steps from them and its own logged
    batch and flipped units -- the PLL of one logged step by the metrics
    kernels (``ops/cd_epoch._metrics``: the tile's product with the flipped
    rows, then the pass over W), by the plain version in float32 and by the
    plain version in float64, all on the same parameters, batch and flips.
    The PLL is V log sigmoid(fe(x_f) - fe(x)), a difference of two batch-mean
    free energies of ~1e3 each, so float32 rounding of those sums alone
    moves it; the kernel's error is noise if |kernel - f64| stays within
    the spread of |plain f32 - f64|."""
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke --pll-readings: no CUDA device\n')
        return 1
    environment(torch)
    build()
    import importlib
    ce = importlib.import_module('boltzmann_machines_tpu_torch.ops.cd_epoch')
    rows = []
    for V, H in (GRBM, GRBM_WIDE):
        cfg = grbm_cfg(V, H, False, 1)
        for seed in (1, 2, 3):
            X = cifar_inputs(torch, 3, 'grbm', seed=10 + seed)
            s = ce.cd_epoch(cfg, cifar_state(torch, V, H, 0.0008, seed=seed),
                            X[:2], GRBM_LR, MOMENTUM, 7, 0)[0]
            it = 20 + seed
            args = (X[2], s['W'], s['vb'], s['hb'],
                    torch.zeros(V, device='cuda'))
            kernel = float(ce._metrics(cfg, *args, 7, it)[1])
            f32 = float(ce.metrics_reference(cfg, *args, 7, it)[1])
            f64 = float(ce.metrics_reference(
                cfg, *(a.double() for a in args), 7, it)[1])
            rows.append((V, H, seed, kernel, f32, f64))
            say('pll %dx%d seed %d: kernel %.4f, plain f32 %.4f, plain f64 '
                '%.4f; |kernel - f64| %.4f, |f32 - f64| %.4f, |kernel - '
                'f32| %.4f' % (V, H, seed, kernel, f32, f64, abs(kernel - f64),
                               abs(f32 - f64), abs(kernel - f32)))
    k64 = [abs(k - d) for *_, k, _, d in rows]
    p64 = [abs(p - d) for *_, p, d in rows]
    within = max(k64) <= max(p64)
    say('pll readings: |kernel - f64| %.4f-%.4f, |plain f32 - f64| '
        '%.4f-%.4f: the kernel\'s error is %s the plain float32 version\'s '
        'own spread' % (min(k64), max(k64), min(p64), max(p64),
                        'within' if within else 'OUTSIDE'))
    say(json.dumps({'pll_readings': [dict(zip(
        ('V', 'H', 'seed', 'kernel', 'plain_f32', 'plain_f64'), r))
        for r in rows], 'kernel_within_f32_spread': within}))
    return 0


def softmax_readings():
    """The shape of cd_softmax_sample's block: the M-RBM's hidden pass
    (100 x 1000, n = 1000) timed by graph_ms whole and in parts (as phase
    18: the means alone, the means and CDF with one draw, the draws on
    given means) with 512 threads a row, as committed, with 1024 and 256,
    and, for the time of each part alone, with the CDF's quotients taken as
    products, without the CDF's scan and without the draws (those three
    give wrong counts and are timed only)."""
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke --softmax-readings: no CUDA device\n')
        return 1
    environment(torch)
    import importlib
    ce = importlib.import_module('boltzmann_machines_tpu_torch.ops.cd_epoch')
    g = torch.Generator(device='cuda')
    g.manual_seed(44)
    B, H, n = CIFAR_B, MRBM[1], N_SAMPLES
    pre = 2. * torch.randn((B, H), generator=g, device='cuda')
    means, states = torch.empty_like(pre), torch.empty_like(pre)
    given = float(n) * torch.softmax(pre, dim=1)  # the given-means input
    with tempfile.TemporaryDirectory() as tmpdir:
        for variant in (None, 'rows_1024', 'rows_256', 'cdf_reciprocal',
                        'cdf_no_scan', 'no_draws', None):
            use_tile(tmpdir, variant)
            lib = ce.library()

            def run(from_pre=1, n=n, states=states):
                ce.check_launch(lib.bm_cd_softmax_sample(
                    ce.ptr(pre if from_pre else given), from_pre, B, H, n,
                    ce.ptr(means), ce.ptr(states), 9, 3, 2,
                    torch.cuda.current_stream().cuda_stream),
                    'cd_softmax_sample')
            run()
            parts = {'whole': run, 'means_only': lambda: run(states=None),
                     'cdf_one_draw': lambda: run(n=1),
                     'given_means': lambda: run(from_pre=0)}
            say('  %s cd_softmax_sample (%d x %d, n %d), us: %s' % (
                variant or 'committed (512 threads)', B, H, n, '; '.join(
                    '%s %s' % (k, ' '.join('%.2f' % (1e3 * graph_ms(torch, f))
                                           for _ in range(2)))
                    for k, f in parts.items())))
    return 0


# the integer pipe's SASS opcodes (before the first '.'); the uniform
# datapath's (U...) run once a warp and are not counted
INT_OPCODES = frozenset((
    'IMAD', 'IADD3', 'IADD', 'IMUL', 'LOP3', 'LOP', 'SHF', 'SHL', 'SHR',
    'LEA', 'ISETP', 'IMNMX', 'IABS', 'SEL', 'PRMT', 'POPC', 'FLO', 'BREV',
    'BMSK', 'SGXT', 'IDP'))


def sass_counts(lib, names):
    """{name: (integer instructions, all instructions, IMAD.WIDE and
    IMAD.HI products)} of each kernel whose symbol holds `name`, from
    ``cuobjdump -sass`` of the library `lib` (static counts)."""
    from boltzmann_machines_tpu_torch.ops._build import find_nvcc
    tool = os.path.join(os.path.dirname(find_nvcc()), 'cuobjdump')
    text = subprocess.run([tool, '-sass', lib], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    op = re.compile(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)')
    out = {}
    for block in text.split('Function : ')[1:]:
        symbol = block.split()[0]
        for name in names:
            if name in symbol:
                ops = op.findall(block)
                out[name] = (
                    sum(o.split('.')[0] in INT_OPCODES for o in ops),
                    len(ops),
                    sum(o.startswith(('IMAD.WIDE', 'IMAD.HI')) for o in ops))
    missing = set(names) - set(out)
    if missing:
        raise AssertionError('no SASS for %s in %s' % (sorted(missing), lib))
    return out


def host_us(torch, fn, n=1000, reps=5):
    """Host microseconds per call of `fn`: the best of `reps` runs of n calls
    by the host clock, the card synchronised before and after each run
    (outside the clock)."""
    fn()
    best = float('inf')
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * best / n


def sampler_readings():
    """Where one call of the standalone samplers goes: each piece of
    ``bernoulli_sample`` at (100, 7800) and ``normal_sample`` at
    (100, 3072) timed alone by the host clock (``host_us``: 1000 calls,
    best of five), beside the whole wrapper and torch.bernoulli /
    torch.randn in the same process (the host varies from process to
    process, so they are the yardstick only here); per call by CUDA events
    (50 calls, as phase 10 and 13 time them) and device time alone
    (graph_ms), also on the scalar path (a view 4 bytes off); then the
    integer SASS instructions of one Philox evaluation in each kernel (the
    committed kernels' less a copy's whose Philox is the identity, over the
    four elements a thread) and that copy's device times."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke --sampler-readings: no CUDA device\n')
        return 1
    environment(torch)
    import importlib
    ce = importlib.import_module('boltzmann_machines_tpu_torch.ops.cd_epoch')
    from boltzmann_machines_tpu_torch.ops import _build, samplers
    g = torch.Generator(device='cuda')
    g.manual_seed(5)
    shape = (CIFAR_B, GRBM[0])
    p = torch.rand((CIFAR_B, GRBM_WIDE[1]), generator=g, device='cuda')
    view = torch.rand(p.numel() + 1, generator=g, device='cuda')[1:].view(
        p.shape)
    dev, idx, n, n_normal = p.device, p.get_device(), p.numel(), 307200
    lib = ce.library()
    out_b, out_n = torch.empty_like(p), torch.empty(shape, device=dev)
    handle = torch.cuda.current_stream(idx).cuda_stream
    args_b = (p.data_ptr(), out_b.data_ptr(), n, 7, 0, handle)
    args_n = (out_n.data_ptr(), n_normal, 5, handle)
    private = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    accel = getattr(torch, 'accelerator', None)
    if accel is not None and hasattr(accel.current_stream(idx),
                                     'native_handle'):
        say('  torch.accelerator.current_stream(index).native_handle %s '
            'torch.cuda.current_stream(index).cuda_stream' % (
                '==' if accel.current_stream(idx).native_handle == handle
                else '!='))
    else:
        accel = None
    cuda = torch.device('cuda')
    pieces = [
        ('an empty lambda', lambda: None),
        ('key_words(7)', lambda: samplers.key_words(7)),
        ('key_words((7, 99))', lambda: samplers.key_words((7, 99))),
        ('key_words(np.int64(7)): the numpy route',
         lambda: samplers.key_words(np.int64(7))),
        ('_check_seed(5, 307200)', lambda: samplers._check_seed(5, n_normal)),
        ("_device_of('cuda')", lambda: samplers._device_of('cuda')),
        ('_device_of(p.device)', lambda: samplers._device_of(p.device)),
        ('p.is_cuda', lambda: p.is_cuda),
        ('p.device', lambda: p.device),
        ('p.get_device()', lambda: p.get_device()),
        ('p.numel()', lambda: p.numel()),
        ('math.prod(shape)', lambda: math.prod(shape)),
        ('int(np.prod(shape, dtype=np.int64))',
         lambda: int(np.prod(shape, dtype=np.int64))),
        ('tuple(map(int, shape))', lambda: tuple(map(int, shape))),
        ('tuple(int(d) for d in shape)',
         lambda: tuple(int(d) for d in shape)),
        ('check_tensors([(p, probs)], p.device, {})',
         lambda: ce.check_tensors([(p, 'probs')], dev, {})),
        ('p.dtype and p.is_contiguous()',
         lambda: p.dtype != torch.float32 or not p.is_contiguous()),
        ('current_stream(p.device).cuda_stream',
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ('current_stream(index).cuda_stream',
         lambda: torch.cuda.current_stream(idx).cuda_stream),
        ('current_stream().cuda_stream',
         lambda: torch.cuda.current_stream().cuda_stream),
        ("torch.device('cuda')", lambda: torch.device('cuda')),
        ('count >= 2 ** 32', lambda: n >= 2 ** 32),
        ('torch.empty_like(p)', lambda: torch.empty_like(p)),
        ('torch.empty(shape, dtype, device)',
         lambda: torch.empty(shape, dtype=torch.float32, device=dev)),
        ("torch.empty(shape, dtype, device=torch.device('cuda'))",
         lambda: torch.empty(shape, dtype=torch.float32, device=cuda)),
        ("torch.empty(shape, dtype, device='cuda')",
         lambda: torch.empty(shape, dtype=torch.float32, device='cuda')),
        ('torch.empty(shape, dtype, device=index)',
         lambda: torch.empty(shape, dtype=torch.float32, device=idx)),
        ('torch.empty(*shape, dtype, device)',
         lambda: torch.empty(*shape, dtype=torch.float32, device=dev)),
        ('p.new_empty(shape)', lambda: p.new_empty(shape)),
        ('p.data_ptr()', lambda: p.data_ptr()),
        ('library()', ce.library),
        ('ctypes, no launch: bm_assoc_n_tile',
         lambda: lib.bm_assoc_n_tile(784, 1024, 132)),
        ('ctypes, a launch: bm_bernoulli_sample',
         lambda: lib.bm_bernoulli_sample(*args_b)),
        ('ctypes, a launch: bm_normal_sample',
         lambda: lib.bm_normal_sample(*args_n)),
        ('bernoulli_sample(7, p)', lambda: samplers.bernoulli_sample(7, p)),
        ('bernoulli_sample((7, 99), p)',
         lambda: samplers.bernoulli_sample((7, 99), p)),
        ('torch.bernoulli(p, generator=g)',
         lambda: torch.bernoulli(p, generator=g)),
        ("normal_sample(5, shape, 'cuda')",
         lambda: samplers.normal_sample(5, shape, 'cuda')),
        ("torch.randn(shape, generator=g, device='cuda')",
         lambda: torch.randn(shape, generator=g, device='cuda')),
    ]
    if accel is not None:
        pieces.append(('torch.accelerator.current_stream(index).'
                       'native_handle',
                       lambda: accel.current_stream(idx).native_handle))
    if private is not None:
        pieces.append(('torch._C._cuda_getCurrentRawStream(index) (private, '
                       'not used)', lambda: private(idx)))
    host = {}
    for label, fn in pieces:
        host[label] = host_us(torch, fn)
        say('  host %-52s %.3f us' % (label, host[label]))
    calls = {
        'bernoulli_sample': lambda: samplers.bernoulli_sample(7, p),
        'torch.bernoulli': lambda: torch.bernoulli(p, generator=g),
        'normal_sample': lambda: samplers.normal_sample(5, shape, 'cuda'),
        'torch.randn': lambda: torch.randn(shape, generator=g,
                                           device='cuda')}
    per_call = {k: [] for k in calls}
    for _ in range(7):  # in turns: the host drifts within a process too
        for k, fn in calls.items():
            per_call[k].append(event_ms(torch, fn, 50))
    say('  per call, CUDA events over 50 calls, ms, seven turns: %s; '
        'medians %s' % (json.dumps(per_call), json.dumps(
            {k: sorted(v)[3] for k, v in per_call.items()})))
    device, sass = {}, {}
    names = ('bernoulli_sample_kernel', 'normal_sample_kernel')
    with tempfile.TemporaryDirectory() as tmpdir:
        for variant in (None, 'no_philox', 'sample_threads_256',
                        'sample_threads_64', None):
            use_tile(tmpdir, variant)
            key = variant or ('committed, again' if device else 'committed')
            lib_path = _build.library_path('cd_epoch')
            sass[key] = sass_counts(lib_path, names)
            with open(lib_path + '.log') as f:
                log = f.read().split('Compiling entry function')
            for name in names:
                say('  %s %s: %s' % (key, name, ' '.join(
                    line.strip() for part in log if name in part.split()[0]
                    for line in part.splitlines() if 'Used' in line)))
            device[key] = {
                'bernoulli_sample': graph_ms(
                    torch, lambda: samplers.bernoulli_sample(7, p)),
                'bernoulli_sample at a 4-byte offset': graph_ms(
                    torch, lambda: samplers.bernoulli_sample(7, view)),
                'normal_sample': graph_ms(
                    torch, lambda: samplers.normal_sample(5, shape, 'cuda'))}
            say('  %s: device time alone (graph_ms), ms: %s; SASS (integer, '
                'all, products): %s' % (key, json.dumps(device[key]),
                                        json.dumps(sass[key])))
    device['torch.bernoulli'] = graph_ms(torch, lambda: torch.bernoulli(p))
    device['torch.randn'] = graph_ms(
        torch, lambda: torch.randn(shape, device='cuda'))
    philox = {name: (sass['committed'][name][0] - sass['no_philox'][name][0])
              / 4. for name in names}
    say('  integer SASS instructions of one Philox evaluation: %s'
        % json.dumps(philox))
    rate = int_peak()
    for name, elems, nbytes in (
            ('bernoulli_sample_kernel', n, 8. * n),
            ('normal_sample_kernel', n_normal, 4. * n_normal)):
        say('  %s: %d elements: integers %.4f us, bytes %.4f us' % (
            name, elems, 1e6 * philox[name] * elems / rate,
            1e6 * nbytes / PEAK_BYTES))
    say(json.dumps({'sampler_readings': {
        'host_us': host, 'per_call_ms': per_call, 'device_ms': device,
        'sass': sass, 'philox_int_ops': philox, 'int_peak': rate}}))
    return 0


def readings():
    """The readings behind two limits: the card tests' tolerance of the
    tensor-core tile (the committed tile against the single-accumulator
    one) and the DBM path's validation-msre check (sound runs against
    planted faults)."""
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke --readings: no CUDA device\n')
        return 1
    environment(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        use_tile(tmpdir)
        errors = {'committed': gemm_error_readings(torch, 'committed')}
        use_tile(tmpdir, 'single_accumulator')
        errors['single_accumulator'] = gemm_error_readings(
            torch, 'single_accumulator')
        use_tile(tmpdir)
        for name, r in errors.items():
            say('tile %s: largest over all shapes: l1 %.4g, l2 %.4g, max|d| '
                '%.3g' % (name, *(max(v[i] for v in r.values())
                                  for i in range(3))))
        dbm_msre_readings(torch, tmpdir)
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: no CUDA device; this check runs only '
                         'on a GPU\n')
        return 1
    import boltzmann_machines_tpu_torch  # noqa: F401  (fails outside the repo)
    card = environment(torch)
    build()
    worst = kernel_vs_plain(torch)
    cifar_err, cifar_share = cifar_kernels_vs_plain(torch)
    sampler = samplers_vs_plain(torch)
    stats_err = stats_vs_plain(torch)
    bern = bernoulli_vs_plain(torch)
    gs = gemm_shapes(torch)
    asc = assoc_shapes(torch)
    kt = kernel_times(torch)
    dbm_prof = dbm_step_profile(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        rbm_launches = main_path(torch, tmpdir)
    t = timings(torch)
    steps = t[(10, 'steps')]
    dbm_err = dbm_kernels_vs_plain(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        dbm_launches, dbm = dbm_mnist_path(torch, tmpdir)
        dbm_err['ais'] = max(dbm_err['ais'], ais_trained_vs_plain(torch, dbm))
        ais_vs_bruteforce(torch, tmpdir)
    del dbm
    td = dbm_timings(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        g_launches, m_launches = cifar_naive_path(torch, tmpdir)
    tc = cifar_timings(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        w1 = dp_world1(torch, tmpdir)
    with tempfile.TemporaryDirectory() as tmpdir:
        dp = dp_fit(torch, tmpdir)
    ts = stats_timings(torch)
    cd_launches = {k: rbm_launches[k] + dbm_launches['cd_epoch'][k]
                   for k in rbm_launches}
    dp_stats = [r['grbm']['stats'] for r in dp['ranks']]
    wide, mnist = ts['3072x7800'], ts['784x1024']

    def entry(name, source, launches, err, ms, plain_ms, work,
              library_ms=None, **extra):
        bound_ms, bound_by = bound(*work)
        d = {'name': name, 'route': 'cuda', 'source': CSRC + source,
             'replaces': REPLACES[name],
             'launches': (sum(launches.values())
                          if isinstance(launches, dict) else launches),
             'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
             'bound_ms': bound_ms, 'bound_by': bound_by,
             'library_ms': library_ms}
        if isinstance(launches, dict):
            d['launches_per_kernel'] = launches
        d.update(extra)
        return d

    def shapes(*labels):
        """The per-shape phase's numbers for the entry's products."""
        return {label: {
            'ms': gs[label]['ms'],
            'one_slice_ms': gs[label]['one_slice_ms'],
            'matmul_ms': gs[label]['matmul_ms'],
            'bound_3xtf32_ms': gs[label]['bound_3xtf32'][0],
            'bound_f32_ms': gs[label]['bound_f32'][0],
            'splits': gs[label]['splits'], 'n_tile': gs[label]['n_tile'],
            'max_abs_err': gs[label]['err']} for label in labels}

    def assoc(*labels):
        """The association phase's numbers for the entry's launches."""
        keys = ('ms', 'plain_ms', 'matmul_ms', 'bound_ms',
                'bound_by', 'n_tile', 'blocks')
        return {label: dict({k: asc[label][k] for k in keys},
                            max_abs_err=asc[label]['err'])
                for label in labels}

    dbm_step_shapes = ('dbm_x_w0', 'dbm_mf_h0', 'dbm_mf_h1', 'dbm_gibbs_h0',
                       'dbm_gibbs_h1', 'dbm_gibbs_v')

    def stage(name):
        return dict(kernel_us=tc[(name, 'kernel_us')],
                    device_busy=tc[(name, 'busy')],
                    cd_gemm_act_library_ms=tc[(name, 'matmul_ms')],
                    plain_sampling_off_ms=tc[(name, False, 'plain')],
                    sampling_off_ms=tc[(name, False, 'kernel')])

    def walk(kernel, *labels):
        """Phase 18's numbers for the entry's launches of `kernel`; where no
        PyTorch call computes its function, `no_library` says why."""
        keys = ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
                'fused_into', 'layers_ms', 'loop_ms', 'first_launch_ms',
                'first_launch_fused_ms')
        extra = {'no_library': NO_LIBRARY[kernel]} if kernel in NO_LIBRARY \
            else {}
        return {label: dict({k: kt[(kernel, label)][k] for k in keys
                             if k in kt[(kernel, label)]},
                            max_abs_err=kt[(kernel, label)]['err'], **extra)
                for label in labels}

    # each entry's kernels timed alone by phase 18, by shape
    walks = {
        'cd_epoch': (('cd_bias_stats', 'rbm_mnist', 'dbm_rbm1', 'dbm_rbm2'),
                     ('cd_metrics', 'rbm_mnist')),
        'dbm_epoch': (('dbm_max_norm', 'dbm_w0', 'dbm_w1'),
                      ('dbm_bias_update', 'dbm_step', 'dbm_vb', 'dbm_hb0',
                       'dbm_hb1'),
                      ('dbm_msre', 'dbm'), ('dbm_mf_check', 'fused')),
        'ais': (('ais_logw', 'ais'),),
        'cd_epoch_gaussian': (('cd_bias_stats', 'grbm'),
                              ('cd_metrics', 'grbm')),
        'cd_epoch_multinomial': (('cd_bias_stats', 'mrbm'),
                                 ('cd_softmax_sample', 'mrbm'),
                                 ('cd_metrics', 'mrbm')),
        'free_energy_probe': (('fe_probe', 'mrbm', 'grbm'),),
        'cd_stats': (('cd_stats_sums', 'stats_7800', 'stats_784'),),
    }

    # the card again, beside the numbers it gave
    say(card)
    kernels = [
        # per minibatch step of the RBM path (batch 10, sampled hiddens);
        # launches from the RBM path and the DBM path's pretraining
        entry('cd_epoch', 'cd_epoch.cu', cd_launches, worst,
              1e3 * t[(10, 'kernel', True)] / steps,
              1e3 * t[(10, 'plain', True)] / steps,
              cd_step_work(V, H, 10), kernel_us=t['kernel_us'],
              device_busy=t['busy'], cd_gemm_act_library_ms=t['matmul_ms'],
              cd_gemm_act_shapes=shapes('rbm_mnist_h', 'rbm_mnist_v'),
              cd_assoc_update_shapes=assoc('rbm_mnist')),
        # per minibatch step at B = M = 100, n_mf 50, sampling on
        entry('dbm_epoch', 'dbm_ops.cu', dbm_launches['dbm_epoch'],
              dbm_err['dbm_epoch'], td[('dbm_epoch', True, 'kernel')],
              td[('dbm_epoch', True, 'plain')],
              dbm_step_work(*DBM_SIZES, DBM_B, DBM_M, 50),
              dbm_gemm_act_library_ms=td['matmul_ms'],
              dbm_gemm_act_shapes=shapes(*dbm_step_shapes),
              dbm_assoc_update_shapes=assoc('dbm_w0', 'dbm_w1')),
        # per Gibbs sweep of 100 particles, sampling on
        entry('dbm_sample', 'dbm_ops.cu', dbm_launches['dbm_sample'],
              dbm_err['dbm_sample'], td[('dbm_sample', True, 'kernel')],
              td[('dbm_sample', True, 'plain')],
              dbm_sweep_work(*DBM_SIZES, DBM_M),
              dbm_gemm_act_shapes=shapes(*dbm_step_shapes[3:])),
        # per beta of 100 runs with k = 5; the plain version with sampling
        # off (its Philox emulation would dominate)
        entry('ais', 'dbm_ops.cu', dbm_launches['ais'], dbm_err['ais'],
              td[('ais', True, 'kernel')], td[('ais', False, 'plain')],
              ais_beta_work(*DBM_SIZES, 100, 5), plain_sampling='off',
              dbm_gemm_act_shapes=shapes('ais_v', 'ais_h2', 'ais_h1',
                                         'ais_lp_v', 'ais_lp_h2')),
        # per G-RBM step, 3072 x 5000, B = 100, k = 1, states sampled;
        # launches from the dbm_cifar_naive G-RBM fit
        entry('cd_epoch_gaussian', 'cd_epoch.cu', g_launches,
              cifar_err['cd_epoch_gaussian'], tc[('grbm', True, 'kernel')],
              tc[('grbm', True, 'plain')], cd_step_work(*GRBM, CIFAR_B),
              sampled_probe_steps_exact=cifar_share['grbm'],
              sampled_h_draws_differing=cifar_share['grbm_h_draws'],
              sampled_v_states_max_rel_err=cifar_share['grbm_v_states'],
              cd_gemm_act_shapes=shapes('grbm_h', 'grbm_v'),
              cd_assoc_update_shapes=assoc('grbm'), **stage('grbm')),
        # per M-RBM step, 5000 x 1000, B = 100, n = 1000, hiddens sampled;
        # launches from the dbm_cifar_naive M-RBM fit
        entry('cd_epoch_multinomial', 'cd_epoch.cu', m_launches,
              cifar_err['cd_epoch_multinomial'], tc[('mrbm', True, 'kernel')],
              tc[('mrbm', True, 'plain')],
              cd_step_work(*MRBM, CIFAR_B, n_samples=N_SAMPLES),
              sampled_probe_steps_exact=cifar_share['mrbm'],
              sampled_h_draws_differing=cifar_share['mrbm_h_draws'],
              cd_gemm_act_shapes=shapes('mrbm_h', 'mrbm_v'),
              cd_assoc_update_shapes=assoc('mrbm'), **stage('mrbm')),
        # the three standalone launchers at the path's shapes: `launches`
        # is their own count from the phase that drives them once each;
        # `path_launches` the measured launches, on the dbm_cifar_naive
        # path, of the epoch kernel whose launches carry the same device
        # functions (a third of the G-RBM's cd_gemm_act launches are its
        # sampled Gaussian visible pass)
        *(entry(name, 'cd_epoch.cu', sampler[name]['launches'],
                sampler[name]['err'], sampler[name]['ms'],
                sampler[name]['plain_ms'], sampler[name]['work'],
                sampler[name].get('library_ms'),
                path_launches=path_launches, shape=shape,
                **{k: sampler[name][k] for k in ('device_ms',
                                                 'library_device_ms',
                                                 'bound_parts')
                   if k in sampler[name]})
          for name, path_launches, shape in (
              ('normal_sample',
               {'cd_gemm_act': g_launches['cd_gemm_act']},
               [CIFAR_B, GRBM[0]]),
              ('multinomial_sample',
               {'cd_softmax_sample': m_launches['cd_softmax_sample']},
               [CIFAR_B, MRBM[1], N_SAMPLES]),
              ('free_energy_probe',
               {'cd_metrics': m_launches['cd_metrics']},
               [CIFAR_B, *MRBM, N_SAMPLES]))),
        # per stats call at the G-RBM's local shape (3072 x 7800, 50 rows,
        # k = 1, both states sampled); launches: both ranks' on the 2-rank
        # G-RBM fit (the main path of the data-parallel slice)
        entry('cd_stats', 'cd_epoch.cu',
              {k: sum(r[k] for r in dp_stats) for k in dp_stats[0]},
              max(stats_err.values()), wide['ms'], wide['plain_ms'],
              stats_work(*GRBM_WIDE, CIFAR_B // DP_WORLD),
              launches_per_rank=dp_stats, kernel_us=wide['kernel_us'],
              device_busy=wide['busy'],
              cd_gemm_act_library_ms=wide['library_ms'],
              sampling_off_ms=wide['ms_sampling_off'],
              plain_sampling_off_ms=wide['plain_ms_sampling_off'],
              mnist_784x1024_local_128=dict(
                  ms=mnist['ms'], plain_ms=mnist['plain_ms'],
                  bound_ms=bound(*stats_work(V, H, 256 // DP_WORLD))[0],
                  cd_gemm_act_library_ms=mnist['library_ms'],
                  kernel_us=mnist['kernel_us']),
              world1_step_ms={'data_parallel': w1[('data_parallel', True)],
                              'cd_epoch': w1[('epoch', True)],
                              'data_parallel_sampling_off':
                                  w1[('data_parallel', False)],
                              'cd_epoch_sampling_off': w1[('epoch', False)]},
              world1_kernel_us=w1['kernel_us'], world1_max_abs_err=w1['err'],
              fit_784x1024_max_abs_err=dp['mnist_err'],
              cd_gemm_act_shapes=shapes('stats_7800_h', 'stats_7800_v',
                                        'stats_784_h', 'stats_784_v'),
              cd_assoc_stats_shapes=assoc('stats_7800', 'stats_784')),
        # per call at (100, 7800), the G-RBM's hidden draw; `launches` its
        # own count from the phase that drives it once per shape;
        # `path_launches` the stats kernels' cd_gemm_act launches that
        # carry its body (the Bernoulli hidden draws) on the 2-rank fit
        entry('bernoulli_sample', 'cd_epoch.cu', bern['launches'], bern['err'],
              bern['ms'], bern['plain_ms'], bern['work'], bern['library_ms'],
              path_launches={'cd_gemm_act': sum(r['cd_gemm_act']
                                                for r in dp_stats)},
              shape=[CIFAR_B, GRBM_WIDE[1]], ms_10x1024=bern['small_ms'],
              device_ms=bern['device_ms'],
              library_device_ms=bern['library_device_ms'],
              bound_parts=bern['bound_parts']),
    ]
    for e in kernels:
        for kernel, *labels in walks.get(e['name'], ()):
            e[kernel + '_shapes'] = walk(kernel, *labels)
        if e['name'] == 'dbm_epoch':
            e['step_profile'] = dbm_prof
            e['mf_loop_50_sweeps'] = kt[('dbm_mf_loop', 'mf_50')]
    say(json.dumps({'kernels': kernels}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def kernel_times_only():
    """``python3 chip_smoke.py --kernel-times``: phase 18 alone, after the
    environment and the build, with one JSON line of its numbers -- so that
    this script times the kernels of another checkout (run it from there)."""
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write('chip_smoke: no CUDA device\n')
        return 1
    card = environment(torch)
    build()
    kt = kernel_times(torch)
    prof = dbm_step_profile(torch)
    say(card)
    say(json.dumps({'kernel_times': {'%s %s' % k: v for k, v in kt.items()},
                    'dbm_step_profile': prof}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--dp-rank']:
        rank, world, tmpdir = sys.argv[2:]
        sys.exit(dp_rank(int(rank), int(world), tmpdir))
    sys.exit({'--readings': readings, '--assoc-readings': assoc_readings,
              '--softmax-readings': softmax_readings,
              '--sampler-readings': sampler_readings,
              '--pll-readings': pll_readings,
              '--kernel-times': kernel_times_only}
             .get(' '.join(sys.argv[1:]), main)())
