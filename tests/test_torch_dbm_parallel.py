"""The port's data-parallel DBM (``DBM.set_mesh``, ``ops/dbm_ops.
dbm_mesh_epoch``) on the CPU: two ranks over torch.distributed's gloo
backend, each in its own process, meeting through a ``file://`` store under
the module's tmp dir (as tests/test_torch_parallel.py runs the RBM's), all
jobs in one start of the two ranks, which must end within 300 s.  Held
against the JAX package's shard_map fit on two of its virtual CPU devices
(tests/test_parallel.py:124-157's configuration, plus a validation set and
a remainder batch), against the port's one-process fit, and against a
brute-force log Z (tests/test_parallel.py:182-212).  With sampling on, the
ranks draw under their own keys, so the 2-rank fit is held against the
one-process fit by its statistics over five seeds, as
tests/test_torch_dbm_sampled.py holds the port against JAX."""

import itertools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from boltzmann_machines_tpu import BernoulliRBM as JaxBernoulliRBM
from boltzmann_machines_tpu import DBM as JaxDBM
from boltzmann_machines_tpu.parallel import make_mesh as jax_make_mesh
from boltzmann_machines_tpu_torch import (DBM, BernoulliRBM, GaussianRBM,
                                          MultinomialRBM, load_model,
                                          parallel)
from boltzmann_machines_tpu_torch.ops import dbm_ops
from boltzmann_machines_tpu_torch.utils import RNG, log_sum_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one rank: argv = rank, world, tmp; for each job of tmp/jobs.json, a DBM
# over the RBM checkpoints it names, fitted on the mesh, then its asks;
# writes tmp/<job>_out<rank>.npz
WORKER = r'''
import json, sys
import numpy as np
from boltzmann_machines_tpu_torch import DBM, load_model, parallel
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
with open(tmp + '/jobs.json') as f:
    jobs = json.load(f)
parallel.initialize('file://' + tmp + '/store', world, rank, backend='gloo')
for job in jobs:
    data = np.load(tmp + '/' + job.get('data', job['name']) + '.npz')
    cfg = dict(job['cfg'])
    if 'v_init' in data.files:
        cfg.update(v_particle_init=data['v_init'],
                   h_particles_init=(data['h0_init'], data['h1_init']))
    dbm = DBM(rbms=[load_model(p, device='cpu') for p in job['rbms']],
              device='cpu', model_path='%s/%s_rank%d/' % (tmp, job['name'],
                                                          rank), **cfg)
    dbm.set_mesh(parallel.make_mesh())
    out = dict(eligible=dbm._shardmap_eligible())
    dbm.fit(data['X'], data['X_val'] if 'X_val' in data.files else None)
    out.update(dbm.get_params_arrays(), iter_=dbm.iter_,
               sharded=dbm._sharded)
    for key, kw in job.get('log_Z', {}).items():
        res = dbm.log_Z(**kw)[2]
        out.update({key + '_' + k: v for k, v in res.items()}
                   if isinstance(res, dict) else {key: res})
    if job.get('sample_v'):
        out['sample_v'] = dbm.sample_v(n_gibbs_steps=job['sample_v'])
    if job.get('reconstruct'):
        out['recon'] = dbm.reconstruct(data['X_val'])
    np.savez('%s/%s_out%d.npz' % (tmp, job['name'], rank), **out)
'''


def run_ranks(tmp, jobs, world=2):
    with open(tmp + '/jobs.json', 'w') as f:
        json.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, '-c', WORKER, str(r),
                               str(world), tmp], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return {job['name']: [dict(np.load('%s/%s_out%d.npz' % (
        tmp, job['name'], r))) for r in range(world)] for job in jobs}


def read_scalars(logdir):
    with open(os.path.join(logdir, 'scalars.jsonl')) as f:
        return {(r['tag'], r['step']): r['value'] for r in map(json.loads, f)}


# the 2-rank fit of tests/test_parallel.py:124-157 (12-8-6, batch 16, 16
# particles, k 2), sampling off, with 4 full batches and a remainder of 8,
# a validation set, L2 and sparsity
PARITY = dict(n_particles=16, n_gibbs_steps=2, max_mf_updates=10,
              learning_rate=0.01, momentum=0.5, max_epoch=2, batch_size=16,
              max_norm=4., l2=1e-4, sparsity_target=[0.2, 0.1],
              sparsity_cost=[1e-2, 5e-3], random_seed=3, verbose=False,
              sample_v_states=False, sample_h_states=[False, False],
              train_metrics_every_iter=1)
GBM = dict(PARITY, l2=0., sparsity_cost=0.)
SAMPLED = dict(PARITY, n_gibbs_steps=1, learning_rate=0.05, max_epoch=6,
               sample_v_states=True, sample_h_states=[True, True],
               sparsity_cost=0., max_mf_updates=20)
# the sampled fit at five seeds, its statistics against one process's
STAT_SEEDS = range(5)
#: F(4, 4)'s 99.9% point: the variance ratio of two samples of 5
F_999 = 53.44
# 15 particles do not split over two ranks
FALLBACK = dict(PARITY, n_particles=15)
# tests/test_parallel.py:182-212 (6-5-4, sampling on)
AIS = dict(n_particles=16, n_gibbs_steps=1, max_mf_updates=5,
           learning_rate=0.01, momentum=0.5, max_epoch=1, batch_size=16,
           random_seed=3, verbose=False)


def particle_inits(rng, sizes, m):
    return dict(v_init=rng.rand(m, sizes[0]).astype(np.float32),
                h0_init=rng.rand(m, sizes[1]).astype(np.float32),
                h1_init=rng.rand(m, sizes[2]).astype(np.float32))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Pretrains the RBMs (JAX for the parity job, the port for the
    others), starts the two ranks once for every job, and returns the
    tmp dir, the data and each job's outputs by rank."""
    tmp = str(tmp_path_factory.mktemp('dbm_mesh'))
    rng = np.random.RandomState(0)
    d = {}
    # the parity job: JAX RBMs (the port's ranks load their checkpoints)
    X = (RNG(1).rand(72, 12) < 0.5).astype(np.float32)
    X_val = (rng.rand(20, 12) < 0.5).astype(np.float32)
    rk = dict(batch_size=16, max_epoch=1, verbose=False)
    r1 = JaxBernoulliRBM(n_visible=12, n_hidden=8, dbm_first=True,
                         random_seed=1, model_path=tmp + '/jr1/', **rk).fit(X)
    r2 = JaxBernoulliRBM(n_visible=8, n_hidden=6, dbm_last=True,
                         random_seed=2, model_path=tmp + '/jr2/', **rk)
    r2.fit(r1.transform(X))
    rbms = [tmp + '/jr1/', tmp + '/jr2/']
    d['parity'] = dict(X=X, X_val=X_val,
                       **particle_inits(rng, (12, 8, 6), 16))
    d['fallback'] = dict(X=X, X_val=X_val,
                         **particle_inits(rng, (12, 8, 6), 15))
    # a sampled fit on two prototypes with noise
    protos = (rng.rand(2, 12) < 0.5).astype(np.float32)
    Xs = protos[rng.randint(0, 2, 160)]
    Xs = np.abs(Xs - (rng.rand(*Xs.shape) < 0.05)).astype(np.float32)
    d['sampled'] = dict(X=Xs)
    Xv = protos[rng.randint(0, 2, 32)]
    d['stats'] = dict(X=Xs, X_val=np.abs(Xv - (rng.rand(*Xv.shape) < 0.05))
                      .astype(np.float32))
    # G-B-M: the port's Gaussian (sigma 1.5, dbm_first) and multinomial
    # (n 5, dbm_last) RBMs
    Xg = rng.randn(72, 12).astype(np.float32)
    g = GaussianRBM(n_visible=12, n_hidden=8, sigma=1.5, dbm_first=True,
                    random_seed=1, device='cpu', model_path=tmp + '/gr1/',
                    **rk).fit(Xg)
    MultinomialRBM(n_visible=8, n_hidden=6, n_samples=5, dbm_last=True,
                   random_seed=2, device='cpu', model_path=tmp + '/gr2/',
                   **rk).fit(g.transform(Xg))
    d['gbm'] = dict(X=Xg, X_val=rng.randn(20, 12).astype(np.float32),
                    **particle_inits(rng, (12, 8, 6), 16))
    # 6-5-4 for AIS
    Xa = (RNG(1).rand(64, 6) < 0.4).astype(np.float32)
    a1 = BernoulliRBM(n_visible=6, n_hidden=5, dbm_first=True, random_seed=1,
                      device='cpu', model_path=tmp + '/ar1/', **rk).fit(Xa)
    BernoulliRBM(n_visible=5, n_hidden=4, dbm_last=True, random_seed=2,
                 device='cpu', model_path=tmp + '/ar2/',
                 **rk).fit(a1.transform(Xa))
    d['ais'] = dict(X=Xa)
    for name, arrays in d.items():
        np.savez('%s/%s.npz' % (tmp, name), **arrays)
    gbm_rbms = [tmp + '/gr1/', tmp + '/gr2/']
    jobs = [dict(name='parity', rbms=rbms, cfg=PARITY, sample_v=2),
            dict(name='fallback', rbms=rbms, cfg=FALLBACK),
            dict(name='sampled', rbms=rbms, cfg=SAMPLED),
            *(dict(name='stats%d' % seed, data='stats', rbms=rbms,
                   cfg=dict(SAMPLED, random_seed=seed), reconstruct=True)
              for seed in STAT_SEEDS),
            dict(name='gbm', rbms=gbm_rbms, cfg=GBM),
            dict(name='ais', rbms=[tmp + '/ar1/', tmp + '/ar2/'], cfg=AIS,
                 sample_v=3, log_Z=dict(
                     forward=dict(n_betas=300, n_runs=64, n_gibbs_steps=1),
                     replicated=dict(n_betas=50, n_runs=63,
                                     n_gibbs_steps=1),
                     bdmc=dict(n_betas=200, n_runs=64, n_gibbs_steps=1,
                               bdmc=True, bdmc_burn_in=50)))]
    return tmp, d, {job['name']: job for job in jobs}, run_ranks(tmp, jobs)


def one_process(tmp, job, data, name):
    """The port's one-process fit of a job (`data` a dict or an npz)."""
    cfg = dict(job['cfg'])
    if 'v_init' in data:
        cfg.update(v_particle_init=data['v_init'],
                   h_particles_init=(data['h0_init'], data['h1_init']))
    dbm = DBM(rbms=[load_model(p, device='cpu') for p in job['rbms']],
              device='cpu', model_path='%s/%s/' % (tmp, name), **cfg)
    return dbm.fit(data['X'], data['X_val'] if 'X_val' in data else None)


def assert_close(got, want, atol, keys=None):
    for key in keys or want:
        tol = atol * (16 if 'means' in key else 1)
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0,
                                   err_msg=key)


def test_two_rank_fit_matches_jax_mesh_fit(runs):
    """The JAX package's shard_map fit on two devices (sampling off) against
    the ports' two ranks: weights and biases within 1e-5, the same number
    of iterations (4 full batches and a remainder, 2 epochs)."""
    tmp, d, jobs, outs = runs
    cfg = dict(PARITY, v_particle_init=d['parity']['v_init'],
               h_particles_init=(d['parity']['h0_init'],
                                 d['parity']['h1_init']))
    jd = JaxDBM(rbms=[JaxBernoulliRBM.load_model(p)
                      for p in jobs['parity']['rbms']],
                model_path=tmp + '/jax_mesh/', **cfg)
    jd.set_mesh(jax_make_mesh(devices=jax.devices()[:2]))
    assert jd._shardmap_eligible()
    jd.fit(d['parity']['X'], d['parity']['X_val'])
    assert int(outs['parity'][0]['iter_']) == jd.iter_ == 10
    assert bool(outs['parity'][0]['eligible'])
    assert bool(outs['parity'][0]['sharded'])
    want = jd.get_params_arrays()
    assert_close(outs['parity'][0], want, 1e-5,
                 [k for k in want if k.startswith('weights/')])


def test_two_rank_fit_matches_one_process(runs):
    """The same fit in one process: every state array within 1e-5 (the
    sparsity EMAs of batch sums within 16 x that), the train and validation
    msre / n_mf streams within 1e-6; rank 1 wrote nothing."""
    tmp, d, jobs, outs = runs
    ref = one_process(tmp, jobs['parity'], d['parity'], 'parity_one')
    assert_close(outs['parity'][0], ref.get_params_arrays(), 1e-5)
    for sub in ('logs/train', 'logs/val'):
        a = read_scalars('%s/parity_one/%s' % (tmp, sub))
        b = read_scalars('%s/parity_rank0/%s' % (tmp, sub))
        assert sorted(a) == sorted(b) and a
        for tag_step in a:
            np.testing.assert_allclose(b[tag_step], a[tag_step], atol=1e-6,
                                       err_msg=str(tag_step))
    assert not os.path.exists(tmp + '/parity_rank1/')


def test_two_rank_replicas_bit_identical(runs):
    """Every job leaves both ranks with the same state, bit for bit (the
    particles gathered), and the same log_Z values and sample_v means."""
    _, _, _, outs = runs
    for name, (a, b) in outs.items():
        assert set(a) == set(b)
        for key in a:
            assert np.array_equal(a[key], b[key]), (name, key)


def test_gbm_two_ranks_match_one_process(runs):
    """A Gaussian-Bernoulli-multinomial DBM (sigma 1.5, n 5) on two ranks
    against one process, sampling off: state within 1e-5 (counts' EMAs
    16 x)."""
    tmp, d, jobs, outs = runs
    assert bool(outs['gbm'][0]['eligible'])
    ref = one_process(tmp, jobs['gbm'], d['gbm'], 'gbm_one')
    assert_close(outs['gbm'][0], ref.get_params_arrays(), 1e-5)


def test_sampled_two_rank_fit_learns(runs):
    """Sampling on, each rank's draws under its own keys: the train msre is
    finite every epoch and falls from the first epoch to the last."""
    tmp, _, _, outs = runs
    assert bool(outs['sampled'][0]['sharded'])
    msre = [v for (tag, _), v in sorted(
        read_scalars(tmp + '/sampled_rank0/logs/train').items(),
        key=lambda kv: kv[0][1]) if tag == 'mean_squared_recon_error']
    assert len(msre) == SAMPLED['max_epoch']
    assert np.all(np.isfinite(msre))
    assert msre[-1] < msre[0]


@pytest.fixture(scope='module')
def sampled_stats(runs):
    """{'mesh' / 'one': (n_seeds, 2) array of (final validation msre, mean
    |W_0 - W_0 at init|)} of the sampled fit, on two ranks and in one
    process, at each of STAT_SEEDS."""
    tmp, d, jobs, outs = runs
    W0_init = load_model(jobs['stats0']['rbms'][0], device='cpu') \
        .get_params_arrays()['weights/W']
    X_val = d['stats']['X_val']
    out = {'mesh': [], 'one': []}
    for seed in STAT_SEEDS:
        job = jobs['stats%d' % seed]
        mesh = outs[job['name']][0]
        out['mesh'].append((float(np.mean((X_val - mesh['recon']) ** 2)),
                            float(np.mean(np.abs(mesh['weights/W_0'] -
                                                 W0_init)))))
        ref = one_process(tmp, job, d['stats'], job['name'] + '_one')
        out['one'].append((float(np.mean((X_val - ref.reconstruct(X_val)) **
                                         2)),
                           float(np.mean(np.abs(ref.get_params_arrays()[
                               'weights/W_0'] - W0_init)))))
    return {k: np.array(v) for k, v in out.items()}


@pytest.mark.parametrize('stat', ['val_msre', 'mean_abs_dW0'])
def test_sampled_two_rank_fit_matches_one_process_in_distribution(
        sampled_stats, stat):
    """Sampling on: over five seeds, the means of the 2-rank fit's final
    validation msre and of its mean |W_0 - W_0 at init| lie within 3
    standard errors of the one-process sampled fit's (ROADMAP Queue C23;
    each rank draws under its own keys, so no single fit compares draw by
    draw)."""
    col = ('val_msre', 'mean_abs_dW0').index(stat)
    a, b = sampled_stats['one'][:, col], sampled_stats['mesh'][:, col]
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    assert abs(b.mean() - a.mean()) <= 3. * se, (
        '%s: one process %.5g +- %.2g, 2 ranks %.5g +- %.2g over %d seeds' % (
            stat, a.mean(), a.std(ddof=1), b.mean(), b.std(ddof=1), len(a)))


def test_sampled_two_rank_fit_spread_matches_one_process(sampled_stats):
    """The variance over the seeds of mean |W_0 - W_0 at init|, 2 ranks
    over one process, lies within the 0.1% and 99.9% points of F(4, 4):
    ranks whose draws did not follow the fit's seed would collapse it."""
    a, b = sampled_stats['one'][:, 1], sampled_stats['mesh'][:, 1]
    ratio = b.var(ddof=1) / a.var(ddof=1)
    assert 1. / F_999 <= ratio <= F_999, (
        'variance of mean |dW0| over the seeds: 2 ranks / one process = '
        '%.3g' % ratio)


def test_fallback_when_rows_do_not_split(runs):
    """Particles that do not split over the ranks: every rank trains whole
    batches through the single-device path, as the one-process fit does
    (within 1e-6), its chains whole."""
    tmp, d, jobs, outs = runs
    out = outs['fallback'][0]
    assert not bool(out['eligible']) and not bool(out['sharded'])
    ref = one_process(tmp, jobs['fallback'], d['fallback'], 'fallback_one')
    assert_close(out, ref.get_params_arrays(), 1e-6)
    assert out['negative_particles/v'].shape == (15, 12)


def exact_log_Z(s):
    W0, W1 = s['weights/W_0'], s['weights/W_1']
    Hs = np.array(list(itertools.product([0., 1.], repeat=W0.shape[1])))
    logp = Hs @ s['weights/hb_0']
    logp = logp + np.log1p(np.exp(Hs @ W0.T + s['weights/vb'])).sum(1)
    logp = logp + np.log1p(np.exp(Hs @ W1 + s['weights/hb_1'])).sum(1)
    return log_sum_exp(logp)


def test_log_Z_on_two_ranks_matches_bruteforce(runs):
    """AIS runs split over the ranks (64) or replicated (63): the same
    values on both ranks, and the forward estimate within 0.2 of the
    enumerated log Z (tests/test_parallel.py:182-212); BDMC's bounds
    finite and ordered."""
    from boltzmann_machines_tpu_torch.utils import log_mean_exp
    _, _, _, outs = runs
    out = outs['ais'][0]
    exact = exact_log_Z(out)
    assert out['forward'].shape == (64,) and out['replicated'].shape == (63,)
    assert abs(log_mean_exp(out['forward']) - exact) < 0.2
    assert abs(log_mean_exp(out['replicated']) - exact) < 0.2
    low = log_mean_exp(out['bdmc_forward'])
    up = float(out['bdmc_log_Z_upper'])
    assert out['bdmc_reverse'].shape == (64,)
    assert np.isfinite(low) and np.isfinite(up) and up >= low - 0.15


def test_sample_v_gathered(runs):
    """sample_v on the mesh returns the whole (n_particles, V) means on
    every rank; the checkpoint's particles stay whole."""
    _, _, _, outs = runs
    for name, shape in (('parity', (16, 12)), ('ais', (16, 6))):
        v = outs[name][0]['sample_v']
        assert v.shape == shape and np.all((v >= 0) & (v <= 1))
        assert outs[name][0]['negative_particles/v'].shape == shape


def test_mesh_checkpoint_loads_in_one_process_and_jax(runs):
    """Rank 0's checkpoint holds the gathered chains: it loads in one
    process of the port and in the JAX package with rank 0's arrays."""
    tmp, _, _, outs = runs
    want = {k: v for k, v in outs['parity'][0].items() if '/' in k}
    path = tmp + '/parity_rank0/'
    got = load_model(path, device='cpu').get_params_arrays()
    jgot = JaxDBM.load_model(path)._get_state_arrays()
    assert set(got) == set(want) and set(jgot) == set(want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)
        np.testing.assert_array_equal(np.asarray(jgot[key]), v, err_msg=key)


@pytest.fixture
def one_rank(tmp_path):
    parallel.initialize('file://' + str(tmp_path) + '/store', 1, 0,
                        backend='gloo')
    try:
        yield parallel.make_mesh()
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_epoch_equals_single_device_epoch(tmp_path, one_rank):
    """The mesh epoch driven directly on one rank (mean-field with the MAX
    all_reduce, the sums' SUM all_reduce, the update) equals the
    single-device plain epoch, sampling off, within 1e-6; so do its msre
    and n_mf rows."""
    rng = np.random.RandomState(5)
    sizes = (12, 8, 6)
    X = torch.tensor((rng.rand(3, 8, 12) < 0.4).astype(np.float32))
    state = {
        'vb': torch.zeros(12), 'hb': (torch.full((8,), -0.5),
                                      torch.zeros(6)),
        'W': (torch.tensor(rng.randn(12, 8) * 0.1, dtype=torch.float32),
              torch.tensor(rng.randn(8, 6) * 0.1, dtype=torch.float32)),
        'dvb': torch.zeros(12), 'dhb': (torch.zeros(8), torch.zeros(6)),
        'dW': (torch.zeros(12, 8), torch.zeros(8, 6)),
        'q_means': (torch.zeros(8), torch.zeros(6)),
        'mu_means': (torch.zeros(8), torch.zeros(6)),
        'v': torch.rand(10, 12), 'H': (torch.rand(10, 8), torch.rand(10, 6))}
    cfg = dbm_ops.DBMEpochConfig(sizes, 2, 10, 1e-7, False, (False, False),
                                 1e-4, 4., (0.2, 0.1), (1e-2, 5e-3), 0.9)
    want, msre, n_mf = dbm_ops.dbm_epoch_reference(cfg, state, X, 0.01, 0.5,
                                                   7, 0)

    def reduce(op):
        return lambda t: dist.all_reduce(t, op=op, group=one_rank.group)
    got, sq, n_mf_mesh = dbm_ops.dbm_mesh_epoch(
        cfg, state, X, 0.01, 0.5, 7, 0, 8, 10, reduce(dist.ReduceOp.SUM),
        reduce(dist.ReduceOp.MAX))
    for key in dbm_ops.STATE_KEYS:
        pairs = zip(want[key], got[key]) if isinstance(want[key], tuple) \
            else [(want[key], got[key])]
        for a, b in pairs:
            torch.testing.assert_close(b, a, atol=1e-6, rtol=0, msg=key)
    torch.testing.assert_close(sq / (8 * 12), msre, atol=1e-7, rtol=0)
    assert torch.equal(n_mf_mesh, n_mf)
