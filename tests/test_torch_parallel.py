"""The port's data-parallel RBM training (boltzmann_machines_tpu_torch/
parallel/ and ``BaseRBM.set_mesh``) on the CPU: two ranks over
torch.distributed's gloo backend, each in its own process, against the JAX
package's mesh fit on its 8 virtual CPU devices (tests/conftest.py).  Every
multi-process run starts its ranks as subprocesses that meet through a
``file://`` store under the test's tmp_path (no TCP port, so parallel test
workers cannot collide) and must end within 180 s."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from boltzmann_machines_tpu import (BernoulliRBM as JaxBernoulliRBM,
                                    GaussianRBM as JaxGaussianRBM)
from boltzmann_machines_tpu.parallel import make_mesh as jax_make_mesh
from boltzmann_machines_tpu_torch import (DBM, BernoulliRBM, GaussianRBM,
                                          MultinomialRBM, parallel)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one rank: argv = rank, world, tmp; reads tmp/job.json and tmp/data.npz,
# fits on the mesh, writes tmp/out<rank>.npz
WORKER = r'''
import json, sys
import numpy as np
from boltzmann_machines_tpu_torch import BernoulliRBM, GaussianRBM, parallel
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
with open(tmp + '/job.json') as f:
    job = json.load(f)
data = np.load(tmp + '/data.npz')
info = parallel.initialize('file://' + tmp + '/store', world, rank,
                           backend='gloo')
assert info['process_index'] == rank and info['process_count'] == world
cls = {'BernoulliRBM': BernoulliRBM, 'GaussianRBM': GaussianRBM}[job['cls']]
cfg = dict(job['cfg'], W_init=data['W_init'])
rbm = cls(device='cpu', model_path='%s/rank%d/' % (tmp, rank), **cfg)
rbm.set_mesh(parallel.make_mesh())
assert rbm._shardmap_eligible()
rbm.fit(data['X'], data['X_val'] if 'X_val' in data.files else None)
out = dict(rbm.get_params_arrays(), iter_=rbm.iter_,
           fe_data=rbm.free_energy(data['X']),
           fe_rand=rbm.free_energy(data['X_rand']))
np.savez('%s/out%d.npz' % (tmp, rank), **out)
'''


def run_ranks(tmp, cls, cfg, world=2, **arrays):
    """Fit `cls(**cfg)` on `world` gloo ranks; returns each rank's output
    arrays."""
    tmp = str(tmp)
    with open(tmp + '/job.json', 'w') as f:
        json.dump({'cls': cls, 'cfg': cfg}, f)
    np.savez(tmp + '/data.npz', **arrays)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, '-c', WORKER, str(r),
                               str(world), tmp], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [dict(np.load('%s/out%d.npz' % (tmp, r))) for r in range(world)]


def read_scalars(logdir):
    with open(os.path.join(logdir, 'scalars.jsonl')) as f:
        return {(r['tag'], r['step']): r['value'] for r in map(json.loads, f)}


def parity_config(flavour, rng):
    cfg = dict(n_visible=12, n_hidden=8, hb_init=-0.5, batch_size=16,
               max_epoch=3, learning_rate=[0.05, 0.1, 0.02],
               momentum=[0.5, 0.9], l2=1e-4, sparsity_target=0.1,
               sparsity_cost=1e-2, sparsity_damping=0.9,
               sample_v_states=False, sample_h_states=False,
               metrics_config=dict(msre=True, pll=True, l2_loss=True,
                                   feg=True, train_metrics_every_iter=2,
                                   feg_every_epoch=1, n_batches_for_feg=2),
               random_seed=3, verbose=False)
    if flavour == 'gaussian':
        cfg.update(sigma=1.5, learning_rate=[0.01, 0.02, 0.005])
        X, X_val = rng.randn(88, 12), rng.randn(20, 12)
    else:
        X, X_val = rng.rand(88, 12) < 0.4, rng.rand(20, 12) < 0.4
    return cfg, X.astype(np.float32), X_val.astype(np.float32)


@pytest.mark.parametrize('flavour', ['bernoulli', 'gaussian'])
def test_two_rank_fit_matches_jax_mesh_fit(tmp_path, flavour):
    """Sampling off, 88 rows in batches of 16 (5 full batches and a
    remainder of 8), a validation set, L2 and sparsity: two gloo ranks
    against the JAX package's shard_map fit over 8 devices.  Weights and
    accumulators within 1e-5; the msre, l2 and FEG streams within 1e-5 (the
    PLL flips come from other random streams); both ranks' states bit
    for bit the same; rank 1 writes nothing."""
    rng = np.random.RandomState(0)
    cfg, X, X_val = parity_config(flavour, rng)
    W_init = (rng.randn(12, 8) * 0.1).astype(np.float32)
    jcls = JaxGaussianRBM if flavour == 'gaussian' else JaxBernoulliRBM
    jrbm = jcls(model_path=str(tmp_path) + '/jax/', W_init=W_init, **cfg)
    jrbm.set_mesh(jax_make_mesh())
    assert jrbm._shardmap_eligible()
    jrbm.fit(X, X_val)

    outs = run_ranks(tmp_path, type(jrbm).__name__, cfg, X=X, X_val=X_val,
                     W_init=W_init, X_rand=X)
    assert int(outs[0]['iter_']) == jrbm.iter_ == 18
    for key, v in outs[0].items():
        assert np.array_equal(v, outs[1][key]), key
    for key, v in jrbm.get_params_arrays().items():
        atol = 1e-5 * (16 if key.endswith('q_means') else 1)
        np.testing.assert_allclose(outs[0][key], v, atol=atol, err_msg=key)
    for sub in ('logs/train', 'logs/val'):
        a = read_scalars(str(tmp_path) + '/jax/' + sub)
        b = read_scalars(str(tmp_path) + '/rank0/' + sub)
        assert sorted(a) == sorted(b) and a
        for tag_step in a:
            if tag_step[0] != 'pseudo_loglikelihood':
                np.testing.assert_allclose(b[tag_step], a[tag_step],
                                           atol=1e-5, err_msg=str(tag_step))
    assert os.path.isfile(str(tmp_path) + '/rank0/params.json')
    assert not os.path.exists(str(tmp_path) + '/rank1/')


def test_two_rank_sampled_fit_learns(tmp_path):
    """Sampling on, each rank on its own Philox shard: training lowers the
    free energy of the data below that of random rows
    (tests/test_parallel.py:105)."""
    rng = np.random.RandomState(7)
    protos = (rng.rand(2, 16) < 0.5).astype(np.float32)
    X = protos[rng.randint(0, 2, 128)]
    X_rand = (np.random.RandomState(3).rand(128, 16) < 0.5).astype(
        np.float32)
    cfg = dict(n_visible=16, n_hidden=12, max_epoch=15, batch_size=16,
               learning_rate=0.1, momentum=0.5, l2=0., random_seed=1337,
               verbose=False, save_after_each_epoch=False)
    outs = run_ranks(tmp_path, 'BernoulliRBM', cfg, X=X, X_rand=X_rand,
                     W_init=(rng.randn(16, 12) * 0.01).astype(np.float32))
    assert np.array_equal(outs[0]['weights/W'], outs[1]['weights/W'])
    assert float(outs[0]['fe_data']) < float(outs[0]['fe_rand'])


@pytest.fixture
def one_rank(tmp_path):
    """A one-process gloo group in this process, torn down after the
    test."""
    parallel.initialize('file://' + str(tmp_path) + '/store', 1, 0,
                        backend='gloo')
    try:
        yield parallel.make_mesh()
    finally:
        dist.destroy_process_group()


def test_world1_epoch_equals_generic_epoch(tmp_path, one_rank):
    """The data-parallel epoch driven directly on one rank (its stats body,
    an all_reduce over one rank, the update) equals the single-device
    generic epoch within 1e-6, sampling off; so do the msre and l2 rows."""
    rng = np.random.RandomState(5)
    X = (rng.rand(48, 12) < 0.4).astype(np.float32)
    cfg = dict(n_visible=12, n_hidden=8, W_init=rng.randn(12, 8) * 0.1,
               batch_size=8, sample_v_states=False, sample_h_states=False,
               l2=1e-4, sparsity_cost=1e-2, device='cpu',
               metrics_config=dict(msre=True, pll=True, l2_loss=True,
                                   train_metrics_every_iter=2),
               model_path=str(tmp_path) + '/m/')
    a, b = BernoulliRBM(**cfg), BernoulliRBM(**cfg)
    a.set_mesh(one_rank)
    assert a._shardmap_eligible() and not a._stats_kernel_eligible()
    for m in (a, b):
        m._ensure_state()
    full, _, _ = a._stage_batches(X)
    rows_a = a._train_epoch_shardmap(full, None, 0.05, 0.9, 1, 9)
    rows_b = b._train_epoch_generic(full, None, 0.05, 0.9, 1, 9)
    assert a.iter_ == b.iter_ == 6
    for key, v in b._state.as_dict().items():
        torch.testing.assert_close(a._state.as_dict()[key], v, rtol=0,
                                   atol=1e-6, msg=key)
    for i in (0, 2):  # msre, l2 (the PLL flips differ)
        torch.testing.assert_close(rows_a[0][i], rows_b[0][i], rtol=0,
                                   atol=1e-6)
    assert float(rows_a[0][1][1]) < 0 and float(rows_a[0][1][0]) == 0


def test_mesh_helpers_on_one_rank(one_rank):
    """make_mesh / shard_batch / replicate over one rank; the parts that
    are not ported raise, naming their ROADMAP item."""
    assert one_rank.rank == 0 and one_rank.size == 1
    assert one_rank.axis_names == ('data',)
    X = torch.arange(12.).reshape(6, 2)
    assert torch.equal(parallel.shard_batch(one_rank, X), X)
    tree = {'a': torch.ones(3), 'b': [torch.zeros(2)]}
    assert parallel.replicate(one_rank, tree) is tree
    assert parallel.process_local_slice(10) == (0, 10)
    with pytest.raises(NotImplementedError, match='A9'):
        parallel.shard_model_columns(one_rank, torch.zeros(4, 4))
    rbm = BernoulliRBM(n_visible=4, n_hidden=2, device='cpu')
    with pytest.raises(NotImplementedError, match='A9'):
        rbm.set_mesh(one_rank, model_axis='model')
    with pytest.raises(NotImplementedError, match='A6.4'):
        DBM(rbms=[rbm], device='cpu').set_mesh(one_rank)


def test_initialize_single_process_gloo(tmp_path):
    """``parallel.distributed.initialize`` brings up a one-process gloo
    group and returns the JAX package's keys (tests/test_aux.py:39); run in
    a subprocess so that no group outlives it."""
    code = r'''
import sys
from boltzmann_machines_tpu_torch.parallel import distributed
info = distributed.initialize('file://' + sys.argv[1] + '/store', 1, 0,
                              backend='gloo')
assert info['process_index'] == 0 and info['process_count'] == 1, info
assert info['global_devices'] == 1 and info['local_devices'] >= 1, info
assert distributed.process_local_slice(10) == (0, 10)
print('DIST_OK')
'''
    out = subprocess.run([sys.executable, '-c', code, str(tmp_path)],
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'DIST_OK' in out.stdout


def test_mesh_eligibility():
    """The data-parallel epoch needs a batch that splits over the ranks
    and kernel != 'xla' (else every rank trains the whole batches); its
    stats kernels need Bernoulli or Gaussian visible x Bernoulli hidden,
    float32, no dropout, CUDA (nothing is allocated here)."""
    mesh = types.SimpleNamespace(rank=0, size=3, group=None,
                                 axis_names=('data',))
    kw = dict(n_visible=4, n_hidden=2)
    assert not BernoulliRBM(batch_size=16, device='cpu',
                            **kw).set_mesh(mesh)._shardmap_eligible()
    assert BernoulliRBM(batch_size=15, device='cpu',
                        **kw).set_mesh(mesh)._shardmap_eligible()
    assert not BernoulliRBM(batch_size=15, kernel='xla', device='cpu',
                            **kw).set_mesh(mesh)._shardmap_eligible()
    with pytest.raises(ValueError, match='axis'):
        BernoulliRBM(device='cpu', **kw).set_mesh(mesh, data_axis='batch')
    assert GaussianRBM(device='cuda', **kw)._stats_kernel_eligible()
    assert BernoulliRBM(device='cuda', **kw)._stats_kernel_eligible()
    assert not MultinomialRBM(device='cuda', **kw)._stats_kernel_eligible()
    assert not BernoulliRBM(device='cuda', dropout=0.5,
                            **kw)._stats_kernel_eligible()
    assert not BernoulliRBM(device='cpu', **kw)._stats_kernel_eligible()
