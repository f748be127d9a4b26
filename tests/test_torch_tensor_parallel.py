"""The port's tensor-parallel W (``parallel.make_mesh(shape=(D, M))``,
``BaseRBM.set_mesh(mesh, model_axis='model')``) on the CPU: gloo ranks, each
in its own process, meeting through a ``file://`` store under the module's
tmp dir (as tests/test_torch_dbm_parallel.py runs them).  One start of the
ranks a mesh shape -- (1, 2) on 2 ranks, (2, 2) on 4 -- runs every job and
must end within 300 s.

Held against the JAX package's tensor-parallel fit on its virtual CPU
devices (tests/test_parallel.py:159-179's configuration, sampling off), and
against the port's one-process generic fit with sampling on: every rank
draws the one-process stream and keeps its block of each draw, so the two
agree up to the order of their sums (Bernoulli, a Gaussian visible layer
with a per-unit sigma, a multinomial hidden layer, dropout, and 33 hidden
units over 2 ranks)."""

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
from boltzmann_machines_tpu.parallel import make_mesh as jax_make_mesh
from boltzmann_machines_tpu_torch import (DBM, BernoulliRBM, GaussianRBM,
                                          MultinomialRBM, load_model,
                                          parallel)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 2), (2, 2))
CLASSES = {c.__name__: c for c in (BernoulliRBM, GaussianRBM,
                                   MultinomialRBM)}

# one rank: argv = rank, world, tmp; builds the mesh of tmp/jobs.json's
# shape, fits each job's RBMs (and a job's DBM over two of them) on it,
# writes tmp/<job>_out<rank>.npz
WORKER = r'''
import json, sys
import numpy as np
import torch.distributed as dist
from boltzmann_machines_tpu_torch import (DBM, BernoulliRBM, GaussianRBM,
                                          MultinomialRBM, parallel)
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
with open(tmp + '/jobs.json') as f:
    spec = json.load(f)
parallel.initialize('file://' + tmp + '/store', world, rank, backend='gloo')
mesh = parallel.make_mesh(shape=spec['shape'])
classes = {c.__name__: c for c in (BernoulliRBM, GaussianRBM, MultinomialRBM)}


def fit(name, cls, cfg, X, X_val):
    data = np.load('%s/%s.npz' % (tmp, name))
    rbm = classes[cls](device='cpu', W_init=data['W_init'],
                       model_path='%s/%s_rank%d/' % (tmp, name, rank), **cfg)
    rbm.set_mesh(mesh, model_axis='model')
    epochs = []
    inner = rbm._train_epoch_tensor_parallel
    rbm._train_epoch_tensor_parallel = lambda *a: epochs.append(1) or inner(*a)
    rbm.fit(X, X_val)
    assert len(epochs) == cfg['max_epoch']
    return rbm


def run(job):
    data = np.load('%s/%s.npz' % (tmp, job['name']))
    X_val = data['X_val'] if 'X_val' in data.files else None
    rbm = fit(job['name'], job['cls'], job['cfg'], data['X'], X_val)
    out = dict(rbm.get_params_arrays(), block_W=rbm._state.W.numpy(),
               block_hb=rbm._state.hb.numpy(), iter_=rbm.iter_,
               H=rbm.transform(data['X']), fe=rbm.free_energy(data['X']))
    twin = classes[job['cls']](device='cpu', model_path=tmp + '/twin/',
                               **job['cfg'])
    twin.init_from(rbm)
    out['init_from_W'] = twin.get_params_arrays()['weights/W']
    if 'dbm' in job:
        top = fit(job['name'] + '_top', 'BernoulliRBM', job['top'],
                  rbm.transform(data['X']), None)
        dbm = DBM(rbms=[rbm, top], device='cpu',
                  model_path='%s/%s_dbm_rank%d/' % (tmp, job['name'], rank),
                  **job['dbm'])
        dbm.set_mesh(mesh)
        dbm.fit(data['X'])
        out.update({'dbm_' + k: v for k, v in dbm.get_params_arrays().items()
                    if k.startswith('weights/')})
    np.savez('%s/%s_out%d.npz' % (tmp, job['name'], rank), **out)


try:
    for job in spec['jobs']:
        run(job)
finally:
    dist.destroy_process_group()
'''


def run_ranks(tmp, shape, jobs):
    world = shape[0] * shape[1]
    with open(tmp + '/jobs.json', 'w') as f:
        json.dump({'shape': shape, 'jobs': jobs}, f)
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


METRICS = dict(msre=True, pll=True, l2_loss=True, feg=True,
               train_metrics_every_iter=2, feg_every_epoch=1,
               n_batches_for_feg=2)
# tests/test_parallel.py:159-179 (16 x 32, batch 16, 2 epochs), sampling off
PARITY = dict(n_visible=16, n_hidden=32, max_epoch=2, batch_size=16,
              random_seed=1337, verbose=False, sample_v_states=False,
              sample_h_states=False, sparsity_cost=1e-2,
              metrics_config=dict(msre=True, pll=True, l2_loss=True,
                                  train_metrics_every_iter=1))
# sampling on: 72 rows in batches of 16 (4 full and a remainder of 8), a
# validation set, L2 and sparsity; 33 hidden units split 17 + 16
SAMPLED = dict(n_visible=16, n_hidden=33, max_epoch=2, batch_size=16,
               learning_rate=[0.05, 0.1, 0.05], momentum=[0.5, 0.9], l2=1e-3,
               sparsity_target=0.1, sparsity_cost=1e-2,
               sample_v_states=True, sample_h_states=True,
               metrics_config=METRICS, random_seed=7, verbose=False,
               display_filters=4, display_hidden_activations=5,
               v_shape=(4, 4, 1))
SIGMA = np.linspace(0.5, 2., 16).astype(np.float32).tolist()
JOBS = {
    'parity': ('BernoulliRBM', PARITY),
    'bernoulli': ('BernoulliRBM', dict(SAMPLED, dropout=0.8)),
    'gaussian': ('GaussianRBM', dict(SAMPLED, n_hidden=32, sigma=SIGMA,
                                     dbm_first=True,
                                     learning_rate=[0.01, 0.02, 0.01])),
    'multinomial': ('MultinomialRBM', dict(SAMPLED, n_samples=3,
                                           dbm_last=True)),
    # a DBM over two tensor-parallel RBMs (12 and 6 hidden units), sampling
    # off; its own fit on the mesh's data axis
    'dbm': ('BernoulliRBM', dict(SAMPLED, n_hidden=12, dbm_first=True,
                                 sample_v_states=False,
                                 sample_h_states=False, max_epoch=1)),
}
DBM_TOP = dict(SAMPLED, n_visible=12, n_hidden=6, dbm_last=True,
               sample_v_states=False, sample_h_states=False, max_epoch=1,
               metrics_config=dict(msre=True), display_filters=0,
               display_hidden_activations=0)
DBM_CFG = dict(n_particles=16, n_gibbs_steps=1, max_mf_updates=10,
               learning_rate=0.01, momentum=0.5, max_epoch=2, batch_size=16,
               random_seed=3, verbose=False, sample_v_states=False,
               sample_h_states=[False, False])


def job_data(name, rng):
    cls, cfg = JOBS[name]
    V, H = cfg['n_visible'], cfg['n_hidden']
    if name == 'parity':
        X = np.random.RandomState(1).rand(64, V)
        return dict(X=X.astype(np.float32),
                    W_init=(rng.randn(V, H) * 0.01).astype(np.float32))
    if cls == 'GaussianRBM':
        X, X_val = rng.randn(72, V), rng.randn(20, V)
    else:
        X, X_val = rng.rand(72, V) < 0.4, rng.rand(20, V) < 0.4
    return dict(X=X.astype(np.float32), X_val=X_val.astype(np.float32),
                W_init=(rng.randn(V, H) * 0.1).astype(np.float32))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Starts the ranks of each mesh shape once for every job; returns the
    data and, by shape, the tmp dir and each job's outputs by rank."""
    rng = np.random.RandomState(0)
    data = {name: job_data(name, rng) for name in JOBS}
    data['dbm_top'] = dict(W_init=(rng.randn(12, 6) * 0.1).astype(
        np.float32))
    jobs = [dict(name=name, cls=cls, cfg=cfg) for name, (cls, cfg)
            in JOBS.items()]
    jobs[-1].update(dbm=DBM_CFG, top=DBM_TOP)
    out = {}
    for shape in SHAPES:
        tmp = str(tmp_path_factory.mktemp('tp_%d_%d' % shape))
        for name, arrays in data.items():
            np.savez('%s/%s.npz' % (tmp, name), **arrays)
        out[shape] = (tmp, run_ranks(tmp, shape, jobs))
    return data, out


def one_process(tmp, name, cls, cfg, data, X=None):
    """The port's one-process fit of a job (the generic path, CPU)."""
    rbm = CLASSES[cls](device='cpu', W_init=data['W_init'],
                       model_path='%s/%s_one/' % (tmp, name), **cfg)
    return rbm.fit(data['X'] if X is None else X, data.get('X_val'))


@pytest.fixture(scope='module')
def sampled_refs(runs):
    """{(shape, job): the one-process fit} of the sampled jobs, each
    followed by its ``transform`` and ``free_energy`` of the data (the
    calls the ranks made, which draw the host RNG in this order)."""
    data, out = runs
    refs = {}
    for shape in SHAPES:
        for name in ('bernoulli', 'gaussian', 'multinomial'):
            cls, cfg = JOBS[name]
            ref = one_process(out[shape][0], name, cls, cfg, data[name])
            refs[shape, name] = (ref, ref.transform(data[name]['X']),
                                 ref.free_energy(data[name]['X']))
    return refs


def pngs(logdir):
    """The PNG images of a summary directory's event files, in order."""
    blob = b''.join(open(os.path.join(logdir, p), 'rb').read()
                    for p in sorted(os.listdir(logdir))
                    if p.startswith('events.out'))
    out = []
    for part in blob.split(b'\x89PNG')[1:]:
        out.append(part[:part.index(b'IEND') + 8])
    return out


def assert_close(got, want, atol, keys=None):
    for key in keys or want:
        # the sparsity EMA sums the batch's hidden means: 16 x atol
        tol = atol * (16 if key.endswith('q_means') else 1)
        np.testing.assert_allclose(got[key], want[key], atol=tol, rtol=0,
                                   err_msg=key)


def state_keys(arrays):
    return [k for k in arrays if '/' in k]


@pytest.mark.parametrize('shape', SHAPES)
def test_fit_matches_jax_tensor_parallel_fit(runs, shape):
    """Sampling off: the JAX package's ``set_mesh(make_mesh(shape=(D, M)),
    model_axis='model')`` fit on D x M virtual devices against the port's
    ranks: every state array within 1e-5, the msre and l2 streams within
    1e-5 (the PLL flips come from other random streams)."""
    data, out = runs
    tmp, outs = out[shape]
    d = data['parity']
    jrbm = JaxBernoulliRBM(W_init=d['W_init'], model_path=tmp + '/jax/',
                           **PARITY)
    jrbm.set_mesh(jax_make_mesh(shape=shape, devices=jax.devices()[
        :shape[0] * shape[1]]), model_axis='model')
    assert jrbm._state['W'].sharding.spec[1] == 'model'
    jrbm.fit(d['X'])
    got, want = outs['parity'][0], jrbm.get_params_arrays()
    assert int(got['iter_']) == jrbm.iter_ == 8
    assert_close(got, want, 1e-5, state_keys(want))
    a = read_scalars(tmp + '/jax/logs/train')
    b = read_scalars(tmp + '/parity_rank0/logs/train')
    assert sorted(a) == sorted(b) and a
    for tag_step in a:
        if tag_step[0] != 'pseudo_loglikelihood':
            np.testing.assert_allclose(b[tag_step], a[tag_step], atol=1e-5,
                                       err_msg=str(tag_step))


@pytest.mark.parametrize('name', ['bernoulli', 'gaussian', 'multinomial'])
@pytest.mark.parametrize('shape', SHAPES)
def test_sampled_fit_matches_one_process(runs, sampled_refs, shape, name):
    """Sampling on: the ranks' fit against the port's one-process fit on
    the same seed, every state array within 1e-5, and every train and
    validation metric (msre, PLL, l2, FEG) within 1e-5 absolute or 1e-5
    relative (the PLL scales a difference of two ~25-sized float32 free
    energies by n_visible); ``transform`` and ``free_energy`` on the mesh
    equal one process's."""
    _, out = runs
    tmp, outs = out[shape]
    ref, H, fe = sampled_refs[shape, name]
    got = outs[name][0]
    want = ref.get_params_arrays()
    assert int(got['iter_']) == ref.iter_ == 10
    assert_close(got, want, 1e-5, state_keys(want))
    for sub in ('logs/train', 'logs/val'):
        a = read_scalars('%s/%s_one/%s' % (tmp, name, sub))
        b = read_scalars('%s/%s_rank0/%s' % (tmp, name, sub))
        assert sorted(a) == sorted(b) and a
        for tag_step in a:
            np.testing.assert_allclose(b[tag_step], a[tag_step], atol=1e-5,
                                       rtol=1e-5, err_msg=str(tag_step))
    np.testing.assert_allclose(got['H'], H, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got['fe'], fe, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize('shape', SHAPES)
def test_summaries_and_init_from_equal_one_process(runs, sampled_refs,
                                                    shape):
    """Rank 0's summaries gather the columns: its filter grids and hidden
    activation images equal the one-process fit's byte for byte, with the
    same histogram tags; ``init_from`` a tensor-parallel model takes the
    whole W."""
    _, out = runs
    tmp, outs = out[shape]
    for name in ('bernoulli', 'gaussian', 'multinomial'):
        a = pngs('%s/%s_rank0/logs/train' % (tmp, name))
        b = pngs('%s/%s_one/logs/train' % (tmp, name))
        assert len(a) == len(b) == 4, name   # 2 epochs x (filters, hidden)
        assert a == b, name
        assert np.array_equal(outs[name][0]['init_from_W'],
                              outs[name][0]['weights/W'])


@pytest.mark.parametrize('shape', SHAPES)
def test_blocks_and_replicas(runs, shape):
    """Each rank holds its ``column_blocks`` block of W and hb (17 + 16 of
    33), and the blocks joined are the gathered W; the ranks of one data
    line hold the same block bit for bit, and every rank the same gathered
    arrays."""
    _, out = runs
    _, outs = out[shape]
    D, M = shape
    for name in JOBS:
        ranks = outs[name]
        H = ranks[0]['weights/W'].shape[1]
        blocks = parallel.column_blocks(H, M)
        for r, o in enumerate(ranks):
            start, stop = blocks[r % M]
            assert o['block_W'].shape == (o['weights/W'].shape[0],
                                          stop - start)
            assert np.array_equal(o['block_W'],
                                  o['weights/W'][:, start:stop]), name
            assert np.array_equal(o['block_hb'],
                                  o['weights/hb'][start:stop]), name
            for key, v in ranks[0].items():
                if not key.startswith('block_'):
                    assert np.array_equal(o[key], v), (name, key, r)
                elif r % M == 0:
                    assert np.array_equal(o[key], v), (name, key, r)
    assert [b[1] - b[0] for b in parallel.column_blocks(33, 2)] == [17, 16]


@pytest.mark.parametrize('shape', SHAPES)
def test_checkpoint_written_once_loads_in_one_process_and_jax(runs, shape):
    """Only the mesh's rank 0 writes; its checkpoint holds the gathered
    state and loads in one port process and in the JAX package."""
    from boltzmann_machines_tpu import GaussianRBM as JaxGaussianRBM
    _, out = runs
    tmp, outs = out[shape]
    for r in range(1, shape[0] * shape[1]):
        for name in list(JOBS) + ['dbm_top', 'dbm_dbm']:
            assert not os.path.exists('%s/%s_rank%d/' % (tmp, name, r))
    assert os.path.isfile(tmp + '/dbm_dbm_rank0/params.json')
    path = tmp + '/gaussian_rank0/'
    want = {k: v for k, v in outs['gaussian'][0].items() if '/' in k}
    got = load_model(path, device='cpu').get_params_arrays()
    jgot = JaxGaussianRBM.load_model(path).get_params_arrays()
    for key, v in want.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)
        np.testing.assert_array_equal(np.asarray(jgot[key]), v, err_msg=key)


@pytest.mark.parametrize('shape', SHAPES)
def test_dbm_from_tensor_parallel_rbms(runs, shape):
    """A DBM stacked from tensor-parallel RBMs, trained on the mesh (data
    axis), equals one stacked from the one-process RBMs and trained in one
    process, within 1e-5."""
    data, out = runs
    tmp, outs = out[shape]
    cls, cfg = JOBS['dbm']
    r1 = one_process(tmp, 'dbm', cls, cfg, data['dbm'])
    r2 = one_process(tmp, 'dbm_top', 'BernoulliRBM', DBM_TOP,
                     data['dbm_top'], X=r1.transform(data['dbm']['X']))
    ref = DBM(rbms=[r1, r2], device='cpu', model_path=tmp + '/dbm_one/',
              **DBM_CFG).fit(data['dbm']['X'])
    want = ref.get_params_arrays('weights')
    got = outs['dbm'][0]
    for key, v in want.items():
        np.testing.assert_allclose(got['dbm_weights/' + key], v, atol=1e-5,
                                   rtol=0, err_msg=key)


def test_dbm_refuses_a_column_block_W(tmp_path):
    """A DBM whose state holds a column block of W (a tensor-parallel
    rank's) raises instead of training a smaller model."""
    rng = np.random.RandomState(2)
    X = (rng.rand(32, 8) < 0.5).astype(np.float32)
    kw = dict(device='cpu', max_epoch=1, batch_size=8, verbose=False,
              save_after_each_epoch=False)
    r1 = BernoulliRBM(n_visible=8, n_hidden=6, dbm_first=True,
                      model_path=str(tmp_path) + '/r1/', **kw).fit(X)
    r2 = BernoulliRBM(n_visible=6, n_hidden=4, dbm_last=True,
                      model_path=str(tmp_path) + '/r2/', **kw)
    r2.fit(r1.transform(X))
    dbm = DBM(rbms=[r1, r2], n_particles=8, model_path=str(tmp_path) +
              '/dbm/', **kw)
    dbm._ensure_state()
    W0, W1 = dbm._state.as_dict()['W']
    dbm._state.update(dict(dbm._state.as_dict(), W=(W0[:, :3], W1)))
    with pytest.raises(ValueError, match='column block'):
        dbm.fit(X)


@pytest.fixture
def one_rank(tmp_path):
    parallel.initialize('file://' + str(tmp_path) + '/store', 1, 0,
                        backend='gloo')
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_construction_on_one_rank(one_rank):
    """tests/test_parallel.py:15-22 on one rank: the default mesh puts the
    rank on 'data' and gives 'model' size 1; a shape that does not match
    the ranks raises."""
    mesh = parallel.make_mesh()
    assert mesh.shape == {'data': 1, 'model': 1}
    assert mesh.axis_names == ('data', 'model')
    assert (mesh.rank, mesh.size, mesh.model_rank, mesh.model_size,
            mesh.global_rank) == (0, 1, 0, 1, 0)
    assert parallel.make_mesh(shape=(1, 1)).shape['model'] == 1
    with pytest.raises(ValueError):
        parallel.make_mesh(shape=(3, 2))
    with pytest.raises(ValueError):
        parallel.make_mesh(shape=(1, 1, 1), axis_names=('a', 'b', 'c'))


def test_shard_helpers_on_one_rank(one_rank):
    """tests/test_parallel.py:25-35 on one rank: the batch, the columns (W
    whole on a model axis of 1) and a replicated tree; the column gather
    of a whole block is the block."""
    mesh = parallel.make_mesh()
    X = torch.arange(32.).reshape(16, 2)
    assert torch.equal(parallel.shard_batch(mesh, X), X)
    W = torch.arange(64.).reshape(4, 16)
    assert torch.equal(parallel.shard_model_columns(mesh, W), W)
    assert torch.equal(parallel.all_gather_columns(mesh, W, 16), W)
    tree = {'a': torch.ones(3)}
    assert parallel.replicate(mesh, tree) is tree
    assert parallel.column_blocks(7, 3) == [(0, 3), (3, 5), (5, 7)]
    with pytest.raises(ValueError):
        parallel.shard_model_columns(mesh, W, axis='rows')
