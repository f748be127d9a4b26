"""Headless smoke for the port's analysis notebooks
(notebooks/torch_rbm_mnist_analysis.ipynb and
notebooks/torch_dbm_mnist_analysis.ipynb), modelled on
tests/test_notebooks.py.

Both run end to end through nbclient with ``BMT_NB_DEVICE=cpu`` on tiny
models that the JAX package trains on synthetic data (a checkpoint of
either package loads in the other), their ``BMT_NB_*`` knobs shrunk to
smoke scale.  The RBM notebook's free energies are deterministic, so its
printed ``FE(data)`` and ``FE(noise)`` are held against the JAX notebook's
on the same checkpoint.
"""

import os
import re

import numpy as np
import pytest

nbclient = pytest.importorskip('nbclient')
nbformat = pytest.importorskip('nbformat')

from boltzmann_machines_tpu import DBM, BernoulliRBM  # noqa: E402
from boltzmann_machines_tpu.utils.dataset import make_synthetic_mnist  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _execute(name, env):
    path = os.path.join(REPO, 'notebooks', name)
    nb = nbformat.read(path, as_version=4)
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        client = nbclient.NotebookClient(
            nb, timeout=600, kernel_name='python3',
            resources={'metadata': {'path': os.path.join(REPO,
                                                         'notebooks')}})
        client.execute()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return nb


def _printed(nb, label):
    """The number printed after '`label` =' in the notebook's outputs."""
    text = ''.join(out.get('text', '') for cell in nb.cells
                   if cell.cell_type == 'code' for out in cell.outputs)
    m = re.search(re.escape(label) + r' = (\S+)', text)
    assert m, (label, text[-2000:])
    return float(m.group(1))


@pytest.fixture(scope='module')
def tiny_models(tmp_path_factory):
    """tests/test_notebooks.py's tiny RBM and DBM, trained by the JAX
    package."""
    root = str(tmp_path_factory.mktemp('torch_nb_models'))
    X, _ = make_synthetic_mnist(1024)
    X = (X / 255.).astype(np.float32)
    kw = dict(max_epoch=2, batch_size=64, verbose=False,
              save_after_each_epoch=False)

    rbm_dir = os.path.join(root, 'rbm_mnist') + '/'
    BernoulliRBM(n_visible=784, n_hidden=64, random_seed=1337,
                 model_path=rbm_dir, **kw).fit(X)

    r1 = BernoulliRBM(n_visible=784, n_hidden=64, dbm_first=True,
                      random_seed=1, model_path=os.path.join(root, 'r1') +
                      '/', **kw).fit(X)
    Q = r1.transform(X)
    r2 = BernoulliRBM(n_visible=64, n_hidden=32, dbm_last=True,
                      random_seed=2, model_path=os.path.join(root, 'r2') +
                      '/', **kw).fit(Q)
    G = r2.transform(Q)
    dbm_dir = os.path.join(root, 'dbm_mnist') + '/'
    DBM(rbms=[r1, r2], n_particles=32, v_particle_init=X[:32],
        h_particles_init=(Q[:32], G[:32]), n_gibbs_steps=1,
        max_mf_updates=10, mf_tol=1e-7, learning_rate=1e-3, momentum=0.5,
        max_norm=6., random_seed=3, model_path=dbm_dir, **kw).fit(X)
    return rbm_dir, dbm_dir


@pytest.mark.parametrize('name', ['torch_rbm_mnist_analysis.ipynb',
                                  'torch_dbm_mnist_analysis.ipynb'])
def test_notebook_imports_no_jax(name):
    """The port's notebooks import the port, never JAX or the JAX
    package."""
    nb = nbformat.read(os.path.join(REPO, 'notebooks', name), as_version=4)
    code = '\n'.join(c.source for c in nb.cells if c.cell_type == 'code')
    assert 'boltzmann_machines_tpu_torch' in code
    assert not re.search(r'\bjax\b|boltzmann_machines_tpu\b(?!_torch)',
                         code)


def test_rbm_notebook_matches_jax_notebook(tiny_models):
    """The port's RBM notebook runs on the CPU; its printed FE(data) and
    FE(noise) agree with the JAX notebook's on the same checkpoint within
    1e-4 relative."""
    rbm_dir, _ = tiny_models
    env = {'BMT_NB_RBM_DIR': rbm_dir, 'BMT_NB_N': '512',
           'MPLBACKEND': 'Agg'}
    nb = _execute('torch_rbm_mnist_analysis.ipynb',
                  dict(env, BMT_NB_DEVICE='cpu'))
    ref = _execute('rbm_mnist_analysis.ipynb', dict(
        env, JAX_PLATFORMS=os.environ.get('JAX_PLATFORMS', 'cpu')))
    for label in ('FE(data)', 'FE(noise)'):
        got, want = _printed(nb, label), _printed(ref, label)
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=label)


def test_dbm_notebook_executes(tiny_models):
    """The port's DBM notebook runs on the CPU: sample_v, log_Z (linear,
    adaptive, adaptive with the hidden-bias base rate), log_proba,
    get_params_arrays and reconstruct, with finite results printed."""
    _, dbm_dir = tiny_models
    nb = _execute('torch_dbm_mnist_analysis.ipynb', {
        'BMT_NB_DBM_DIR': dbm_dir, 'BMT_NB_GIBBS': '50',
        'BMT_NB_BETAS': '50,100', 'BMT_NB_RUNS': '16',
        'MPLBACKEND': 'Agg', 'BMT_NB_DEVICE': 'cpu'})
    text = ''.join(out.get('text', '') for cell in nb.cells
                   if cell.cell_type == 'code' for out in cell.outputs)
    log_Z = [float(v) for v in re.findall(r'log Z = +(\S+)', text)]
    assert len(log_Z) == 4 and np.all(np.isfinite(log_Z)), text[-2000:]
    assert np.isfinite(float(re.search(r'mean test ELBO: (\S+)',
                                       text).group(1)))
