"""The PyTorch port's DBM step at mean-field loops of several lengths, and
chip_smoke.py's DBM fit, in several checkouts of the repo, each in a
process of its own on one CUDA card, in the order given, so that two trees
are compared within one call:

    python3 tools/torch_mf_graph_ab.py [--body 1,2,4] PARENT . . PARENT

PARENT is an unpacked checkout of another commit (``git archive``).  Both
are driven through ``ops.dbm_ops.dbm_epoch`` and ``chip_smoke.py``'s
``dbm_init``, ``dbm_config`` and ``train_dbm_mnist``, which the trees
share.  Each run prints one JSON line:

- ``steps``: per mf_tol, from chip_smoke.py's random 784-512-1024 state
  (B = M = 100, sampling on, a budget of 50 sweeps): the mean n_mf a step
  and the wall per step of a 40-step epoch (host clock to a synchronize,
  five runs after a warm-up), ``ms`` their median and ``min_ms`` the least;
  where the checkout has a mean-field graph (``MF_BODY_SWEEPS``), once for
  each sweeps-a-turn of ``--body`` (its own value where none is given);
- ``fit``: chip_smoke.py's DBM path (two RBMs pretrained 2 epochs, then
  ``DBM.fit``, 2 epochs of 100 steps at mf_tol 1e-7): the fit's wall
  (``t_fit``, to a synchronize) and the logged n_mf.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

TOLS = (1e-4, 1e-5, 1e-6, 1e-7)


def step_walls(torch, cs, dbm_ops, nb=40, runs=5):
    X_all = cs.make_data(nb * cs.DBM_B, seed=5)
    X = torch.as_tensor(X_all.reshape(nb, cs.DBM_B, cs.DBM_SIZES[0]),
                        device='cuda')
    state = cs.dbm_init(torch, X_all)
    out = {}
    for tol in TOLS:
        cfg = cs.dbm_config(True, mf_tol=tol)

        def epoch():
            return dbm_ops.dbm_epoch(cfg, state, X, cs.DBM_LR, cs.DBM_MOM,
                                     5, 0)
        n_mf = float(epoch()[2].mean())
        walls = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0) / nb)
        walls.sort()
        out['%g' % tol] = {'n_mf': n_mf, 'ms': walls[runs // 2],
                           'min_ms': walls[0]}
    return out


def one(root, bodies):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import importlib
    import torch
    import chip_smoke as cs
    dbm_ops = importlib.import_module(
        'boltzmann_machines_tpu_torch.ops.dbm_ops')
    if not dbm_ops.__file__.startswith(root):
        raise RuntimeError('imported %s, not the checkout %s' % (
            dbm_ops.__file__, root))
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.say = lambda *a: None
    out = {'root': root, 'card': torch.cuda.get_device_name(0)}
    own = getattr(dbm_ops, 'MF_BODY_SWEEPS', None)
    if own is None:
        out['steps'] = step_walls(torch, cs, dbm_ops)
    else:
        out['body'] = own
        out['steps'] = {}
        for body in bodies or [own]:
            dbm_ops.MF_BODY_SWEEPS = body
            out['steps'][body] = step_walls(torch, cs, dbm_ops)
        dbm_ops.MF_BODY_SWEEPS = own
    X = cs.make_data(11000, seed=42)
    with tempfile.TemporaryDirectory() as tmp:
        run = cs.train_dbm_mnist(torch, tmp, X[:10000], X[-1000:])
    n_mf = [v for _, v in run['n_mf']]
    out['fit'] = {'t_fit': run['t_fit'], 't_pre': run['t_pre'],
                  'n_mf_mean': sum(n_mf) / len(n_mf), 'n_mf': n_mf}
    return out


def main(argv):
    bodies = []
    if argv[:1] == ['--body']:
        bodies, argv = [int(b) for b in argv[1].split(',')], argv[2:]
    if len(argv) > 1 and argv[0] == '--one':
        print(json.dumps(one(argv[1], bodies)), flush=True)
        return 0
    if not argv:
        sys.stderr.write(__doc__)
        return 2
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    rc = 0
    for root in argv:
        cmd = [sys.executable, os.path.abspath(__file__)]
        if bodies:
            cmd += ['--body', ','.join(map(str, bodies))]
        r = subprocess.run(cmd + ['--one', root], capture_output=True,
                           text=True)
        if r.returncode:
            sys.stderr.write(r.stderr[-4000:])
            rc = 1
        print(r.stdout.strip().splitlines()[-1] if r.stdout.strip()
              else json.dumps({'root': root, 'failed': r.returncode}),
              flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
