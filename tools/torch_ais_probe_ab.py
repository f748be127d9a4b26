"""The PyTorch port's AIS beta and free-energy probe in several checkouts of
the repo, each in a process of its own on one CUDA card, in the order
given, so that two trees are compared within one call:

    python3 tools/torch_ais_probe_ab.py PARENT . . PARENT

PARENT is an unpacked checkout of another commit (``git archive``).  Both
are driven through the public wrappers, whose signatures the trees share.
Each run prints one JSON line:

- ``ais_beta_ms``: wall per beta of ``ops.dbm_ops.ais`` at dbm_mnist's
  784-512-1024 DBM (chip_smoke.py's ``dbm_init`` state), 100 runs, k = 5,
  sampling on, 200 betas (host clock around work ending in a synchronize;
  three runs after a warm-up, as chip_smoke.py's DBM timing phase), and
  ``ais_beta_device_ms`` its device time per beta (a CUDA graph of five
  20-beta calls, chip_smoke.py's ``graph_ms``), with the launches per call;
- ``probe_us``: the device time per call of the probe's own kernels
  (``make_free_energy_probe``; torch.profiler over 20 calls, the kernels
  whose names hold ``fe_probe`` or ``cd_metrics`` only: the wrapper's
  allocations and the Gaussian sigma's copy to the card are left out, and
  a CUDA graph cannot hold that copy) at the M-RBM's 5000 x 1000, B 100,
  n 1000 and the G-RBM's 3072 x 5000, B 100, Gaussian visible units, with
  its launches per call and |fe - plain|.
"""
import json
import os
import subprocess
import sys
import time


def one(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import importlib
    import torch
    import chip_smoke as cs
    dbm_ops = importlib.import_module(
        'boltzmann_machines_tpu_torch.ops.dbm_ops')
    samplers = importlib.import_module(
        'boltzmann_machines_tpu_torch.ops.samplers')
    if not dbm_ops.__file__.startswith(root):
        raise RuntimeError('imported %s, not the checkout %s' % (
            dbm_ops.__file__, root))
    torch.backends.cuda.matmul.allow_tf32 = False
    X_all = cs.make_data(20 * cs.DBM_B, seed=5)
    state = cs.dbm_init(torch, X_all)
    g = torch.Generator(device='cuda')
    g.manual_seed(9)
    x0 = (torch.rand((100, cs.DBM_SIZES[1]), generator=g, device='cuda')
          < 0.5).float()
    out = {'root': root, 'card': torch.cuda.get_device_name(0)}

    cfg = dbm_ops.AISConfig(*cs.DBM_SIZES, 200, 5, True, True, True)
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dbm_ops.ais(cfg, state, 5, x0)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0) / cfg.n_betas)
    out['ais_beta_ms'] = walls[1:]
    short = cfg._replace(n_betas=20)
    dbm_ops.reset_launches()
    dbm_ops.ais(short, state, 5, x0)
    out['ais_launches_20_betas'] = dict(dbm_ops.ais.launches)
    out['ais_beta_device_ms'] = [
        cs.graph_ms(torch, lambda: dbm_ops.ais(short, state, 5, x0), n=5,
                    reps=3) / short.n_betas for _ in range(2)]

    f32 = dict(dtype=torch.float32, device='cuda')
    gen = torch.Generator(device='cuda')
    gen.manual_seed(18)
    from torch.profiler import ProfilerActivity, profile
    out['probe_us'], out['probe_launches'], out['probe_err'] = {}, {}, {}
    for label, (V, H), gaussian, n in (('mrbm', cs.MRBM, False, 1000),
                                       ('grbm', cs.GRBM, True, 0)):
        B = cs.CIFAR_B
        X = torch.randn((B, V), generator=gen, **f32) if gaussian else \
            torch.rand((B, V), generator=gen, **f32)
        W = 0.01 * torch.randn((V, H), generator=gen, **f32)
        vb = 0.1 * torch.randn(V, generator=gen, **f32)
        hb = 0.1 * torch.randn(H, generator=gen, **f32)
        probe = samplers.make_free_energy_probe(
            V, H, B, 'gaussian' if gaussian else 'bernoulli',
            'multinomial' if n else 'bernoulli', n or None)
        args = (X, W, vb, hb, 1.5 if gaussian else None, 9)
        samplers.reset_launches()
        fe, _ = probe(*args)
        out['probe_launches'][label] = dict(
            samplers.make_free_energy_probe.launches)
        out['probe_err'][label] = abs(float(fe) -
                                      float(probe.reference(*args)[0]))
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    probe(*args)
                torch.cuda.synchronize()
            kernels = {}
            for ev in prof.key_averages():
                if 'fe_probe' not in ev.key and 'cd_metrics' not in ev.key:
                    continue
                t = getattr(ev, 'self_device_time_total', None)
                if t is None:
                    t = getattr(ev, 'self_cuda_time_total', 0.)
                kernels[ev.key[:80]] = (t / 20., ev.count)
            runs.append({'total': sum(t for t, _ in kernels.values()),
                         'kernels': kernels})
        out['probe_us'][label] = runs
    return out


def main(argv):
    if len(argv) > 1 and argv[0] == '--one':
        print(json.dumps(one(argv[1])), flush=True)
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
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--one', root], capture_output=True, text=True)
        if r.returncode:
            sys.stderr.write(r.stderr[-4000:])
            rc = 1
        print(r.stdout.strip().splitlines()[-1] if r.stdout.strip()
              else json.dumps({'root': root, 'failed': r.returncode}),
              flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
