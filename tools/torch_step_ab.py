"""The PyTorch port's CD step at 784x1024, B = 10 (examples/rbm_mnist.py's
shape, hidden states sampled, chip_smoke.py's timing phase) in several
checkouts of the repo, each in a process of its own on one CUDA card, in
the order given, so that two trees are compared within one call:

    python3 tools/torch_step_ab.py PARENT . . PARENT

PARENT is an unpacked checkout of another commit (``git archive``).  Each
run prints one JSON line:

- ``step_us``: wall per step of a 1024-step epoch (host clock around work
  ending in a synchronize), five runs after a warm-up, and ``step_us_100``
  the same for a 100-step call (three runs);
- ``device_us``: the kernels' device time per step (torch.profiler) and
  ``busy`` its share of the best 1024-step wall;
- ``host_us``: the host's time per call of ``bm_cd_assoc_update`` and of
  ``bm_cd_bias_stats`` (unchanged kernel, the control) at the step's
  shapes, a loop of 300 launches with the clock stopped before the
  synchronize (fewer launches than the queue holds, so the host never waits
  for the card);
- ``stats``: per data-parallel stats call at chip_smoke.py's two local
  shapes (3072x7800 / 50 rows, 784x1024 / 128 rows), chip_smoke.py's
  ``stats_timings`` in that checkout: ms per call with sampling on and
  off, the kernels' device us per call and their busy share.
"""
import json
import os
import subprocess
import sys
import time

N_HOST = 300


def one(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import importlib
    import torch
    import chip_smoke as cs
    ce = importlib.import_module('boltzmann_machines_tpu_torch.ops.cd_epoch')
    if not ce.__file__.startswith(root):
        raise RuntimeError('imported %s, not the checkout %s' % (ce.__file__,
                                                                 root))
    lib = ce.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    X_all = cs.make_data(10240, seed=3)
    B, V, H = 10, cs.V, cs.H
    nb = len(X_all) // B
    X = torch.as_tensor(X_all[:nb * B].reshape(nb, B, V), device='cuda')
    state = cs.init_state(torch, X_all)
    cfg = cs.config(False, True, 1000)

    def epoch(Xs):
        ce.cd_epoch(cfg, state, Xs, cs.LR, cs.MOMENTUM, 5, 0)

    def walls(Xs, runs):
        out = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch(Xs)
            torch.cuda.synchronize()
            out.append(1e6 * (time.perf_counter() - t0) / len(Xs))
        return out

    epoch(X)
    step_us = walls(X, 5)
    step_us_100 = walls(X[:100], 3)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        epoch(X)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        if 'kernel' not in ev.key or ev.key.startswith('cuda'):
            continue
        t = getattr(ev, 'self_device_time_total', None)
        if t is None:
            t = getattr(ev, 'self_cuda_time_total', 0.)
        if t:
            kernels[ev.key[:60]] = (t / nb, ev.count)
    device_us = sum(t for t, _ in kernels.values())

    f32 = dict(dtype=torch.float32, device='cuda')
    Xb, v = torch.rand((B, V), **f32), torch.rand((B, V), **f32)
    h0, h = torch.rand((B, H), **f32), torch.rand((B, H), **f32)
    W, dW = 0.01 * torch.randn((V, H), **f32), torch.zeros((V, H), **f32)
    vb, dvb, msre_col = (torch.zeros(V, **f32) for _ in range(3))
    hb, dhb, q, pen = (torch.zeros(H, **f32) for _ in range(4))
    p = ce.ptr
    stream = torch.cuda.current_stream().cuda_stream
    assoc = [p(Xb), p(h0), p(v), p(h), p(pen), B, V, H, p(W), p(dW), 1e-4,
             0.9, 1e-4, stream]
    if len(ce._ARGTYPES['bm_cd_assoc_update']) == len(assoc) + 1:
        # the association's width from ops/gemm.py's plan, before the stream
        # (a checkout from before then chose it in C)
        gemm = importlib.import_module('boltzmann_machines_tpu_torch.ops.gemm')
        assoc.insert(-1, gemm.assoc_plan(V, H, gemm.num_sms(W.device)).n_tile)
    calls = {
        'cd_assoc_update': lambda: lib.bm_cd_assoc_update(*assoc),
        'cd_bias_stats': lambda: lib.bm_cd_bias_stats(
            p(Xb), p(v), p(v), p(h0), p(h), B, V, H, p(vb), p(dvb), p(hb),
            p(dhb), p(q), p(pen), p(msre_col), 1e-4, 0.9, 0.9, 0.1, 0., 0.1,
            stream)}
    host_us = {}
    for name, call in calls.items():
        best = None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(N_HOST):
                ce.check_launch(call(), name)
            t = 1e6 * (time.perf_counter() - t0) / N_HOST
            torch.cuda.synchronize()
            best = t if best is None else min(best, t)
        host_us[name] = best
    stats = {label: {k: r[k] for k in ('ms', 'ms_sampling_off', 'kernel_us',
                                       'busy')}
             for label, r in cs.stats_timings(torch).items()}
    return dict(root=root, step_us=step_us, step_us_100=step_us_100,
                device_us=device_us, busy=device_us / min(step_us),
                kernels_us_per_step=kernels, host_us=host_us, stats=stats,
                card=torch.cuda.get_device_name(0))


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
