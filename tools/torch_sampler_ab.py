"""The PyTorch port's standalone samplers in several checkouts of the repo,
each in a process of its own on one CUDA card, in the order given, so that
two trees are compared within one call:

    python3 tools/torch_sampler_ab.py PARENT . . PARENT

PARENT is an unpacked checkout of another commit (``git archive``).  Each
process runs its own checkout's ``chip_smoke.py`` sampler phases,
``samplers_vs_plain`` and ``bernoulli_vs_plain`` (each sampler against its
plain version, then timed), and prints one JSON line of their timings:

- ``bernoulli_sample`` at (100, 7800) and ``normal_sample`` at (100, 3072):
  ``ms`` per call by CUDA events over 50 calls, wrapper included;
  ``library_ms`` the torch call's (``torch.bernoulli``, ``torch.randn``) in
  the same process; ``device_ms`` and ``library_device_ms`` their device
  times alone (a CUDA graph of calls); ``plain_ms`` the plain version's;
  ``small_ms`` ``bernoulli_sample`` per call at (10, 1024).
"""
import json
import os
import subprocess
import sys

KEYS = ('ms', 'library_ms', 'device_ms', 'library_device_ms', 'plain_ms',
        'small_ms', 'launches')


def one(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import importlib
    import torch
    import chip_smoke as cs
    samplers = importlib.import_module(
        'boltzmann_machines_tpu_torch.ops.samplers')
    if not samplers.__file__.startswith(root) \
            or not cs.__file__.startswith(root):
        raise RuntimeError('imported %s, not the checkout %s' % (
            samplers.__file__, root))
    torch.backends.cuda.matmul.allow_tf32 = False
    normal = cs.samplers_vs_plain(torch)['normal_sample']
    bern = cs.bernoulli_vs_plain(torch)
    return {'root': root, 'card': torch.cuda.get_device_name(0),
            'normal_sample': {k: normal[k] for k in KEYS if k in normal},
            'bernoulli_sample': {k: bern[k] for k in KEYS if k in bern}}


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
