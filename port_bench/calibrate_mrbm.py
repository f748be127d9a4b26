"""``port_bench/calibrate.py`` for the ``multinomial_rbm`` family.

    python3 port_bench/calibrate_mrbm.py --workload <cell> \
        --seeds 1,2,3 [--control-seeds 4,5,6] [--seconds 30] [--out FILE]

The family's judge takes the multinomial draws that lie near a bucket's
edge to the side that the judged run's counts show (``reference/
multinomial_rbm.py``).  ``calibrate.py`` judges every reading with the
program's counts; here each reading is judged with the counts of its own
run, as a benchmark run judges a program that is that run.  Its readings
are ``calibrate.py``'s, the family's faults planted through the
configuration the reference steps by: ``fault_short_chain`` (k 1 in place
of the configured k) and ``fault_draw_shift`` (every uniform of the
softmax rows' draws moved up by ``DRAW_SHIFT``).  Each reading carries
``taken``: by judged step and stream, the draws taken from its counts,
those asked for outside their band, and the farthest asked for over what
float32 rounding moves its edge.  The benchmark's own runs do not run
this.
"""

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from port_bench import calibrate  # noqa: E402
from port_bench.harness.spec import Cell  # noqa: E402
from port_bench.reference import common  # noqa: E402
from port_bench.reference import gbm_dbm  # noqa: E402


def planted(inputs, fault):
    """(inputs, the fault left for ``common``) with `fault` planted in the
    configuration where the reference reads it there."""
    if fault in ('short_chain', 'draw_shift'):
        return dict(inputs, config=dict(inputs['config'],
                                        **{fault: True})), None
    return inputs, fault


def own_counts(inputs, drawn):
    """`inputs` with the counts the judge takes the multinomial draws'
    sides from replaced by a run's own (`drawn`, by iteration and
    stream)."""
    return dict(inputs, config=dict(
        inputs['config'], program_counts={it: dict(c) for it, c in
                                          drawn.items()}))


def readings(cell, seed, device, kinds, seconds):
    """As ``calibrate.readings``, each reading judged with its own counts
    and with its ``taken``."""
    family = importlib.import_module('port_bench.models.' +
                                     cell.config['family'])
    ref = importlib.import_module('port_bench.reference.' +
                                  cell.config['family'])
    workdir = tempfile.mkdtemp(prefix='port_bench_')
    try:
        session = family.Session(cell.config, cell.traffic, seed, device,
                                 workdir)
        session.prepare()
        session.window(session.units(seconds, cell.workload))
        session.after_window()
        first = [session.to_tensors(s, device) for s in session.first]
        inputs, pre, late = session.inputs_, session.pre, session.late
        session.free()
        keys = [key for _, key in late]
        runs = {}
        if 'program' in kinds:
            runs['program'] = (first, late, inputs)
        for name, precision, fault in calibrate.controls_of(ref):
            if name not in kinds:
                continue
            plant, left = planted(inputs, fault)
            ref.drawn.clear()
            snaps = common.as_program(ref, plant, device, precision, left)
            steps = common.late_as_program(ref, plant, pre, keys, device,
                                           precision, left)
            runs[name] = (snaps, steps, own_counts(inputs, ref.drawn))
        out = {}
        for kind, (snaps, steps, judged) in runs.items():
            ref.taken.clear()
            with gbm_dbm.recording():
                numbers, info = common.judge(ref, judged, snaps, device)
                late_numbers, rows = common.judge_late(ref, judged, pre,
                                                       steps, device)
            out[kind] = dict(numbers, **late_numbers, **info,
                             taken={'%d/%d' % key: list(t) for key, t in
                                    sorted(ref.taken.items())})
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None, device='cuda', **cell_kw):
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--control-seeds', default='')
    p.add_argument('--seconds', type=float, default=30.)
    p.add_argument('--out')
    args = p.parse_args(argv)
    cell = Cell(args.workload, **cell_kw)
    ref = importlib.import_module('port_bench.reference.' +
                                  cell.config['family'])
    seeds = [int(s) for s in args.seeds.split(',') if s]
    controls = [int(s) for s in args.control_seeds.split(',') if s]
    rows = []
    for seed in sorted(set(seeds) | set(controls)):
        kinds = (['program'] if seed in seeds else []) + \
            ([c[0] for c in calibrate.controls_of(ref)]
             if seed in controls else [])
        for kind, numbers in readings(cell, seed, device, kinds,
                                      args.seconds).items():
            rows.append(dict(numbers, workload=args.workload, seed=seed,
                             kind=kind))
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == '__main__':
    if not torch.cuda.is_available():
        sys.exit('calibrate_mrbm.py reads the card: no CUDA device')
    main()
