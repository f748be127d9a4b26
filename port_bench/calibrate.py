"""The readings that a training cell's correctness limits are set from.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 30] [--out FILE]

Each seed drives the cell as a run does, untimed: the set-up's first
steps, the warm-up, the window of `--seconds` and the late check's steps.
For each of `--seeds`, the program's steps are judged against the float64
reference; for each of `--control-seeds`, the control (the reference put
in the program's place, in TF32) and each fault a training cell can have
(a step that returns its state unchanged; half of every batch left out,
the mean taken over the rest, in float32), in the first steps from the
same inputs and in the late steps from the program's state that the
window left, judged the same way.  Prints one line a reading and, with
`--out`, writes them all as JSON.  The benchmark's own runs do not run
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

from port_bench.harness.spec import Cell  # noqa: E402
from port_bench.reference import common  # noqa: E402

#: (name, precision, fault) of the readings that a limit's upper end
#: comes from
CONTROLS = (('control_tf32', 'tf32', None),
            ('fault_unchanged', 'float32', 'unchanged'),
            ('fault_half_batch', 'float32', 'half_batch'))


def controls_of(ref):
    """CONTROLS and the faults of the reference module `ref`'s own
    (``EXTRA_FAULTS``), each read in float32."""
    return CONTROLS + tuple(('fault_' + f, 'float32', f)
                            for f in getattr(ref, 'EXTRA_FAULTS', ()))


def readings(cell, seed, device, kinds, seconds):
    """{kind: numbers} of one seed: 'program' and the CONTROLS named in
    `kinds`."""
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
            runs['program'] = (first, late)
        for name, precision, fault in controls_of(ref):
            if name in kinds:
                runs[name] = (
                    common.as_program(ref, inputs, device, precision, fault),
                    common.late_as_program(ref, inputs, pre, keys, device,
                                           precision, fault))
        out = {}
        for kind, (snaps, steps) in runs.items():
            numbers, info = common.judge(ref, inputs, snaps, device)
            late_numbers, rows = common.judge_late(ref, inputs, pre, steps,
                                                   device)
            out[kind] = dict(numbers, **late_numbers, **info,
                             late_sweeps=[r[:2] for r in rows])
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
    seeds = [int(s) for s in args.seeds.split(',') if s]
    controls = [int(s) for s in args.control_seeds.split(',') if s]
    rows = []
    for seed in sorted(set(seeds) | set(controls)):
        ref = importlib.import_module('port_bench.reference.' +
                                      cell.config['family'])
        kinds = (['program'] if seed in seeds else []) + \
            ([c[0] for c in controls_of(ref)] if seed in controls else [])
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
        sys.exit('calibrate.py reads the card: no CUDA device')
    main()
