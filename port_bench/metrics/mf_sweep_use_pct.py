"""The share of the mean-field sweeps that the traced slices' training steps
enqueued and that did a sweep: 100 x ``mf_sweeps`` / ``mf_sweeps_enqueued``
of ``ops/dbm_ops.dbm_epoch.profiled_sweeps``, the port's counts over the
training epochs run while a profiler session was active (the kernels
enqueue ``max_mf_updates`` sweeps a step, those after convergence return
at once).  In a run the traced slices are the only such epochs; the
counts cover every step of them, not the one in
``train_metrics_every_iter`` that ``fit`` logs.  None where the port keeps
no such counts, or where their steps are not the slices' steps."""

import sys

KERNELS = ()


def read(ctx):
    ops = sys.modules.get('boltzmann_machines_tpu_torch.ops.dbm_ops')
    counts = getattr(getattr(ops, 'dbm_epoch', None), 'profiled_sweeps',
                     None)
    if not counts or not counts.get('mf_sweeps_enqueued') or \
            counts.get('steps') != ctx.window['steps']:
        return None
    return 100. * counts['mf_sweeps'] / counts['mf_sweeps_enqueued']
