"""The ``gbm_dbm`` family: the port's two-layer Gaussian-Bernoulli-
Multinomial ``DBM`` trained by PCD with mean-field through ``fit``, as
``examples/torch_dbm_cifar_naive.py`` builds its DBM stage: stacked from a
``dbm_first`` ``GaussianRBM`` (Gaussian visible units of a fixed sigma)
and a ``dbm_last`` ``MultinomialRBM`` (a multinomial top layer of
``n_samples`` tied softmax units), the particles started from the first
rows and their mean activations through each RBM, on rows of the
``cifar_like`` kind (``models/gaussian_rbm.py``, whose import registers
it)."""

import os

import torch

from ..harness.data import gaussian, sub_seed
from ..reference import common
from ..work import dbm_step_work
from ..work.softmax import dbm_softmax_work
from . import dbm
from . import gaussian_rbm  # noqa: F401  (registers cifar_like)

#: the port's launch counter of each kernel of the DBM epoch, and the
#: kernel's name in a trace (csrc/dbm_ops.cu)
KERNEL_OF_COUNTER = dict(dbm.KERNEL_OF_COUNTER,
                         dbm_mf_check='dbm_mf_check_kernel',
                         dbm_softmax='dbm_softmax_kernel')


class Session(dbm.Session):
    def build(self, weight_seed):
        from boltzmann_machines_tpu_torch import (DBM, GaussianRBM,
                                                  MultinomialRBM)
        c, dev = self.config, self.device
        V, (H1, H2) = c['n_visible'], c['n_hiddens']
        M, n, sigma = c['n_particles'], c['n_samples'], c['sigma']
        (std1, std2), vb, hb = c['rbm_W_init'], c['rbm_vb_init'], \
            c['rbm_hb_init']
        # the two RBMs at their published initialisation, drawn from the
        # seed on the device
        W1 = gaussian((V, H1), std1, sub_seed(weight_seed, 1), dev)
        W2 = gaussian((H1, H2), std2, sub_seed(weight_seed, 2), dev)
        full = lambda k, x: torch.full((k,), float(x), dtype=torch.float32,
                                       device=dev)
        vb1, hb1, vb2, hb2 = full(V, vb), full(H1, hb), full(H1, vb), \
            full(H2, hb)
        # the particles start from the first rows and, as the example
        # starts them from each RBM's transform, their mean activations:
        # the G-RBM's sigmoid(2 (v / sigma W1 + hb1)) (dbm_first), the
        # M-RBM's expected counts n softmax(h1 W2 + hb2)
        v0 = torch.as_tensor(self.X[:M], device=dev)
        h0 = torch.sigmoid(2. * (v0 / float(sigma) @ W1 + hb1))
        h1 = float(n) * torch.softmax(h0 @ W2 + hb2, dim=1)
        host = lambda t: t.cpu().numpy()
        self.rbm_arrays = ({'W': host(W1), 'vb': host(vb1), 'hb': host(hb1)},
                           {'W': host(W2), 'vb': host(vb2), 'hb': host(hb2)})
        self.particles = (host(v0), host(h0), host(h1))
        kw = dict(verbose=False, dtype='float32', device=dev)
        rbms = [GaussianRBM(n_visible=V, n_hidden=H1, sigma=sigma,
                            W_init=self.rbm_arrays[0]['W'], vb_init=vb,
                            hb_init=hb, dbm_first=True,
                            random_seed=sub_seed(self.model_seed, 10),
                            model_path=os.path.join(self.workdir,
                                                    'rbm0') + '/', **kw),
                MultinomialRBM(n_visible=H1, n_hidden=H2, n_samples=n,
                               W_init=self.rbm_arrays[1]['W'], vb_init=vb,
                               hb_init=hb, dbm_last=True,
                               random_seed=sub_seed(self.model_seed, 11),
                               model_path=os.path.join(self.workdir,
                                                       'rbm1') + '/',
                               **kw)]
        self.period = int(c['val_metrics_every_epoch'])
        self.metrics_every = c['train_metrics_every_iter']
        self.model = DBM(
            rbms=rbms, n_particles=M, v_particle_init=self.particles[0],
            h_particles_init=self.particles[1:],
            n_gibbs_steps=c['n_gibbs_steps'],
            max_mf_updates=c['max_mf_updates'], mf_tol=c['mf_tol'],
            learning_rate=self.schedule('learning_rate'),
            momentum=self.schedule('momentum'), max_epoch=0,
            batch_size=self.B, l2=c['l2'], max_norm=c['max_norm'],
            sample_v_states=c['sample_v_states'],
            sample_h_states=tuple(c['sample_h_states']),
            sparsity_target=c['sparsity_target'],
            sparsity_cost=c['sparsity_cost'],
            sparsity_damping=c['sparsity_damping'],
            train_metrics_every_iter=c['train_metrics_every_iter'],
            val_metrics_every_epoch=c['val_metrics_every_epoch'],
            random_seed=self.model_seed, verbose=False,
            save_after_each_epoch=False, display_filters=0,
            display_particles=0, dtype='float32', device=dev,
            model_path=os.path.join(self.workdir, 'dbm') + '/')

    def traced(self, fn, capture):
        """As ``dbm.Session.traced``, with the slice's mean-field sweeps a
        step as the port counted them (``dbm_epoch.sweeps['mf_sweeps']``,
        which ``fit`` adds from every step's n_mf row) where it counts
        them: the slice's exact mean (``n_mf_run``), beside the mean of
        the steps ``fit`` logged (``n_mf``)."""
        sweeps = _sweep_counts()
        before = None if sweeps is None else sweeps.get('mf_sweeps')
        record, trace = dbm.Session.traced(self, fn, capture)
        if before is not None and record['steps']:
            record['n_mf_run'] = (sweeps['mf_sweeps'] - before) / \
                record['steps']
        return record, trace

    def traced_context(self, window):
        done, launches, work, lines = dbm.Session.traced_context(self,
                                                                 window)
        lines.append('mean-field sweeps a step in the traced slices, as the '
                     'port counted them: {0}'.format(
                         [r.get('n_mf_run') for r, _ in window['pieces']]))
        return done, launches, work, lines

    def inputs(self):
        """``dbm.Session.inputs``, the configuration carrying the program's
        h1 states and top-layer counts after each step that ends a ``fit``
        call (``program_h0``, ``program_h1``, by global iteration: the
        set-up's steps 1 and 3, the late steps), from which the judging
        reference takes the sides of its multinomial ties
        (``reference/gbm_dbm.py``)."""
        out = dbm.Session.inputs(self)
        ends = [(it0 + n - 1, state) for (_, it0, n), state in
                zip(common.FITS, self.first)]
        ends += [(key['it'], state) for state, key in self.late]
        out['config'] = dict(self.config, **{
            'program_' + k.lower(): {it: state[k] for it, state in ends}
            for k in ('H0', 'H1')})
        return out

    def judge(self, reference, device):
        """``dbm.Session.judge``, with a line for each judged step that
        took multinomial draws from the program's counts
        (``reference.taken``)."""
        reference.taken.clear()
        with reference.recording():
            numbers, lines = dbm.Session.judge(self, reference, device)
        for it, (moved, missed, worst) in sorted(reference.taken.items()):
            lines.append(
                'reference, step {0}: {1} multinomial draws taken from the '
                'program\'s counts, {2} asked for outside their band; the '
                'farthest at {3:.3g} of what float32 rounding moves its '
                'edge (band {4:g})'.format(it, moved, missed, worst,
                                           reference.SHOWN_FACTOR))
        return numbers, lines

    def work_of_step(self, rows, window):
        """At the slice's mean-field sweeps a step as the port counted
        them, else at those ``fit`` logged, else all
        ``max_mf_updates``: the products and associations of
        ``dbm_step_work`` and the multinomial layer's rows
        (``softmax``)."""
        c = self.config
        V, (H1, H2) = c['n_visible'], c['n_hiddens']
        n_mf = window.get('n_mf_run')
        if n_mf is None:
            n_mf = window.get('n_mf')
        if n_mf is None:
            n_mf = c['max_mf_updates']
        M, k = c['n_particles'], c['n_gibbs_steps']
        work = dbm_step_work(V, H1, H2, rows, M, n_mf, k)
        work['softmax'] = dbm_softmax_work(H2, rows, M, n_mf, k)
        return work


def _sweep_counts():
    """The port's count of the training steps' mean-field sweeps, or None
    where it keeps none."""
    import sys
    ops = sys.modules.get('boltzmann_machines_tpu_torch.ops.dbm_ops')
    return getattr(getattr(ops, 'dbm_epoch', None), 'sweeps', None)
