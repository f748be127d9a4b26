"""The ``dbm`` family: the port's two-layer ``DBM`` trained by PCD with
mean-field through ``fit``, as ``examples/torch_dbm_mnist.py`` builds it:
stacked from a ``dbm_first`` and a ``dbm_last`` ``BernoulliRBM``, the
particles started from the first rows and their hidden activations."""

import json
import os

import numpy as np
import torch

from ..harness.data import gaussian, sub_seed
from ..work import dbm_step_work
from .training import FitSession

KERNEL_OF_COUNTER = {'dbm_gemm_act': 'dbm_gemm_act_kernel',
                     'dbm_bias_update': 'dbm_bias_update_kernel',
                     'dbm_assoc_update': 'assoc_kernel',
                     'dbm_max_norm': 'dbm_max_norm_kernel',
                     'dbm_msre': 'dbm_msre_kernel'}


class Session(FitSession):
    STATE = {'W0': 'weights/W_0', 'W1': 'weights/W_1', 'vb': 'weights/vb',
             'hb0': 'weights/hb_0', 'hb1': 'weights/hb_1',
             'dW0': 'grads_accumulators/dW_0',
             'dW1': 'grads_accumulators/dW_1',
             'dvb': 'grads_accumulators/dvb',
             'dhb0': 'grads_accumulators/dhb_0',
             'dhb1': 'grads_accumulators/dhb_1',
             'q0': 'hidden_means_accumulators/q_means_0',
             'q1': 'hidden_means_accumulators/q_means_1',
             'm0': 'hidden_means_accumulators/mu_means_0',
             'm1': 'hidden_means_accumulators/mu_means_1',
             'v': 'negative_particles/v', 'H0': 'negative_particles/H_0',
             'H1': 'negative_particles/H_1'}

    def build(self, weight_seed):
        from boltzmann_machines_tpu_torch import DBM, BernoulliRBM
        c, dev = self.config, self.device
        V, (H1, H2) = c['n_visible'], c['n_hiddens']
        M = c['n_particles']
        (std1, std2), vb, hb = c['rbm_W_init'], c['rbm_vb_init'], \
            c['rbm_hb_init']
        # the two RBMs at their published initialisation, drawn from the
        # seed on the device
        W1 = gaussian((V, H1), std1, sub_seed(weight_seed, 1), dev)
        W2 = gaussian((H1, H2), std2, sub_seed(weight_seed, 2), dev)
        full = lambda n, x: torch.full((n,), float(x), dtype=torch.float32,
                                       device=dev)
        vb1, hb1, vb2, hb2 = full(V, vb), full(H1, hb), full(H1, vb), \
            full(H2, hb)
        # the particles start from the first rows and, as the example
        # starts them from each RBM's transform, their mean activations
        v0 = torch.as_tensor(self.X[:M], device=dev)
        h0 = torch.sigmoid(2. * (v0 @ W1 + hb1))
        h1 = torch.sigmoid(h0 @ W2 + hb2)
        host = lambda t: t.cpu().numpy()
        self.rbm_arrays = ({'W': host(W1), 'vb': host(vb1), 'hb': host(hb1)},
                           {'W': host(W2), 'vb': host(vb2), 'hb': host(hb2)})
        self.particles = (host(v0), host(h0), host(h1))
        rbms = [BernoulliRBM(n_visible=n_in, n_hidden=n_out, W_init=a['W'],
                             vb_init=a['vb'], hb_init=a['hb'], verbose=False,
                             dbm_first=i == 0, dbm_last=i == 1,
                             random_seed=sub_seed(self.model_seed, 10 + i),
                             dtype='float32', device=dev,
                             model_path=os.path.join(self.workdir,
                                                     'rbm%d' % i) + '/')
                for i, (n_in, n_out, a) in enumerate(
                    ((V, H1, self.rbm_arrays[0]),
                     (H1, H2, self.rbm_arrays[1])))]
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

    def counters(self):
        from boltzmann_machines_tpu_torch.ops.dbm_ops import dbm_epoch
        return dict(dbm_epoch.launches)

    def logged_n_mf(self, iter0, iter1):
        """The mean-field sweeps that ``fit`` logged (``n_mf_updates``)
        after step `iter0` up to step `iter1`, in order."""
        path = os.path.join(self.workdir, 'dbm', 'logs', 'train',
                            'scalars.jsonl')
        values = []
        if os.path.isfile(path):
            with open(path) as f:
                for line in f:
                    r = json.loads(line)
                    if r['tag'] == 'n_mf_updates' and \
                            iter0 < r['step'] <= iter1:
                        values.append(r['value'])
        return values

    def n_mf(self, record):
        """The mean of the mean-field sweeps that ``fit`` logged (every
        ``train_metrics_every_iter`` steps) in a ``run_epochs`` record, or
        None."""
        values = self.logged_n_mf(record['iter0'], record['iter1'])
        return float(np.mean(values)) if values else None

    def traced(self, fn, capture):
        record, trace = FitSession.traced(self, fn, capture)
        record['n_mf'] = self.n_mf(record)
        return record, trace

    def describe(self, window):
        values = self.logged_n_mf(window['iter0'], window['iter1'])
        if not values:
            return ['mean-field sweeps a step in the window: none logged']
        tenths = np.array_split(np.asarray(values), min(10, len(values)))
        return ['mean-field sweeps a step in the window (fit\'s '
                'n_mf_updates): mean {0:.4f} over {1} logged steps; by '
                'tenths of the window: {2}'.format(
                    float(np.mean(values)), len(values), ' '.join(
                        '{0:.2f}'.format(float(np.mean(t)))
                        for t in tenths))]

    def traced_context(self, window):
        done, launches, work, lines = FitSession.traced_context(self, window)
        lines.append('mean-field sweeps a step in the traced slices: '
                     '{0}'.format([r['n_mf'] for r, _ in window['pieces']]))
        return done, launches, work, lines

    def late_steps(self):
        """As ``FitSession.late_steps``, with the train metrics logged at
        every step of these calls (a host-side cadence: the program
        computes every step's sweeps alike), so that each step's
        mean-field sweeps are read; the key of each step carries them as
        ``n_mf``."""
        every = self.model.train_metrics_every_iter
        self.model.train_metrics_every_iter = 1
        try:
            pre, steps = FitSession.late_steps(self)
        finally:
            self.model.train_metrics_every_iter = every
        for _, key in steps:
            logged = self.logged_n_mf(key['it'] - 1, key['it'])
            key['n_mf'] = logged[0] if logged else float('nan')
        return pre, steps

    def work_of_step(self, rows, window):
        """At the mean-field sweeps ``fit`` logged in the window (all
        ``max_mf_updates`` where it logged none)."""
        c = self.config
        V, (H1, H2) = c['n_visible'], c['n_hiddens']
        n_mf = window.get('n_mf')
        if n_mf is None:
            n_mf = c['max_mf_updates']
        return dbm_step_work(V, H1, H2, rows, c['n_particles'], n_mf,
                             c['n_gibbs_steps'])

    def inputs(self):
        M = self.config['n_particles']
        return {'config': self.config, 'batch_size': self.B,
                'rows': self.X[:3 * self.B], 'rbms': self.rbm_arrays,
                'v0': self.particles[0], 'H0': self.particles[1],
                'H1': self.particles[2], 'n_particles': M,
                'random_seed': self.model_seed,
                'learning_rate': self.schedule('learning_rate'),
                'momentum': self.schedule('momentum')}
