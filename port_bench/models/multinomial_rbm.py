"""The ``multinomial_rbm`` family: the port's ``MultinomialRBM`` (Bernoulli
visible units, one multinomial hidden unit of ``n_samples`` tied softmax
units) trained by CD-k through ``fit``, as ``examples/torch_dbm_cifar.py``
builds its second stage, on rows of the ``grbm_features`` kind this module
defines: the hidden means of a Gaussian RBM layer over ``cifar_like`` rows
(``models/gaussian_rbm.py``, whose import registers that kind).

Importing the module registers ``grbm_features`` in ``harness.data.DATA``.
It needs a port that counts the CD kernels' softmax rows
(``cd_epoch.softmax_rows``), which the cell's per-layer metric reads, and
refuses to import where the port has none.

The judge follows the program's multinomial draws near a bucket's edge
(``reference/multinomial_rbm.py``): the session reads the counts of every
judged step from the program's own kernels, each chain pass of the step
replayed from the program's state before it (``ops/cd_epoch._gibbs_pass``,
the launches the epoch's step loop makes; a state that no snapshot holds,
after the set-up's middle step, by one more step of ``cd_epoch``)."""

import importlib
import math
import os

import numpy as np
import torch

from ..harness import data
from ..harness.data import gaussian, generator, sub_seed
from ..reference import common
from ..reference import gbm_dbm as gbm_reference
from ..work import cd_step_work
from ..work.cd_softmax import cd_softmax_work
from . import bernoulli_rbm, gaussian_rbm

_EPOCH = importlib.import_module('boltzmann_machines_tpu_torch.ops.cd_epoch')
_SAMPLERS = importlib.import_module('boltzmann_machines_tpu_torch.ops.samplers')
if not hasattr(_EPOCH.cd_epoch, 'softmax_rows'):
    raise ImportError('the multinomial_rbm family reads the port\'s softmax '
                      'row counts (cd_epoch.softmax_rows), which this port '
                      'does not keep')

#: the port's launch counter of each kernel, and the kernel's name in a
#: trace: the CD epoch's kernels and the whole-set passes' reduction
KERNEL_OF_COUNTER = dict(gaussian_rbm.KERNEL_OF_COUNTER)
#: rows a block of the features' product (bounds its temporaries)
FEATURE_ROWS = 8192


def grbm_features(n_rows, spec, seed, device):
    """(n_rows, ``n_features``) float32 rows in (0, 1): the hidden means
    ``sigmoid(X W + hb)`` of a Gaussian RBM layer over ``cifar_like`` rows
    X of the same spec (standardised over the first ``n_train`` rows), as
    ``examples/dbm_cifar.py`` hands its G-RBM's hidden means to the M-RBM.
    W is N(0, (``pre_std`` / sqrt(V))^2) from the seed, so that a unit's
    pre-activations spread by about ``pre_std``, and hb is the logit of
    ``sigmoid_hb``.  Every row differs."""
    X = gaussian_rbm.cifar_like(n_rows, spec, seed, device)
    V, F = X.shape[1], int(spec['n_features'])
    g = generator(sub_seed(seed, 1), device)
    W = torch.randn((V, F), generator=g, dtype=torch.float32,
                    device=device) * (float(spec['pre_std']) / math.sqrt(V))
    p = float(spec['sigmoid_hb'])
    hb = torch.full((F,), math.log(p / (1. - p)), dtype=torch.float32,
                    device=device)
    out = torch.empty((n_rows, F), dtype=torch.float32, device=device)
    for r in range(0, n_rows, FEATURE_ROWS):
        torch.sigmoid(torch.addmm(hb, X[r:r + FEATURE_ROWS], W),
                      out=out[r:r + FEATURE_ROWS])
    return out


data.DATA['grbm_features'] = grbm_features


#: the standalone samplers, which no step of the kernel path launches
SAMPLERS = ('bernoulli_sample', 'normal_sample', 'multinomial_sample')


def port_counts():
    """The port's C step loop counts (``loop``: calls, steps, Gibbs steps),
    softmax rows (``softmax_rows``: rows, draws) and standalone sampler
    launches (``samplers``)."""
    out = {key: dict(getattr(_EPOCH.cd_epoch, key))
           for key in ('loop', 'softmax_rows')}
    out['samplers'] = {name: getattr(_SAMPLERS, name).launches[name]
                       for name in SAMPLERS}
    return out


class Session(bernoulli_rbm.Session):
    def build(self, weight_seed):
        from boltzmann_machines_tpu_torch import MultinomialRBM
        c = self.config
        k = int(self.traffic.get('n_gibbs_steps', c['n_gibbs_steps']))
        if k != int(c['n_gibbs_steps']):
            raise ValueError('the traffic runs k = {0}, the configuration '
                             'k = {1}'.format(k, c['n_gibbs_steps']))
        V, H = c['n_visible'], c['n_hidden']
        self.W0 = gaussian((V, H), c['W_init'], weight_seed,
                           self.device).cpu().numpy()
        mc = c['metrics_config']
        self.period = int(np.lcm(mc['val_metrics_every_epoch'],
                                 mc['feg_every_epoch'] if mc['feg'] else 1))
        self.metrics_every = mc['train_metrics_every_iter']
        self.model = MultinomialRBM(
            n_visible=V, n_hidden=H, n_samples=c['n_samples'],
            W_init=self.W0, vb_init=c['vb_init'], hb_init=c['hb_init'],
            n_gibbs_steps=c['n_gibbs_steps'],
            learning_rate=self.schedule('learning_rate'),
            momentum=self.schedule('momentum'), max_epoch=0,
            batch_size=self.B, l2=c['l2'],
            sample_v_states=c['sample_v_states'],
            sample_h_states=c['sample_h_states'], dropout=None,
            sparsity_target=c['sparsity_target'],
            sparsity_cost=c['sparsity_cost'],
            sparsity_damping=c['sparsity_damping'],
            dbm_last=c['dbm_last'], metrics_config=dict(mc), verbose=False,
            save_after_each_epoch=False, display_filters=0,
            display_hidden_activations=0, random_seed=self.model_seed,
            dtype='float32', device=self.device,
            model_path=os.path.join(self.workdir, 'mrbm') + '/')
        # the state from W0 now; the checkpoint keeps the published scale
        # and not W0's 4 million numbers, which params.json would hold
        self.model.get_params_arrays()
        self.model.set_params(W_init=c['W_init'])

    def prepare(self):
        line = bernoulli_rbm.Session.prepare(self)
        return '{0}; mean feature {1:.6f}; the CD epoch kernels: {2}'.format(
            line, float(np.mean(self.X)), self.model._kernel_eligible())

    # ---- the port's counts over the window -------------------------------
    def run_epochs(self, epochs):
        """``FitSession.run_epochs``, the record holding the growth of the
        port's counts (``port_counts``) over the call."""
        before = port_counts()
        record = bernoulli_rbm.Session.run_epochs(self, epochs)
        for key, after in port_counts().items():
            record[key] = {k: v - before[key][k] for k, v in after.items()}
        return record

    def describe(self, window):
        """Where the window's steps ran: the C step loop's calls, steps and
        Gibbs steps a step, the softmax rows a step and the standalone
        samplers' launches, of the window (the traced slices of a traced
        one)."""
        records = [r for r, _ in window['pieces']] if 'pieces' in window \
            else [window]
        steps = sum(r['steps'] for r in records)
        loop, rows, samplers = ({k: sum(r[key][k] for r in records)
                                 for k in records[0][key]}
                                for key in ('loop', 'softmax_rows',
                                            'samplers'))
        return ['port: {0} steps in {1} C step loop calls ({2} steps), '
                '{3:.6f} Gibbs steps and {4:.6f} softmax rows ({5:.6f} '
                'draws) a step; standalone samplers {6}'.format(
                    steps, loop['calls'], loop['steps'],
                    loop['gibbs'] / steps, rows['rows'] / steps,
                    rows['draws'] / steps, samplers)]

    def step_work(self, record):
        """``FitSession.step_work`` and the softmax rows that the port
        counted over the record's call (``cd_softmax``): the epoch's and
        the whole-set passes'."""
        out = bernoulli_rbm.Session.step_work(self, record)
        rows = record.get('softmax_rows')
        if rows and rows['rows']:
            c = self.config
            out['cd_softmax'] = cd_softmax_work(
                c['n_hidden'], rows['rows'], rows['draws'], c['n_samples'])
        return out

    def work_of_step(self, rows, window):
        """The 1 + 2k products and the association of a step on `rows`
        rows: a hidden product writes the pre-activations alone (the
        softmax rows write the means and counts)."""
        c = self.config
        return cd_step_work(c['n_visible'], c['n_hidden'], rows,
                            c['n_gibbs_steps'], False, c['sample_v_states'])

    # ---- the program's counts of the judged steps ------------------------
    def first_steps(self):
        self.s0 = self.snapshot()
        return bernoulli_rbm.Session.first_steps(self)

    def _tensors(self, state):
        dev = self.device
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        return {'W': t(state['W']), 'vb': t(state['vb']),
                'hb': t(state['hb']), 'dW': t(state['dW']),
                'dvb': t(state['dvb']), 'dhb': t(state['dhb']),
                'q_means': t(state['q'])}

    def chain_counts(self, state, rows, seed, it):
        """{stream: counts} of the hidden draws that a step of `rows` from
        `state` feeds its chain (h0's, and each Gibbs step's but the
        last), as the program's kernels draw them."""
        from boltzmann_machines_tpu_torch.ops.philox import (
            STREAM_H0, stream_h, stream_v)
        cfg = self.model._cd_config(int(self.config['n_gibbs_steps']))
        s = self._tensors(state)
        X = torch.as_tensor(np.asarray(rows, np.float32), device=self.device)
        _, h = _EPOCH._gibbs_pass(cfg, 'h', X, s['W'], s['hb'], seed, it,
                                  STREAM_H0)
        out = {STREAM_H0: h.cpu().numpy()}
        for g in range(cfg.k - 1):
            vm, vs = _EPOCH._gibbs_pass(cfg, 'v', h, s['W'], s['vb'], seed,
                                        it, stream_v(g), cfg.sample_v_states)
            _, h = _EPOCH._gibbs_pass(cfg, 'h', vs if cfg.sample_v_states
                                      else vm, s['W'], s['hb'], seed, it,
                                      stream_h(g))
            out[stream_h(g)] = h.cpu().numpy()
        return out

    def replay_step(self, state, rows, lr, mom, seed, it):
        """The program's state after step `it` on `rows` from `state`: one
        step of the port's ``cd_epoch``, as ``fit`` runs it."""
        cfg = self.model._cd_config(int(self.config['n_gibbs_steps']))
        X = torch.as_tensor(np.asarray(rows, np.float32)[None],
                            device=self.device)
        new = _EPOCH.cd_epoch(cfg, self._tensors(state), X, lr, mom, seed,
                              it - 1)[0]
        return {k: new['q_means' if k == 'q' else k].cpu().numpy()
                for k in self.STATE}

    def program_counts(self):
        """{iteration: {stream: counts}} of every judged step: the set-up's
        steps and the late steps."""
        if not self.config['sample_h_states']:
            return {}
        B, out = self.B, {}
        keys = {'random_seed': self.model_seed,
                'learning_rate': self.schedule('learning_rate'),
                'momentum': self.schedule('momentum')}
        seeds = common.op_seeds(self.model_seed, 1 + len(common.FITS))
        state = self.s0
        for f, ((epoch, it0, n), snap) in enumerate(zip(common.FITS,
                                                        self.first)):
            seed = common.derive_seed(seeds[1 + f], epoch)
            lr = float(common.schedule_value(keys['learning_rate'], epoch))
            mom = float(common.schedule_value(keys['momentum'], epoch))
            for it in range(it0, it0 + n):
                rows = self.X[(it - 1) * B:it * B]
                out[it] = self.chain_counts(state, rows, seed, it)
                state = snap if it == it0 + n - 1 else \
                    self.replay_step(state, rows, lr, mom, seed, it)
        state = self.pre
        for post, key in self.late:
            _, _, seed = common.late_key(keys, key)
            out[key['it']] = self.chain_counts(state, key['rows'], seed,
                                               key['it'])
            state = post
        return out

    def inputs(self):
        """``bernoulli_rbm.Session.inputs``, the configuration carrying the
        program's counts of every judged step (``program_counts``), from
        which the judging reference takes the sides of its multinomial
        draws near an edge."""
        out = bernoulli_rbm.Session.inputs(self)
        out['config'] = dict(self.config,
                             program_counts=self.program_counts())
        return out

    def judge(self, reference, device):
        """``FitSession.judge``, with a line for each judged draw of counts
        that took draws from the program's counts (``reference.taken``)."""
        reference.taken.clear()
        with gbm_reference.recording():
            numbers, lines = bernoulli_rbm.Session.judge(self, reference,
                                                         device)
        for (it, stream), (moved, missed, worst) in sorted(
                reference.taken.items()):
            lines.append(
                'reference, step {0} stream {1}: {2} multinomial draws taken '
                'from the program\'s counts, {3} asked for outside their '
                'band; the farthest at {4:.3g} of what float32 rounding moves '
                'its edge (band {5:g})'.format(
                    it, stream, moved, missed, worst,
                    gbm_reference.SHOWN_FACTOR))
        return numbers, lines
