"""The ``gaussian_rbm`` family: the port's ``GaussianRBM`` trained by CD-k
through ``fit``, as ``examples/torch_dbm_cifar_naive.py`` builds its first
stage (Gaussian visible units of a fixed sigma, ``dbm_first``), on rows of
the ``cifar_like`` kind this module defines.

Importing the module registers ``cifar_like`` in ``harness.data.DATA``,
so that the session's rows are made as every family's are."""

import math
import os

import numpy as np
import torch

from ..harness import data
from ..harness.data import gaussian, generator
from . import bernoulli_rbm

#: the port's launch counter of each kernel, and the kernel's name in a
#: trace (csrc/cd_epoch.cu): the CD epoch's kernels and the reduction of
#: the whole-set validation and free-energy passes (ops/cd_val.py)
KERNEL_OF_COUNTER = dict(bernoulli_rbm.KERNEL_OF_COUNTER,
                         cd_val_reduce='cd_val_reduce_kernel')


def cifar_like(n_rows, spec, seed, device):
    """(n_rows, side^2 channels) float32 rows with CIFAR-10's layout (pixel
    (y, x, c) at column ``(side y + x) channels + c``), smooth and of low
    rank: the F^2 cosine modes ``cos(pi p (y + 1/2) / side) cos(pi q (x +
    1/2) / side)`` (p, q < F = ``frequencies``), each with a colour (a
    weight per channel) drawn once, weighted in every row by a
    N(0, 1 / (1 + p + q)^2) draw, plus N(0, ``noise``^2) on every pixel.
    The rows are then standardised as ``examples/dbm_cifar_naive.py``
    does, ``(X - mean) / (std + 1e-8)``, with the mean and (biased) std of
    the first ``n_train`` rows, the training rows.  Every row differs."""
    side, channels = int(spec['side']), int(spec['channels'])
    F, noise = int(spec['frequencies']), float(spec['noise'])
    n_train = int(spec['n_train'])
    g = generator(seed, device)
    f32 = dict(dtype=torch.float32, device=device)
    pos = (torch.arange(side, **f32) + .5) / side
    freq = torch.arange(F, **f32)
    cos = torch.cos(math.pi * freq[:, None] * pos[None, :])     # (F, side)
    modes = (cos[:, None, :, None] * cos[None, :, None, :]).reshape(
        F * F, side * side)                                      # (p q, y x)
    colour = torch.randn((F * F, channels), generator=g, **f32)
    basis = (modes[:, :, None] * colour[:, None, :]).reshape(
        F * F, side * side * channels)
    scale = 1. / (1. + freq[:, None] + freq[None, :]).reshape(-1)
    weights = torch.randn((n_rows, F * F), generator=g, **f32) * scale
    X = torch.randn((n_rows, side * side * channels), generator=g, **f32)
    X.mul_(noise).addmm_(weights, basis)
    train = X[:n_train]
    mean = train.mean(dim=0)
    std = train.std(dim=0, unbiased=False)
    return X.sub_(mean).div_(std + 1e-8)


data.DATA['cifar_like'] = cifar_like


class Session(bernoulli_rbm.Session):
    def build(self, weight_seed):
        from boltzmann_machines_tpu_torch import GaussianRBM
        c = self.config
        V, H = c['n_visible'], c['n_hidden']
        self.W0 = gaussian((V, H), c['W_init'], weight_seed,
                           self.device).cpu().numpy()
        mc = c['metrics_config']
        self.period = int(np.lcm(mc['val_metrics_every_epoch'],
                                 mc['feg_every_epoch'] if mc['feg'] else 1))
        self.metrics_every = mc['train_metrics_every_iter']
        self.model = GaussianRBM(
            n_visible=V, n_hidden=H, sigma=c['sigma'], W_init=self.W0,
            vb_init=c['vb_init'], hb_init=c['hb_init'],
            n_gibbs_steps=c['n_gibbs_steps'],
            learning_rate=self.schedule('learning_rate'),
            momentum=self.schedule('momentum'), max_epoch=0,
            batch_size=self.B, l2=c['l2'],
            sample_v_states=c['sample_v_states'],
            sample_h_states=c['sample_h_states'], dropout=None,
            sparsity_target=c['sparsity_target'],
            sparsity_cost=c['sparsity_cost'],
            sparsity_damping=c['sparsity_damping'],
            dbm_first=c['dbm_first'], metrics_config=dict(mc),
            verbose=False, save_after_each_epoch=False, display_filters=0,
            display_hidden_activations=0, random_seed=self.model_seed,
            dtype='float32', device=self.device,
            model_path=os.path.join(self.workdir, 'grbm') + '/')
        # the state from W0 now; the checkpoint keeps the published scale
        # and not W0's 15.4 million numbers, which params.json would hold
        self.model.get_params_arrays()
        self.model.set_params(W_init=c['W_init'])
