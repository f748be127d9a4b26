"""Concrete RBM flavours (reference rbm/rbm.py:10-123 equivalents)."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .base_rbm import BaseRBM
from ..layers import BernoulliLayer, GaussianLayer, MultinomialLayer


class BernoulliRBM(BaseRBM):
    """RBM with Bernoulli visible and hidden units."""

    def __init__(self, model_path='b_rbm_model/', *args, **kwargs):
        super(BernoulliRBM, self).__init__(v_layer_cls=BernoulliLayer,
                                           h_layer_cls=BernoulliLayer,
                                           model_path=model_path,
                                           *args, **kwargs)

    def _free_energy(self, state, v, generator=None):
        """F(v) = -v.vb - sum softplus(vW + hb), batch-mean
        (reference rbm.py:17-22)."""
        T1 = -(v @ state['vb'])
        T2 = -torch.sum(F.softplus(v @ state['W'] + state['hb']), dim=1)
        return torch.mean(T1 + T2, dim=0)


class MultinomialRBM(BaseRBM):
    """RBM with Bernoulli visible and one Multinomial hidden unit
    (= `n_samples` softmax units with tied weights).

    The free energy is the reference's Monte-Carlo estimate
    (rbm.py:50-60): hidden counts are drawn from a uniform multinomial on
    every call and contracted against -vW, with the log
    multinomial-coefficient correction -lgamma(M+K) + lgamma(M+1) +
    lgamma(K) added (the CD kernels' PLL omits it: it cancels there;
    ROADMAP.md Queue C6).
    """

    def __init__(self, n_samples=100, model_path='m_rbm_model/',
                 *args, **kwargs):
        self.n_samples = n_samples
        super(MultinomialRBM, self).__init__(
            v_layer_cls=BernoulliLayer,
            h_layer_cls=MultinomialLayer,
            h_layer_params=dict(n_samples=self.n_samples),
            model_path=model_path, *args, **kwargs)

    def _draw_h_hat(self, generator, like):
        """One (H,) count vector of the uniform Multinomial(M, 1/K)."""
        means = torch.full((1, self.n_hidden),
                           float(self.n_samples) / float(self.n_hidden),
                           dtype=like.dtype, device=like.device)
        return self._h_layer.sample(generator, means)[0]

    def _lgamma_constant(self):
        K, M = float(self.n_hidden), float(self.n_samples)
        return -math.lgamma(M + K) + math.lgamma(M + 1.) + math.lgamma(K)

    def _free_energy(self, state, v, generator=None):
        h_hat = self._draw_h_hat(generator, v)
        T1 = -(v @ state['vb'])
        T3 = -(v @ state['W']) @ h_hat
        return torch.mean(T1 + T3, dim=0) + self._lgamma_constant()

    def transform(self, *args, **kwargs):
        """Expected softmax probabilities: counts / n_samples
        (reference rbm.py:62-65)."""
        H = super(MultinomialRBM, self).transform(*args, **kwargs)
        H /= float(self.n_samples)
        return H


class GaussianRBM(BaseRBM):
    """RBM with Gaussian visible (fixed sigma) and Bernoulli hidden units.

    Following the reference (rbm.py:101-107), inputs are divided by sigma
    on ingestion -- the `_preprocess` hook applies to fit / transform /
    metrics alike, while vb stays raw (ROADMAP.md Queue C5) -- and the free
    energy is the quadratic form of rbm.py:109-116 in the divided space.
    """

    def __init__(self, learning_rate=1e-3, sigma=1.,
                 model_path='g_rbm_model/', *args, **kwargs):
        self.sigma = sigma
        super(GaussianRBM, self).__init__(
            v_layer_cls=GaussianLayer,
            v_layer_params=dict(sigma=self.sigma),
            h_layer_cls=BernoulliLayer,
            learning_rate=learning_rate,
            model_path=model_path, *args, **kwargs)
        if hasattr(self.sigma, '__iter__'):
            self._sigma_arr = np.asarray(self.sigma, dtype=self._np_dtype)
            self.sigma = np.asarray(self.sigma)
        else:
            self._sigma_arr = np.repeat(self.sigma, self.n_visible) \
                                .astype(self._np_dtype)

    def _preprocess(self, X):
        X = np.asarray(X, dtype=self._np_dtype)
        return X / self._sigma_arr[None, :]

    def _free_energy(self, state, v, generator=None):
        sigma = torch.as_tensor(self._sigma_arr, dtype=v.dtype,
                                device=v.device)
        T1 = state['vb'] / sigma
        T3 = 0.5 * torch.sum(torch.square(v - T1[None, :]), dim=1)
        T4 = -torch.sum(F.softplus(v @ state['W'] + state['hb']), dim=1)
        return torch.mean(T3 + T4, dim=0)


def logit_mean(X):
    """Per-feature logit of the data marginal -- the recommended visible-bias
    init (Hinton's practical guide; reference rbm.py:119-123)."""
    p = np.mean(np.asarray(X), axis=0)
    p = np.clip(p, 1e-7, 1. - 1e-7)
    return np.log(p / (1. - p))
