"""Concrete RBM flavours (reference rbm/rbm.py:10-123 equivalents).

The Bernoulli RBM is the ported slice; the Gaussian and multinomial RBMs
follow (ROADMAP.md Queue A4).
"""

import numpy as np
import torch
import torch.nn.functional as F

from .base_rbm import BaseRBM
from ..layers import BernoulliLayer


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


def logit_mean(X):
    """Per-feature logit of the data marginal -- the recommended visible-bias
    init (Hinton's practical guide; reference rbm.py:119-123)."""
    p = np.mean(np.asarray(X), axis=0)
    p = np.clip(p, 1e-7, 1. - 1e-7)
    return np.log(p / (1. - p))
