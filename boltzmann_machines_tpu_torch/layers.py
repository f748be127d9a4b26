"""Stochastic unit layers as {init, activation, sample} over explicit
``torch.Generator``s (reference layers.py:8-89 semantics).

Each layer object is a small config (unit count + distribution params); all
math is plain tensor code on whatever device the inputs live on.
"""

from collections import namedtuple

import numpy as np
import torch


class Block(namedtuple('Block', 'batch rows width cols')):
    """Where a rank's block of a tensor lies in the one-process tensor:
    rows `rows` (a slice, or None for all) of `batch`, columns `cols` (a
    slice, or None for all) of `width` -- the rows of a data-parallel rank,
    the hidden columns of a tensor-parallel one."""


def draw(fn, generator, shape, like, block=None):
    """`fn` (``torch.rand`` or ``torch.randn``) of `shape` from `generator`,
    in the dtype and on the device of `like`.  With a `block`, the
    one-process draw of its whole batch and width, of which the block's
    rows and columns are kept: ranks that hold blocks of one tensor then
    draw the one-process stream, each its own part of it."""
    full = list(shape)
    if block is not None:
        if block.rows is not None:
            full[0] = block.batch
        if block.cols is not None:
            full[-1] = block.width
    t = fn(tuple(full), generator=generator, dtype=like.dtype,
           device=like.device)
    if block is not None:
        if block.rows is not None:
            t = t[block.rows]
        if block.cols is not None:
            t = t[..., block.cols]
    return t


class BaseLayer(object):
    """One layer of stochastic units."""

    def __init__(self, n_units, dtype='float32'):
        self.n_units = n_units
        self.dtype = dtype

    def init(self, generator, batch_size, dtype=None, device='cpu'):
        """Randomly initialize states according to the layer's distribution."""
        raise NotImplementedError

    def activation(self, x, b):
        """Mean activation given total input `x` (excluding bias) and bias."""
        raise NotImplementedError

    def sample(self, generator, means, block=None):
        """Draw states from the conditional distribution with these means
        (a `block` of the one-process tensor: see ``draw``)."""
        raise NotImplementedError

    # serialization hooks so a DBM checkpoint can rebuild its layers
    def get_config(self):
        return {'class': self.__class__.__name__, 'n_units': int(self.n_units)}

    @staticmethod
    def from_config(cfg):
        cfg = dict(cfg)
        cls = {c.__name__: c for c in
               (BernoulliLayer, MultinomialLayer, GaussianLayer)}[cfg.pop('class')]
        return cls(**cfg)

    def _dtype(self, dtype):
        return getattr(torch, dtype or self.dtype)


class BernoulliLayer(BaseLayer):
    """Binary units: sigmoid activation, Bernoulli sampling
    (reference layers.py:39-51)."""

    def init(self, generator, batch_size, dtype=None, device='cpu'):
        return torch.rand((batch_size, self.n_units), generator=generator,
                          dtype=self._dtype(dtype), device=device)

    def activation(self, x, b):
        return torch.sigmoid(x + b)

    def sample(self, generator, means, block=None):
        u = draw(torch.rand, generator, means.shape, means, block)
        return (u < means).to(means.dtype)


class MultinomialLayer(BaseLayer):
    """Single multinomial unit = `n_samples` softmax units with tied weights
    (reference layers.py:54-70).

    `activation` returns expected counts ``n_samples * softmax(x + b)``;
    `sample` draws Multinomial(n_samples, p) per row by inverse-CDF bucket
    counting over a row cumsum, the last bucket absorbing rounding."""

    def __init__(self, n_units, n_samples=100, dtype='float32'):
        super(MultinomialLayer, self).__init__(n_units, dtype=dtype)
        self.n_samples = int(n_samples)

    def init(self, generator, batch_size, dtype=None, device='cpu'):
        t = torch.rand((batch_size, self.n_units), generator=generator,
                       dtype=self._dtype(dtype), device=device)
        return t / torch.sum(t)

    def activation(self, x, b):
        return float(self.n_samples) * torch.softmax(x + b, dim=-1)

    def sample(self, generator, means, block=None):
        """A row's draw spans all its units: `block` may split rows, not
        columns."""
        if block is not None and block.cols is not None:
            raise ValueError('a multinomial unit draws whole rows')
        probs = means / torch.sum(means, dim=-1, keepdim=True)
        cdf = torch.cumsum(probs, dim=-1)
        cdf[..., -1] = float('inf')
        u = draw(torch.rand, generator, means.shape[:-1] + (self.n_samples,),
                 means, block)
        pos = torch.sum(u[..., None, :] < cdf[..., :, None], dim=-1)
        counts = torch.diff(pos, dim=-1, prepend=torch.zeros_like(pos[..., :1]))
        return counts.to(means.dtype)

    def get_config(self):
        cfg = super(MultinomialLayer, self).get_config()
        cfg['n_samples'] = int(self.n_samples)
        return cfg


class GaussianLayer(BaseLayer):
    """Linear units with fixed standard deviation `sigma`
    (reference layers.py:73-89): mean = x * sigma + b, Normal sampling."""

    def __init__(self, n_units, sigma=1., dtype='float32'):
        super(GaussianLayer, self).__init__(n_units, dtype=dtype)
        self.sigma = np.asarray(sigma)

    def _sigma(self, like):
        return torch.as_tensor(self.sigma, dtype=like.dtype, device=like.device)

    def init(self, generator, batch_size, dtype=None, device='cpu'):
        t = torch.randn((batch_size, self.n_units), generator=generator,
                        dtype=self._dtype(dtype), device=device)
        return t * self._sigma(t)

    def activation(self, x, b):
        return x * self._sigma(x) + b

    def sample(self, generator, means, block=None):
        eps = draw(torch.randn, generator, means.shape, means, block)
        return means + eps * self._sigma(means)

    def get_config(self):
        cfg = super(GaussianLayer, self).get_config()
        cfg['sigma'] = np.asarray(self.sigma).tolist()
        return cfg
